"""The bridge datapath's page kernels: gather, the N-node commits, scatter.

Each function flattens a page to one trailing dim (pages move as whole
flits; their inner layout is irrelevant to the datapath) and picks its path
by the pool's device: a CPU tensor runs the plain PyTorch version beside it,
a CUDA tensor launches the hand-written kernel of ``csrc/bridge_gather.cu``
(or raises).  Each wrapper counts its kernel launches in ``<fn>.launches``.

:func:`gather_pages` and :func:`scatter_pages` serve the one-device
loopback path and the gather side of the N-node engine; :func:`pull_commit`
and :func:`push_commit` retire the N-node engine's rounds, with the N memory
nodes as an axis of one device (the pool node-major, ``[N * ppn]`` rows).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.memport import FREE
from repro_torch.kernels import _build

_SIGNATURES = {
    "repro_gather_pages": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_void_p],
    "repro_scatter_pages": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_void_p],
    "repro_pull_commit": [ctypes.c_void_p] * 5
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
       ctypes.c_void_p],
    "repro_push_commit": [ctypes.c_void_p] * 4
    + [ctypes.c_longlong] + [ctypes.c_int] * 4
    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p],
}


def _flatten_pages(pool: torch.Tensor):
    """[slots, *page_shape] -> ([slots, E] view, page_shape)."""
    page_shape = tuple(pool.shape[1:])
    return pool.view(pool.shape[0], math.prod(page_shape)), page_shape


def _check_rows(what: str, pool2: torch.Tensor, ids=(), pages=()) -> int:
    """Validate a kernel's operands: the flattened pool, its int32 ``ids``
    and its other ``pages`` operands.  Returns the row size in bytes."""
    operands = (*ids, *pages)
    if pool2.device.type != "cuda":
        raise ValueError(f"{what}: pool on {pool2.device}; the kernel takes "
                         f"CUDA tensors and the plain version CPU tensors")
    if pool2.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: pool on {pool2.device}, current device "
                         f"is cuda:{torch.cuda.current_device()}")
    for t in operands:
        if t.device != pool2.device:
            raise ValueError(f"{what}: operands on {t.device} and "
                             f"{pool2.device}")
    for t in (pool2, *operands):
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if any(t.dtype != torch.int32 for t in ids):
        raise ValueError(f"{what}: row ids must be int32, got "
                         f"{[t.dtype for t in ids]}")
    row_bytes = pool2.shape[1] * pool2.element_size()
    if row_bytes % 16 or any(t.data_ptr() % 16 for t in (pool2, *pages)):
        raise ValueError(f"{what}: page rows must be 16-byte multiples on "
                         f"16-byte boundaries (row of {row_bytes} bytes)")
    return row_bytes


# ---------------------------------------------------------------------------
# Pull side
# ---------------------------------------------------------------------------

def gather_pages_plain(pool2: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Plain version: ``pool2[flat]`` per lane; FREE lanes give zeros and
    an id past the pool reads the last row (clamped, as the reference's
    fetch is).  pool2: [rows, E]; flat: i32[W] -> [W, E]."""
    page = pool2[flat.clamp(0, pool2.shape[0] - 1).long()]
    return page.masked_fill((flat < 0)[:, None], 0)


def gather_pages(pool: torch.Tensor, reqs: torch.Tensor) -> torch.Tensor:
    """Serve an epoch's landed requests in one kernel.

    pool: [slots, *page_shape]; reqs: i32[...] pool rows (FREE < 0).
    Returns reqs.shape + page_shape: ``pool[req]`` per lane, zeros for FREE
    lanes; an id past the pool is clamped to the last row.  Replaces ``repro.kernels.bridge_gather.gather_pages``.
    """
    pool2, page_shape = _flatten_pages(pool)
    flat = reqs.reshape(-1)
    if pool.device.type == "cpu":
        out = gather_pages_plain(pool2, flat)
    elif flat.shape[0] == 0:
        out = pool2.new_empty((0, pool2.shape[1]))
    else:
        row_bytes = _check_rows("gather_pages", pool2, ids=(flat,))
        out = torch.empty((flat.shape[0], pool2.shape[1]), dtype=pool.dtype,
                          device=pool.device)
        lib = _build.load("bridge_gather", _SIGNATURES)
        _build.check(lib.repro_gather_pages(
            pool2.data_ptr(), flat.data_ptr(), out.data_ptr(), pool2.shape[0],
            flat.shape[0], row_bytes, _build.stream_of(pool)), "gather_pages")
        gather_pages.launches += 1
    return out.view(tuple(reqs.shape) + page_shape)


gather_pages.launches = 0


def pull_commit_plain(pool2: torch.Tensor, send2: torch.Tensor,
                      choice: torch.Tensor,
                      loop_slot: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`pull_commit` on flattened pages: the
    reference's three masked fetches (``_pull_commit_lax``), batched over the
    node axis.  pool2 [N*ppn, E], send2 [N, N, L, E] -> [N, L, E]."""
    n, lanes = choice.shape
    ppn = pool2.shape[0] // n
    node = torch.arange(n, device=choice.device)[:, None]
    lane = torch.arange(lanes, device=choice.device)[None, :]
    loop_rows = torch.where(loop_slot >= 0,
                            node * ppn + loop_slot.clamp(max=ppn - 1), FREE)
    local = gather_pages_plain(pool2, loop_rows.reshape(-1)).view(
        n, lanes, pool2.shape[1])
    sel = (choice - 1).clamp(0, n - 1).long()
    circ = send2[sel, node, lane]
    page = torch.where((choice >= 1)[..., None], circ, local)
    return page.masked_fill((choice < 0)[..., None], 0)


def pull_commit(pool: torch.Tensor, send: torch.Tensor, choice: torch.Tensor,
                loop_slot: torch.Tensor) -> torch.Tensor:
    """Retire one pull round of the N-node engine for every requester.

    pool: [N * ppn, *page_shape], node-major; send: [N, N, L, *page_shape]
    the a2a send buffer, ``send[h, j, lane]`` the page home h served for
    requester j's lane (read in place: no all-to-all copy); choice: i32[N, L]
    per-lane source, ``-1`` dead (zeros), ``0`` loopback
    (``pool[j * ppn + loop_slot]``), ``h + 1`` home h's payload; loop_slot:
    i32[N, L] slot in requester j's own pool (FREE elsewhere; a slot past
    the node's pool reads its last row, as the reference's shard-local
    fetch does).  Returns [N, L, *page_shape].  Replaces
    ``repro.kernels.bridge_gather.pull_commit`` run on every node at once.
    """
    pool2, page_shape = _flatten_pages(pool)
    n, lanes = choice.shape
    e = pool2.shape[1]
    if (tuple(send.shape) != (n, n, lanes) + page_shape
            or send.dtype != pool.dtype
            or tuple(loop_slot.shape) != (n, lanes)
            or pool2.shape[0] % max(n, 1)):
        raise ValueError(
            f"pull_commit: pool {list(pool.shape)}, send {list(send.shape)}, "
            f"choice {list(choice.shape)} and loop_slot "
            f"{list(loop_slot.shape)} do not match [N*ppn, *page], "
            f"[N, N, L, *page], [N, L], [N, L]")
    send2 = send.reshape(n, n, lanes, e)
    if pool.device.type == "cpu":
        out = pull_commit_plain(pool2, send2, choice, loop_slot)
    else:
        row_bytes = _check_rows("pull_commit", pool2, ids=(choice, loop_slot),
                                pages=(send2,))
        out = torch.empty((n, lanes, e), dtype=pool.dtype, device=pool.device)
        lib = _build.load("bridge_gather", _SIGNATURES)
        _build.check(lib.repro_pull_commit(
            pool2.data_ptr(), send2.data_ptr(), choice.data_ptr(),
            loop_slot.data_ptr(), out.data_ptr(), pool2.shape[0] // n, n,
            lanes, row_bytes, _build.stream_of(pool)), "pull_commit")
        pull_commit.launches += 1
    return out.view((n, lanes) + page_shape)


pull_commit.launches = 0


# ---------------------------------------------------------------------------
# Push side (pool updated in place)
# ---------------------------------------------------------------------------

def push_commit_plain(pool2: torch.Tensor, slots: torch.Tensor,
                      data2: torch.Tensor, base: torch.Tensor, channels: int,
                      cb: int) -> torch.Tensor:
    """Plain version of :func:`push_commit` on flattened pages, in place:
    the reference's ``_push_commit_lax`` and ``_shadow_to`` (writes shadowed
    by a later grid step of their home drop), batched over the homes.
    pool2 [N*ppn, E]; slots i32[N, s1, L]; data2 [N, D, E]; base i32[N]."""
    n, s1, lanes = slots.shape
    ppn = pool2.shape[0] // n
    dev = slots.device
    # grid step t = (c*s1 + k)*cb + b  ->  slot row k, lane c*cb + b
    t = torch.arange(channels * s1 * cb, device=dev)
    k_t = (t // cb) % s1
    lane_t = (t // (s1 * cb)) * cb + t % cb
    rows = slots[:, k_t, lane_t]                                  # [N, T]
    shadowed = ((rows[:, None, :] == rows[:, :, None])
                & (t[None, None, :] > t[None, :, None])).any(-1)
    keep = (rows >= 0) & (rows < ppn) & ~shadowed
    home = torch.arange(n, device=dev)[:, None]
    req = torch.remainder(home - k_t[None, :], n)
    d = data2.shape[1]
    di = base.long()[req] + lane_t[None, :]
    padded = torch.cat([data2, data2.new_zeros((n, 1, data2.shape[2]))], 1)
    src = padded[req, torch.where(di < d, di, d)]
    pool2[(home * ppn + rows)[keep].long()] = src[keep]
    return pool2


def push_commit(pool: torch.Tensor, slots: torch.Tensor, data: torch.Tensor,
                base: torch.Tensor, *, channels: int, cb: int) -> torch.Tensor:
    """Retire one push round of the N-node engine into the pool, in place.

    pool: [N * ppn, *page_shape], node-major (the reference donates the
    buffer; the port updates it and returns it); slots: i32[N, s1, L] per
    home h the commit slots in h's pool, row 0 the loopback writes and row
    k the writes landed from requester ``(h - k) mod N`` (FREE, or a slot
    past the node's pool, drops); data: [N, D, *page_shape] each
    requester's payloads, of the pool's dtype; base: i32[N] each
    requester's window start, so a lane's page is ``data[j, base[j] +
    lane]`` (zeros past D), read where it lies.  L = channels * cb; within
    one home the writes commit in the grid order (channel, slot row, lane)
    and the later write wins.  Replaces
    ``repro.kernels.bridge_gather.push_commit`` run on every home at once.
    """
    pool2, page_shape = _flatten_pages(pool)
    n, s1, lanes = slots.shape
    if (lanes != channels * cb or s1 > n or base.shape != (n,)
            or data.dim() < 2 or tuple(data.shape[:1]) != (n,)
            or tuple(data.shape[2:]) != page_shape
            or data.dtype != pool.dtype or pool2.shape[0] % max(n, 1)):
        raise ValueError(
            f"push_commit: pool {list(pool.shape)}, slots {list(slots.shape)},"
            f" data {data.dtype}{list(data.shape)}, base {list(base.shape)} "
            f"and channels*cb = {channels}*{cb} do not match [N*ppn, *page], "
            f"[N, s1<=N, L=channels*cb], [N, D, *page] of the pool's dtype, "
            f"[N]")
    if n == 0 or lanes == 0:
        return pool
    data2 = data.reshape(n, data.shape[1], pool2.shape[1])
    if pool.device.type == "cpu":
        push_commit_plain(pool2, slots, data2, base, channels, cb)
        return pool
    row_bytes = _check_rows("push_commit", pool2, ids=(slots, base),
                            pages=(data2,))
    lib = _build.load("bridge_gather", _SIGNATURES)
    _build.check(lib.repro_push_commit(
        pool2.data_ptr(), slots.data_ptr(), data2.data_ptr(), base.data_ptr(),
        pool2.shape[0] // n, n, s1, lanes, cb, data2.shape[1], row_bytes,
        _build.stream_of(pool)), "push_commit")
    push_commit.launches += 1
    return pool


push_commit.launches = 0

def scatter_pages_plain(pool2: torch.Tensor, slots: torch.Tensor,
                        data2: torch.Tensor) -> torch.Tensor:
    """Plain version: ``pool2.at[slots].set(data2, mode="drop")`` in place.

    FREE and out-of-pool lanes drop; a lane shadowed by a later lane with
    the same slot drops too, so the last write wins.
    """
    rows, w = pool2.shape[0], slots.shape[0]
    t = torch.arange(w, device=slots.device)
    shadowed = ((slots[None, :] == slots[:, None])
                & (t[None, :] > t[:, None])).any(1)
    keep = (slots >= 0) & (slots < rows) & ~shadowed
    pool2[slots[keep].long()] = data2[keep]
    return pool2


def scatter_pages(pool: torch.Tensor, slots: torch.Tensor,
                  data: torch.Tensor) -> torch.Tensor:
    """One-kernel masked scatter: ``pool.at[slots].set(data, mode="drop")``.

    pool: [slots, *page_shape]; slots: i32[W] (FREE < 0 drops);
    data: [W, *page_shape] of the pool's dtype.  Live duplicates resolve
    last-write-wins.  Where the reference donates the pool buffer, the port
    updates ``pool`` in place and returns it.  Replaces
    ``repro.kernels.bridge_gather.scatter_pages``.
    """
    pool2, page_shape = _flatten_pages(pool)
    w = slots.shape[0]
    if data.dtype != pool.dtype or tuple(data.shape) != (w,) + page_shape:
        raise ValueError(f"scatter_pages: data {data.dtype}{list(data.shape)}"
                         f" does not match {w} pages of {pool.dtype}"
                         f"{list(page_shape)}")
    if w == 0:
        return pool
    data2 = data.reshape(w, pool2.shape[1])
    if pool.device.type == "cpu":
        scatter_pages_plain(pool2, slots, data2)
        return pool
    row_bytes = _check_rows("scatter_pages", pool2, ids=(slots,),
                            pages=(data2,))
    lib = _build.load("bridge_gather", _SIGNATURES)
    _build.check(lib.repro_scatter_pages(
        pool2.data_ptr(), slots.data_ptr(), data2.data_ptr(), pool2.shape[0],
        w, row_bytes, _build.stream_of(pool)), "scatter_pages")
    scatter_pages.launches += 1
    return pool


scatter_pages.launches = 0
