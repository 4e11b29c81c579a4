"""The bridge datapath's page kernels: gather, the N-node commits, scatter.

A page moves as one row of bytes (pages move as whole flits; their inner
layout is irrelevant to the datapath).  Each function picks its path by
its operands' device: CPU tensors run the plain PyTorch version beside it
on pages flattened to one trailing dim, CUDA tensors launch the
hand-written kernel of ``csrc/bridge_gather.cu`` (or raise).  Each wrapper
counts its kernel launches in ``<fn>.launches``.

The CUDA branch does the least host work that still checks what the kernel
does not take: one pass of attribute compares (``_build.on_cpu``), the row
size from ``numel()``, the C function bound once at module level, the raw
current stream, and no new tensor views.  Apart from gather's and
pull_commit's outputs it allocates nothing, and it never synchronises, so
a launch can be recorded in a CUDA graph.

:func:`gather_pages` and :func:`scatter_pages` serve the one-device
loopback path and the gather side of the N-node engine; :func:`pull_commit`
and :func:`push_commit` retire the N-node engine's rounds, with the N memory
nodes as an axis of one device (the pool node-major, ``[N * ppn]`` rows).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.memport import FREE
from repro_torch.kernels import _build

_SOURCE = "bridge_gather"
# The C entry points' arguments, packed (``_build.bind``; the order is in
# csrc/bridge_gather.cu): pointers and integers, the stream last.
_FIELDS = {"repro_gather_pages": "7q", "repro_scatter_pages": "7q",
           "repro_pull_commit": "10q", "repro_push_commit": "12q"}
# The kernels' C functions, bound at their first launch.
_gather_c = _pull_c = _push_c = _scatter_c = None


def _flatten_pages(pool: torch.Tensor):
    """[slots, *page_shape] -> ([slots, E] view, page_shape)."""
    page_shape = tuple(pool.shape[1:])
    return pool.view(pool.shape[0], math.prod(page_shape)), page_shape


def _rows(pool: torch.Tensor) -> tuple[int, int]:
    """The page rows of ``pool`` and the bytes of one."""
    rows = pool.shape[0]
    return rows, (pool.nbytes // rows if rows else 0)


def _check_vectors(what: str, row_bytes: int) -> None:
    """The kernels move rows as 16-byte vectors."""
    if row_bytes % 16:
        raise ValueError(f"{what}: page rows must be 16-byte multiples "
                         f"(row of {row_bytes} bytes)")


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
    lanes; an id past the pool is clamped to the last row.  Replaces
    ``repro.kernels.bridge_gather.gather_pages``.
    """
    if _build.on_cpu("gather_pages", pool, ids=(reqs,)):
        pool2, page_shape = _flatten_pages(pool)
        return gather_pages_plain(pool2, reqs.reshape(-1)).view(
            tuple(reqs.shape) + page_shape)
    out = pool.new_empty(reqs.shape + pool.shape[1:])
    w = reqs.numel()
    if w == 0:
        return out
    rows = pool.shape[0]
    row_bytes = pool.nbytes // rows if rows else 0
    if row_bytes % 16:
        _check_vectors("gather_pages", row_bytes)
    global _gather_c
    if _gather_c is None:
        _gather_c = _build.bind(_SOURCE, "repro_gather_pages",
                                _FIELDS["repro_gather_pages"])
    _build.check(_gather_c(pool.data_ptr(), reqs.data_ptr(), out.data_ptr(),
                           rows, w, row_bytes,
                           _build.stream_of(pool)), "gather_pages")
    gather_pages.launches += 1
    return out


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
    n, lanes = choice.shape
    if (send.shape != (n, n, lanes) + pool.shape[1:]
            or send.dtype != pool.dtype or loop_slot.shape != (n, lanes)
            or pool.shape[0] % max(n, 1)):
        raise ValueError(
            f"pull_commit: pool {list(pool.shape)}, send {list(send.shape)}, "
            f"choice {list(choice.shape)} and loop_slot "
            f"{list(loop_slot.shape)} do not match [N*ppn, *page], "
            f"[N, N, L, *page], [N, L], [N, L]")
    if _build.on_cpu("pull_commit", pool, send, ids=(choice, loop_slot)):
        pool2, page_shape = _flatten_pages(pool)
        send2 = send.reshape(n, n, lanes, pool2.shape[1])
        out = pull_commit_plain(pool2, send2, choice, loop_slot)
        return out.view((n, lanes) + page_shape)
    out = torch.empty((n, lanes) + pool.shape[1:], dtype=pool.dtype,
                      device=pool.device)
    if n == 0 or lanes == 0:
        return out
    rows, row_bytes = _rows(pool)
    _check_vectors("pull_commit", row_bytes)
    global _pull_c
    if _pull_c is None:
        _pull_c = _build.bind(_SOURCE, "repro_pull_commit",
                              _FIELDS["repro_pull_commit"])
    _build.check(_pull_c(pool.data_ptr(), send.data_ptr(), choice.data_ptr(),
                         loop_slot.data_ptr(), out.data_ptr(), rows // n, n,
                         lanes, row_bytes,
                         _build.stream_of(pool)), "pull_commit")
    pull_commit.launches += 1
    return out


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
    requester's payloads, of the pool's dtype and row size; base: i32[N]
    each requester's window start, so a lane's page is ``data[j, base[j] +
    lane]`` (zeros past D), read where it lies.  L = channels * cb; within
    one home the writes commit in the grid order (channel, slot row, lane)
    and the later write wins.  Replaces
    ``repro.kernels.bridge_gather.push_commit`` run on every home at once.
    """
    n, s1, lanes = slots.shape
    rows, row_bytes = _rows(pool)
    dshape = data.shape
    if (lanes != channels * cb or s1 > n or base.shape != (n,)
            or len(dshape) < 2 or dshape[0] != n or data.dtype != pool.dtype
            or data.nbytes != n * dshape[1] * row_bytes or rows % max(n, 1)):
        raise ValueError(
            f"push_commit: pool {list(pool.shape)}, slots {list(slots.shape)},"
            f" data {data.dtype}{list(data.shape)}, base {list(base.shape)} "
            f"and channels*cb = {channels}*{cb} do not match [N*ppn, *page], "
            f"[N, s1<=N, L=channels*cb], [N, D, *page] of the pool's dtype, "
            f"[N]")
    if n == 0 or lanes == 0:
        return pool
    if _build.on_cpu("push_commit", pool, data, ids=(slots, base)):
        pool2, _ = _flatten_pages(pool)
        data2 = data.reshape(n, dshape[1], pool2.shape[1])
        push_commit_plain(pool2, slots, data2, base, channels, cb)
        return pool
    _check_vectors("push_commit", row_bytes)
    global _push_c
    if _push_c is None:
        _push_c = _build.bind(_SOURCE, "repro_push_commit",
                              _FIELDS["repro_push_commit"])
    _build.check(_push_c(pool.data_ptr(), slots.data_ptr(), data.data_ptr(),
                         base.data_ptr(), rows // n, n, s1, lanes, cb,
                         dshape[1], row_bytes,
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
    data: [W, *page_shape] of the pool's dtype and row size.  Live
    duplicates resolve last-write-wins.  Where the reference donates the
    pool buffer, the port updates ``pool`` in place and returns it.  Replaces
    ``repro.kernels.bridge_gather.scatter_pages``.
    """
    w = slots.shape[0]
    rows, row_bytes = _rows(pool)
    if (slots.dim() != 1 or data.dtype != pool.dtype or data.shape[0] != w
            or data.nbytes != w * row_bytes):
        raise ValueError(f"scatter_pages: slots {list(slots.shape)} and data "
                         f"{data.dtype}{list(data.shape)} do not match [W] "
                         f"and W pages of {pool.dtype}{list(pool.shape[1:])}")
    if w == 0:
        return pool
    if _build.on_cpu("scatter_pages", pool, data, ids=(slots,)):
        pool2, _ = _flatten_pages(pool)
        scatter_pages_plain(pool2, slots, data.reshape(w, pool2.shape[1]))
        return pool
    _check_vectors("scatter_pages", row_bytes)
    global _scatter_c
    if _scatter_c is None:
        _scatter_c = _build.bind(_SOURCE, "repro_scatter_pages",
                                 _FIELDS["repro_scatter_pages"])
    _build.check(_scatter_c(pool.data_ptr(), slots.data_ptr(),
                            data.data_ptr(), rows, w, row_bytes,
                            _build.stream_of(pool)), "scatter_pages")
    scatter_pages.launches += 1
    return pool


scatter_pages.launches = 0
