"""Page gather and page scatter of the loopback bridge datapath.

Each function flattens a page to one trailing dim (pages move as whole
flits; their inner layout is irrelevant to the datapath) and picks its path
by the pool's device: a CPU tensor runs the plain PyTorch version beside it,
a CUDA tensor launches the hand-written kernel of ``csrc/bridge_gather.cu``
(or raises).  Each wrapper counts its kernel launches in ``<fn>.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_SIGNATURES = {
    "repro_gather_pages": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_void_p],
    "repro_scatter_pages": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_void_p],
}


def _flatten_pages(pool: torch.Tensor):
    """[slots, *page_shape] -> ([slots, E] view, page_shape)."""
    page_shape = tuple(pool.shape[1:])
    return pool.view(pool.shape[0], math.prod(page_shape)), page_shape


def _check_rows(what: str, pool2: torch.Tensor, ids: torch.Tensor,
                *others: torch.Tensor) -> int:
    """Validate the kernel's operands; returns the row size in bytes."""
    if pool2.device.type != "cuda":
        raise ValueError(f"{what}: pool on {pool2.device}; the kernel takes "
                         f"CUDA tensors and the plain version CPU tensors")
    if pool2.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: pool on {pool2.device}, current device "
                         f"is cuda:{torch.cuda.current_device()}")
    for t in (ids, *others):
        if t.device != pool2.device:
            raise ValueError(f"{what}: operands on {t.device} and "
                             f"{pool2.device}")
    for t in (pool2, ids, *others):
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(f"{what}: row ids must be i32[W], got "
                         f"{ids.dtype}{list(ids.shape)}")
    row_bytes = pool2.shape[1] * pool2.element_size()
    if row_bytes % 16 or pool2.data_ptr() % 16:
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
        row_bytes = _check_rows("gather_pages", pool2, flat)
        out = torch.empty((flat.shape[0], pool2.shape[1]), dtype=pool.dtype,
                          device=pool.device)
        lib = _build.load("bridge_gather", _SIGNATURES)
        _build.check(lib.repro_gather_pages(
            pool2.data_ptr(), flat.data_ptr(), out.data_ptr(), pool2.shape[0],
            flat.shape[0], row_bytes, _build.stream_of(pool)), "gather_pages")
        gather_pages.launches += 1
    return out.view(tuple(reqs.shape) + page_shape)


gather_pages.launches = 0


# ---------------------------------------------------------------------------
# Push side (pool updated in place)
# ---------------------------------------------------------------------------

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
    row_bytes = _check_rows("scatter_pages", pool2, slots, data2)
    if data2.data_ptr() % 16:
        raise ValueError("scatter_pages: data must be 16-byte aligned")
    lib = _build.load("bridge_gather", _SIGNATURES)
    _build.check(lib.repro_scatter_pages(
        pool2.data_ptr(), slots.data_ptr(), data2.data_ptr(), pool2.shape[0],
        w, row_bytes, _build.stream_of(pool)), "scatter_pages")
    scatter_pages.launches += 1
    return pool


scatter_pages.launches = 0
