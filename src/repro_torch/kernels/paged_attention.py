"""Paged decode attention over KV pages in the pool.

:func:`paged_attention` takes q ``[B, H, hd]``, pools ``[slots, T, kv, hd]``,
the page table i32 ``[B, max_pages]`` (pool slot of each page, -1
unmapped) and lengths i32 ``[B]``, and returns ``[B, H, hd]``: each
sequence's one new token attends over the tokens of its fully flushed
pages, below ``(length // T) * T``.  A ``-1`` entry reads slot 0 and a slot
past the pool reads the last slot, as the reference's kernel and oracle
do.  A CPU tensor runs the plain version; a CUDA tensor launches
``csrc/paged_attention.cu`` (or raises; the kernel takes 16-byte aligned
operands and a head of a multiple of 16 bytes): a kernel that folds each
split of ``SPLIT_PAGES`` pages into a float32 partial in one scratch
buffer, then one that merges a sequence's partials in split order.  The
wrapper counts a call, its two kernels, as one launch in
``paged_attention.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.core.kvbridge import decode_attention_ref
from repro_torch.kernels import _build

# dtype, 7 pointers, 8 sizes, scale, stream (csrc/paged_attention.cu),
# packed
_FIELDS = "16qdq"
SPLIT_PAGES = 8           # pages one block of the split kernel folds
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_paged_c = None           # the kernel's C function, bound at its first launch


def record_floats(g: int, hd: int) -> int:
    """Floats of one split's partial (acc [g, hd], m [g], l [g]), 16-byte
    aligned (``csrc/decode_fold.cuh``, record_floats)."""
    return g * hd + -(-2 * g // 4) * 4


def paged_attention_plain(q, k_pool, v_pool, page_table, lengths, *,
                          max_pages: int):
    """Plain version: gather every page dense, then masked GQA decode
    attention over the flushed tokens only."""
    b, h, hd = q.shape
    slots, t, kv, _ = k_pool.shape
    safe = torch.where(page_table >= 0, page_table, 0).clamp(max=slots - 1)
    k = k_pool[safe.long()].reshape(b, max_pages * t, kv, hd)
    v = v_pool[safe.long()].reshape(b, max_pages * t, kv, hd)
    return decode_attention_ref(q, k, v, (lengths // t) * t)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, *, max_pages: int) -> torch.Tensor:
    """Decode attention over pooled pages: q [B, H, hd] -> [B, H, hd].

    The reference's ``interpret`` chooses the TPU interpreter and changes
    no result; it does not exist here.  Replaces
    ``repro.kernels.paged_attention.paged_attention``.
    """
    what = "paged_attention"
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"{what}: q must be [B, H, hd] and the pools "
                         f"[slots, T, kv, hd]")
    b, h, hd = q.shape
    slots, t, kv, hd_k = k_pool.shape
    if (hd_k != hd or tuple(v_pool.shape) != tuple(k_pool.shape) or kv < 1
            or h % kv or slots < 1
            or tuple(page_table.shape) != (b, max_pages)
            or tuple(lengths.shape) != (b,)):
        raise ValueError(f"{what}: q {list(q.shape)}, pools "
                         f"{list(k_pool.shape)}, table "
                         f"{list(page_table.shape)}, lengths "
                         f"{list(lengths.shape)} do not match [B, H, hd], "
                         f"[slots, T, kv, hd], [B, max_pages={max_pages}], "
                         f"[B]")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{what}: page_table and lengths must be int32")
    if _build.on_cpu(what, q, k_pool, v_pool, ids=(page_table, lengths)):
        return paged_attention_plain(q, k_pool, v_pool, page_table, lengths,
                                     max_pages=max_pages)
    if (q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype
            or v_pool.dtype != q.dtype):
        raise ValueError(f"{what}: q and the pools must share float32 or "
                         f"bfloat16, got {q.dtype}, {k_pool.dtype}, "
                         f"{v_pool.dtype}")
    if hd * q.element_size() % 16:
        raise ValueError(f"{what}: head_dim x the element size must be a "
                         f"multiple of 16 bytes, got head_dim {hd}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    parts = torch.empty(b * kv * -(-max_pages // SPLIT_PAGES)
                        * record_floats(h // kv, hd), dtype=torch.float32,
                        device=q.device)
    global _paged_c
    if _paged_c is None:
        _paged_c = _build.bind("paged_attention", "repro_paged_attention",
                               _FIELDS)
    _build.check(_paged_c(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        parts.data_ptr(), out.data_ptr(), b, h, kv, slots, t, hd, max_pages,
        SPLIT_PAGES, hd ** -0.5, _build.stream_of(q)), what)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
