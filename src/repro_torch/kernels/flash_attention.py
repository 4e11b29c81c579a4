"""Flash attention: the sequence forward's attention kernel and the
training path's backward kernel.

:func:`flash_attention` takes q ``[B, Sq, H, hd]`` and k, v
``[B, Sk, kv, hd]`` in float32 or bfloat16 and returns ``[B, Sq, H, hd]``
with the contract of the reference's Pallas kernel: GQA (head h reads kv
head ``h // (H // kv)``), causal and sliding-window masks on absolute
positions (``q_offset`` is the position of q's first row), float32 softmax
state, ``acc / max(l, 1e-30)`` at the end, the output in q's dtype.  A CPU
tensor runs the plain version (:func:`repro_torch.models.flash.
attention_ref`); a CUDA tensor launches one of two kernels, chosen by the
dtype alone (:func:`variant`), or raises:

- bfloat16: ``csrc/flash_attention_wgmma.cu`` (``flash_fwd_wgmma``), wgmma
  on bf16 tiles staged by TMA, p rounded to bf16 before P·V;
- float32: ``csrc/flash_attention.cu`` (``flash_fwd_tf32x3``), mma.sync on
  TF32 tiles, each operand split into two TF32 halves and every product
  taken as hi·lo + lo·hi + hi·hi in float32, which holds the reference's
  float32 limit (2e-5) where one TF32 product would not.

With ``return_lse`` either kernel also writes the float32 log-sum-exp of
each row's scaled scores, ``[B, H, Sq]`` (-1e30 for a row that sees no
key), which the backward reads; without it the kernel writes nothing more
than before.  :func:`flash_attention_bwd` takes the forward's inputs, its
output and lse and the output's gradient and returns dq, dk and dv with
the reference's VJP arithmetic (``repro.models.flash._flash_bwd``): on a
CPU tensor the plain version (:func:`repro_torch.models.flash.
flash_bwd_ref`), on a CUDA tensor one of four kernels, chosen by the
dtype and the head dim alone (:func:`bwd_variant`), each three kernels with
no atomics, so two calls give the same bits:

- bfloat16 up to hd 128: ``csrc/flash_attention_bwd_wgmma.cu``
  (``flash_bwd_wgmma_delta``, ``_dkdv``, ``_dq``), wgmma on bf16 tiles
  staged by TMA, the rows tiled as :func:`bwd_tiles` says;
- bfloat16 from hd 136 to 256: ``csrc/flash_attention_bwd_wgmma256.cu``
  (``flash_bwd_wgmma256_delta``, ``_dkdv``, ``_dq``), the same rows and
  arithmetic, the dk/dv pass's head dim split between its two warpgroups;
- float32 up to hd 128: ``csrc/flash_attention_bwd_tf32.cu``
  (``flash_bwd_tf32x3_delta``, ``_dkdv``, ``_dq``), mma.sync on TF32
  tiles, every product taken as hi·lo + lo·hi + hi·hi as the float32
  forward takes it;
- float32 from hd 136 to 256: ``csrc/flash_attention_bwd_tf32_256.cu``
  (``flash_bwd_tf32x3_256_delta``, ``_dkdv``, ``_dq``), the same
  arithmetic, two warps sharing each 16 keys (rows) of a block: each sums
  half of S's 32-column chunks, the two add their partials through shared
  memory, and each takes the tile's product over its own half of the
  head dim.

The autograd function of :mod:`repro_torch.models.flash` ties the forward
and the backward together.

Each wrapper counts its launches in ``<wrapper>.launches`` (one a call)
and by kernel in ``<wrapper>.launches_by_kernel``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.models.flash import (NEG_INF, attention_lse_ref,
                                      attention_ref, flash_bwd_ref)

WGMMA = "flash_fwd_wgmma"          # the kernels' symbols, as profilers name them
TF32X3 = "flash_fwd_tf32x3"
BWD_WGMMA = "flash_bwd_wgmma"      # the backward: bf16 on the tensor cores
BWD_WGMMA256 = "flash_bwd_wgmma256"      # up to hd 128 and above, float32
BWD_TF32X3 = "flash_bwd_tf32x3"          # on the TF32 tensor cores up to hd
BWD_TF32X3_256 = "flash_bwd_tf32x3_256"  # 128 and above; their kernels:
BWD_KERNELS = {BWD_WGMMA: ("flash_bwd_wgmma_delta", "flash_bwd_wgmma_dkdv",
                           "flash_bwd_wgmma_dq"),
               BWD_WGMMA256: ("flash_bwd_wgmma256_delta",
                              "flash_bwd_wgmma256_dkdv",
                              "flash_bwd_wgmma256_dq"),
               BWD_TF32X3: ("flash_bwd_tf32x3_delta", "flash_bwd_tf32x3_dkdv",
                            "flash_bwd_tf32x3_dq"),
               BWD_TF32X3_256: ("flash_bwd_tf32x3_256_delta",
                                "flash_bwd_tf32x3_256_dkdv",
                                "flash_bwd_tf32x3_256_dq")}
_SOURCE = {WGMMA: "flash_attention_wgmma", TF32X3: "flash_attention",
           BWD_WGMMA: "flash_attention_bwd_wgmma",
           BWD_WGMMA256: "flash_attention_bwd_wgmma256",
           BWD_TF32X3: "flash_attention_bwd_tf32",
           BWD_TF32X3_256: "flash_attention_bwd_tf32_256"}
# kernel -> its C function and packed arguments.  Forward: 4 pointers, the
# sizes, hd_pad and key tile, masks, scale, stream, the lse pointer (0: not
# written) (csrc/flash_attention*.cu).  Backward, float32: 10 pointers,
# the sizes, hd_pad, a dtype, always 0 (float32), masks, scale, stream
# (csrc/flash_attention_bwd_tf32.cu and
# csrc/flash_attention_bwd_tf32_256.cu); the bf16 ones 10 pointers (the delta
# scratch holds the row tiles' statistics), the sizes, hd_pad, the row
# tiling, masks, scale, stream (csrc/flash_attention_bwd_wgmma.cu and
# csrc/flash_attention_bwd_wgmma256.cu).
_ENTRY = {WGMMA: ("repro_flash_attention_wgmma", "15qdqq"),
          TF32X3: ("repro_flash_attention_tf32x3", "15qdqq"),
          BWD_WGMMA: ("repro_flash_attention_bwd_wgmma", "22qdq"),
          BWD_WGMMA256: ("repro_flash_attention_bwd_wgmma256", "22qdq"),
          BWD_TF32X3: ("repro_flash_attention_bwd_tf32", "21qdq"),
          BWD_TF32X3_256: ("repro_flash_attention_bwd_tf32_256", "21qdq")}
_bound = {}               # kernel -> its C function, bound at its first launch


def _bind(kernel: str):
    fn = _bound.get(kernel)
    if fn is None:
        fn = _bound[kernel] = _build.bind(_SOURCE[kernel], *_ENTRY[kernel])
    return fn


@dataclasses.dataclass(frozen=True)
class Variant:
    """Which kernel takes a call, and its tiles."""
    kernel: str      # WGMMA or TF32X3 (variant); BWD_WGMMA, BWD_WGMMA256,
                     # BWD_TF32X3 or BWD_TF32X3_256 (bwd_variant)
    hd_pad: int      # head dim as the kernel's shared-memory tiles hold it
    key_tile: int    # keys a tile (the backward's tensor-core kernels: a
                     # dk/dv block)


def variant(dtype: torch.dtype, hd: int) -> Variant:
    """The kernel for q, k, v of ``dtype`` with head dim ``hd``.

    bfloat16 takes the wgmma kernel, hd padded with zeros to a
    multiple of 64 (a 128-byte swizzled row), 128 keys a tile up to hd 128
    and 64 beyond (the output alone then takes 96 or 128 registers a
    thread); float32 takes the three-term TF32 kernel, hd padded with zeros
    to a multiple of 64, 32 keys a tile up to hd 192 and 16 beyond (its
    shared memory holds each K and V tile three times).  Nothing else
    decides, and neither gives way to the other.
    """
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"flash_attention: head_dim {hd} must be a multiple "
                         f"of 8 up to 256")
    hd_pad = -(-hd // 64) * 64
    if dtype == torch.bfloat16:
        return Variant(WGMMA, hd_pad, 128 if hd_pad <= 128 else 64)
    if dtype == torch.float32:
        return Variant(TF32X3, hd_pad, 32 if hd_pad <= 192 else 16)
    raise ValueError(f"flash_attention: q, k and v must share float32 or "
                     f"bfloat16, got {dtype}")


def bwd_variant(dtype: torch.dtype, hd: int) -> Variant:
    """The backward kernel for q, k, v of ``dtype`` with head dim ``hd``.

    The table, which nothing else decides and where neither kernel gives
    way to the other:

    ========  ========  ===================================================
    dtype     hd        kernel
    ========  ========  ===================================================
    bfloat16  8 - 128   ``BWD_WGMMA``: hd padded with zeros to 64 or 128,
                        128 keys a dk/dv block
    bfloat16  136 - 256 ``BWD_WGMMA256``: hd padded with zeros to 192 or
                        256, 64 keys a dk/dv block, its head dim split
                        between two warpgroups (dk and dv of 64 keys over
                        the whole head dim would take 192 - 256 float32
                        registers a thread)
    float32   8 - 128   ``BWD_TF32X3``: hd padded with zeros to 64 or 128,
                        128 keys a dk/dv block
    float32   136 - 256 ``BWD_TF32X3_256``: hd padded with zeros to 192 or
                        256, 64 keys a dk/dv block, two warps on each 16
                        keys splitting the head dim (dk and dv of 16 keys
                        over the whole head dim would take 192 - 256
                        float32 registers a thread)
    ========  ========  ===================================================
    """
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"flash_attention_bwd: head_dim {hd} must be a "
                         f"multiple of 8 up to 256")
    hd_pad = -(-hd // 64) * 64
    if dtype == torch.bfloat16:
        if hd_pad <= 128:
            return Variant(BWD_WGMMA, hd_pad, 128)
        return Variant(BWD_WGMMA256, hd_pad, 64)
    if dtype == torch.float32:
        if hd_pad <= 128:
            return Variant(BWD_TF32X3, hd_pad, 128)
        return Variant(BWD_TF32X3_256, hd_pad, 64)
    raise ValueError(f"flash_attention_bwd: q, k and v must share float32 "
                     f"or bfloat16, got {dtype}")


@dataclasses.dataclass(frozen=True)
class BwdTiles:
    """How ``BWD_WGMMA`` and ``BWD_WGMMA256`` tile a kv head's query rows:
    its g = H / kv heads at every position, flattened position-major (row =
    position * hb + head), 64 rows a tile: ``hb`` heads (the largest
    divisor of g up to 64) at ``pos_per`` = 64 // hb positions, ``tiles``
    position tiles over Sq and ``nhc`` = g // hb head blocks.  Rows past
    ``pos_per * hb`` of a tile are padding."""
    hb: int
    pos_per: int
    tiles: int
    nhc: int

    def stats_numel(self, b: int, kv: int) -> int:
        """float32 elements of the row statistics (lse log2e, delta), a
        pair for each of the 64 rows of every tile."""
        return b * kv * self.nhc * self.tiles * 64 * 2


def bwd_tiles(h: int, kv: int, sq: int) -> BwdTiles:
    g = h // kv
    hb = max(d for d in range(1, min(g, 64) + 1) if g % d == 0)
    pos_per = 64 // hb
    return BwdTiles(hb, pos_per, -(-sq // pos_per), g // hb)


def _check_shapes(what: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{what}: q must be [B, Sq, H, hd] and k, v "
                         f"[B, Sk, kv, hd]")
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (b, sk, kv, hd) or tuple(v.shape) != tuple(k.shape)
            or kv < 1 or h % kv):
        raise ValueError(f"{what}: q {list(q.shape)}, k {list(k.shape)}, v "
                         f"{list(v.shape)} do not match [B, Sq, H, hd] / "
                         f"[B, Sk, kv, hd] with kv dividing H")
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"{what}: head_dim {hd} must be a multiple of 8 up "
                         f"to 256")


def _check_dtypes(what: str, *xs: torch.Tensor) -> None:
    if any(x.dtype != xs[0].dtype for x in xs):
        raise ValueError(f"{what}: q, k and v must share float32 or "
                         f"bfloat16 (o and do too), got "
                         f"{[x.dtype for x in xs]}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    return_lse: bool = False):
    """q: [B, Sq, H, hd]; k, v: [B, Sk, kv, hd] -> [B, Sq, H, hd], or
    ``(out, lse)`` with ``return_lse`` (lse float32 ``[B, H, Sq]``).

    ``hd`` is a multiple of 8 up to 256.  Any Sq and Sk: the kernels mask
    the ragged edge themselves.  The reference's ``bq``, ``bk`` and
    ``interpret`` choose the TPU's tiling and interpreter and change no
    result; they do not exist here.  This wrapper is the forward alone:
    while autograd records and an input requires grad it raises, and the
    caller that wants gradients takes :func:`repro_torch.models.flash.
    flash_attention`, the autograd function over this forward and
    :func:`flash_attention_bwd`.  Replaces ``repro.kernels.flash_attention.
    flash_attention``.
    """
    what = "flash_attention"
    _check_shapes(what, q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(f"{what}: the forward alone; for the backward "
                           f"call repro_torch.models.flash.flash_attention")
    if _build.on_cpu(what, q, k, v):
        if return_lse:
            return attention_lse_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    _check_dtypes(what, q, k, v)
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    plan = variant(q.dtype, hd)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse.fill_(NEG_INF)) if return_lse else out
    fn = _bind(plan.kernel)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, h, kv, hd)
    masks = (int(bool(causal)), int(window), int(q_offset), hd ** -0.5,
             _build.stream_of(q), 0 if lse is None else lse.data_ptr())
    _build.check(fn(*args, plan.hd_pad, plan.key_tile, *masks), what)
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[plan.kernel] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.launches_by_kernel = {WGMMA: 0, TF32X3: 0}


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """The backward of :func:`flash_attention`: (dq, dk, dv) in the inputs'
    dtype, from q, k, v, the forward's output ``o`` and ``lse``
    (``flash_attention(..., return_lse=True)``) and ``do``, the gradient of
    ``o``, with the same masks.  Float32 or bfloat16, hd a multiple of 8 up
    to 256.  The counterpart of the reference's custom VJP
    (``repro.models.flash._flash_bwd``), which the TPU runs in XLA ops.
    """
    what = "flash_attention_bwd"
    _check_shapes(what, q, k, v)
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if (tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape)
            or tuple(lse.shape) != (b, h, sq)):
        raise ValueError(f"{what}: o {list(o.shape)} and do "
                         f"{list(do.shape)} must be q's shape, lse "
                         f"{list(lse.shape)} [B, H, Sq]")
    if _build.on_cpu(what, q, k, v, o, do, lse):
        return flash_bwd_ref(q, k, v, o, do, lse, causal=causal,
                             window=window, q_offset=q_offset)
    _check_dtypes(what, q, k, v, o, do)
    if lse.dtype != torch.float32:
        raise ValueError(f"{what}: lse must be float32, got {lse.dtype}")
    plan = bwd_variant(q.dtype, hd)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if dq.numel() == 0 and dk.numel() == 0:
        return dq, dk, dv
    masks = (int(bool(causal)), int(window), int(q_offset), hd ** -0.5,
             _build.stream_of(q))
    fn = _bind(plan.kernel)
    if plan.kernel in (BWD_WGMMA, BWD_WGMMA256):
        rows = bwd_tiles(h, kv, sq)
        delta = torch.empty(rows.stats_numel(b, kv), dtype=torch.float32,
                            device=q.device)
        sizes = (b, sq, sk, h, kv, hd, plan.hd_pad, rows.hb, rows.tiles)
    else:
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        sizes = (b, sq, sk, h, kv, hd, plan.hd_pad, 0)   # dtype 0: float32
    ptrs = (q, k, v, o, do, lse, delta, dq, dk, dv)
    _build.check(fn(*(x.data_ptr() for x in ptrs), *sizes, *masks), what)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_kernel[plan.kernel] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_kernel = {BWD_WGMMA: 0, BWD_WGMMA256: 0,
                                          BWD_TF32X3: 0, BWD_TF32X3_256: 0}
