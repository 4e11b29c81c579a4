"""Flash attention (forward): the sequence forward's attention kernel.

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

The wrapper counts every launch in ``flash_attention.launches`` and each
kernel's in ``flash_attention.launches_by_kernel``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.models.flash import attention_ref

WGMMA = "flash_fwd_wgmma"          # the kernels' symbols, as profilers name them
TF32X3 = "flash_fwd_tf32x3"
_SOURCE = {WGMMA: "flash_attention_wgmma", TF32X3: "flash_attention"}
# kernel -> its C function and packed arguments: 4 pointers, the sizes,
# hd_pad and key tile, masks, scale, stream (csrc/flash_attention*.cu)
_ENTRY = {WGMMA: ("repro_flash_attention_wgmma", "15qdq"),
          TF32X3: ("repro_flash_attention_tf32x3", "15qdq")}
_bound = {}               # kernel -> its C function, bound at its first launch


@dataclasses.dataclass(frozen=True)
class Variant:
    """Which kernel takes a call, and its tiles."""
    kernel: str      # WGMMA or TF32X3
    hd_pad: int      # head dim as the kernel's shared-memory tiles hold it
    key_tile: int    # keys a tile


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Sk, kv, hd] -> [B, Sq, H, hd].

    ``hd`` is a multiple of 8 up to 256.  Any Sq and Sk: the kernels mask
    the ragged edge themselves.  The reference's ``bq``, ``bk`` and
    ``interpret`` choose the TPU's tiling and interpreter and change no
    result; they do not exist here.  Forward only: while autograd records
    and an input requires grad this raises (the backward comes with the
    training slice).  Replaces ``repro.kernels.flash_attention.
    flash_attention``.
    """
    what = "flash_attention"
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
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(f"{what}: forward only; the backward comes with "
                           f"the training slice of the port")
    if _build.on_cpu(what, q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k and v must share float32 or bfloat16,"
                         f" got {q.dtype}, {k.dtype}, {v.dtype}")
    plan = variant(q.dtype, hd)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _bound.get(plan.kernel)
    if fn is None:
        fn = _bound[plan.kernel] = _build.bind(_SOURCE[plan.kernel],
                                               *_ENTRY[plan.kernel])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, h, kv, hd)
    masks = (int(bool(causal)), int(window), int(q_offset), hd ** -0.5,
             _build.stream_of(q))
    _build.check(fn(*args, plan.hd_pad, plan.key_tile, *masks), what)
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[plan.kernel] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_kernel = {WGMMA: 0, TF32X3: 0}
