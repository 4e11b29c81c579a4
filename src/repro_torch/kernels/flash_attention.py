"""Flash attention (forward): the sequence forward's attention kernel.

:func:`flash_attention` takes q ``[B, Sq, H, hd]`` and k, v
``[B, Sk, kv, hd]`` in float32 or bfloat16 and returns ``[B, Sq, H, hd]``
with the contract of the reference's Pallas kernel: GQA (head h reads kv
head ``h // (H // kv)``), causal and sliding-window masks on absolute
positions (``q_offset`` is the position of q's first row), float32 softmax
state, ``acc / max(l, 1e-30)`` at the end, the output in q's dtype.  A CPU
tensor runs the plain version (:func:`repro_torch.models.flash.
attention_ref`); a CUDA tensor launches ``csrc/flash_attention.cu`` (or
raises).  The wrapper counts its launches in ``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.models.flash import attention_ref

_SIGNATURES = {
    "repro_flash_attention":
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_void_p],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Sk, kv, hd] -> [B, Sq, H, hd].

    ``hd`` is a multiple of 8 up to 256.  Any Sq and Sk: the kernel masks
    the ragged edge itself.  The reference's ``bq``, ``bk`` and
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
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k and v must share float32 or bfloat16,"
                         f" got {q.dtype}, {k.dtype}, {v.dtype}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention", _SIGNATURES)
    _build.check(lib.repro_flash_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, sq, sk, h, kv, hd, int(bool(causal)), int(window),
        int(q_offset), hd ** -0.5, _build.stream_of(q)), what)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
