"""Sequence attention for training: the mask, the plain versions of the
flash kernels and the autograd function over them.

Ports ``_mask``, ``attention_ref`` and ``flash_attention`` (the chunked
attention with its custom VJP) of ``repro.models.flash``.  The forward runs
the hand-written kernel of :mod:`repro_torch.kernels.flash_attention`,
whose plain version is :func:`attention_ref` (with the log-sum-exp:
:func:`attention_lse_ref`); :func:`flash_attention` is a
``torch.autograd.Function`` whose backward is the hand-written backward
kernel of the same module, whose plain version is :func:`flash_bwd_ref`,
the reference's ``_flash_bwd`` arithmetic.  A CPU tensor takes the plain
versions, a CUDA tensor the kernels (or raises).

Supports GQA (kv_heads <= heads), causal and sliding-window masks on
absolute positions, and bidirectional attention.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    """[Sq, Sk] boolean visibility mask."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Sk, kv, hd] -> [B, Sq, H, hd].

    Scores in float32; masked scores are ``NEG_INF`` and masked
    probabilities 0 after the softmax, so a fully masked query row gives
    zeros.  The output takes q's dtype.
    """
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = s * hd ** -0.5
    mask = _mask(torch.arange(sq, device=q.device) + q_offset,
                 torch.arange(k.shape[1], device=q.device), causal, window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, 0.0)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
            q_offset: int):
    """float32 scaled scores [B, kv, G, Sq, Sk], NEG_INF where masked, and
    the [Sq, Sk] mask."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * hd ** -0.5
    mask = _mask(torch.arange(sq, device=q.device) + q_offset,
                 torch.arange(k.shape[1], device=q.device), causal, window)
    return torch.where(mask, s, NEG_INF), mask


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0,
                      q_offset: int = 0):
    """:func:`attention_ref` and the float32 log-sum-exp of each row's
    scaled scores, ``[B, H, Sq]``: the forward's residual for the backward,
    as the reference's ``_flash_fwd_inner`` returns it (``m + log l``; a row
    that sees no key gets -1e30)."""
    b, sq, h, _ = q.shape
    s, _ = _scores(q, k, causal, window, q_offset)
    lse = torch.logsumexp(s, dim=-1).reshape(b, h, sq)
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset), lse


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0):
    """Plain version of the flash backward kernel: (dq, dk, dv) in the
    inputs' dtypes, with the reference's ``_flash_bwd`` arithmetic.

    ``delta = sum(o do)`` in float32; ``p = exp(s - lse)``, 0 where masked;
    ``p`` rounded to v's dtype before ``dv = p^T do`` and ``do`` to v's
    before ``dp = do v^T``; ``ds = p (dp - delta) scale`` rounded to k's
    dtype before ``dq = ds k`` and ``dk = ds^T q``; every product
    accumulates in float32, and GQA's dk and dv sum over the group.  The
    reference walks key chunks; the plain version takes all keys at once,
    which changes only the order of float32 sums.
    """
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = hd ** -0.5

    def rounded(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return x.to(like.dtype).float()

    s, mask = _scores(q, k, causal, window, q_offset)
    og = o.reshape(b, sq, kv, g, hd).float()
    dog = do.reshape(b, sq, kv, g, hd).float()
    delta = (og * dog).sum(-1).permute(0, 2, 3, 1)             # [B,kv,G,Sq]
    lse_g = lse.reshape(b, kv, g, sq)
    p = torch.where(mask, torch.exp(s - lse_g[..., None]), 0.0)
    do_v = rounded(dog, v)
    dv = torch.einsum("bkgqs,bqkgd->bskd", rounded(p, v), do_v)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do_v, v.float())
    ds = rounded(p * (dp - delta[..., None]) * scale, k)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      rounded(q.reshape(b, sq, kv, g, hd), k))
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward kernel (which also
    writes the log-sum-exp) saves q, k, v, its output and lse, the backward
    kernel reads them; both are the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        from repro_torch.kernels import flash_attention as kernel
        o, lse = kernel.flash_attention(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.masks = dict(causal=causal, window=window, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels import flash_attention as kernel
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = kernel.flash_attention_bwd(q, k, v, o, do.contiguous(),
                                                lse, **ctx.masks)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Sk, kv, hd] -> [B, Sq, H, hd], with
    gradients to q, k and v.

    The reference's ``chunk`` is the TPU's key-chunk length and changes no
    result (only the order of float32 sums); the kernels tile on their own,
    so it does not exist here.  ``q_offset`` is the absolute position of
    q's first row.
    """
    return FlashAttention.apply(q, k, v, causal, window, q_offset)
