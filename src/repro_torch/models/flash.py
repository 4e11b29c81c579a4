"""Dense sequence attention: the mask and the oracle of the flash kernel.

Ports ``_mask`` and ``attention_ref`` of ``repro.models.flash``.  The
reference's chunked ``flash_attention`` with its custom VJP is the training
path; it comes with the training slice of the port, as a
``torch.autograd.Function``.  The forward (prefill / scoring) runs the
hand-written kernel of :mod:`repro_torch.kernels.flash_attention`, whose
plain version is :func:`attention_ref`.

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
