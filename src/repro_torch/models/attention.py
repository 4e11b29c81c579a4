"""GQA attention blocks: projections + RoPE, sequence attention through the
flash kernel, output projection; the sequence (prefill / scoring) and the
decode-step halves."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig, SWA_ATTN
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import flash, layers
from repro_torch.models.layers import Param


def attn_specs(cfg: ModelConfig) -> dict[str, Param]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": Param((d, h * hd)),
        "wk": Param((d, kv * hd)),
        "wv": Param((d, kv * hd)),
        "wo": Param((h * hd, d)),
    }


def qkv(cfg: ModelConfig, p: dict[str, torch.Tensor], x: torch.Tensor,
        positions: Optional[torch.Tensor] = None, use_rope: bool = True):
    """x: [B, S, d] -> q [B,S,H,hd], k,v [B,S,kv,hd] (RoPE applied at
    ``positions`` [B or 1, S], by default ``0 .. S-1``)."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kvh, hd)
    v = (x @ p["wv"]).reshape(b, s, kvh, hd)
    if use_rope:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attend_train(cfg: ModelConfig, kind: str, q: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True) -> torch.Tensor:
    """Sequence attention by layer kind (full/global, or sliding-window with
    ``cfg.window_size``) through the flash kernel; the tensors' device picks
    the kernel or its plain version.  When an input requires grad (and
    autograd records) it goes through the autograd function
    :func:`repro_torch.models.flash.flash_attention`, whose backward is
    the flash backward kernel; otherwise straight to the forward kernel.

    The reference's ``impl`` and ``chunk`` choose between two
    implementations of this one function (its Pallas kernel and its chunked
    XLA flash); the port has the one kernel, so neither exists here.
    """
    window = cfg.window_size if kind == SWA_ATTN else 0
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return flash.flash_attention(q, k, v, causal, window)
    return flash_attention(q, k, v, causal=causal, window=window)


def project_out(cfg: ModelConfig, p: dict[str, torch.Tensor],
                attn_out: torch.Tensor) -> torch.Tensor:
    b, s = attn_out.shape[:2]
    flat = attn_out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    return flat @ p["wo"]


# -- decode ------------------------------------------------------------------

def qkv_step(cfg: ModelConfig, p: dict[str, torch.Tensor], x: torch.Tensor,
             position: torch.Tensor, use_rope: bool = True):
    """x: [B, d], position: [B] -> q [B,H,hd], k,v [B,kv,hd]."""
    b = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, 1, h, hd)
    k = (x @ p["wk"]).reshape(b, 1, kvh, hd)
    v = (x @ p["wv"]).reshape(b, 1, kvh, hd)
    if use_rope:
        q = layers.rope(q, position[:, None], cfg.rope_theta)
        k = layers.rope(k, position[:, None], cfg.rope_theta)
    return q[:, 0], k[:, 0], v[:, 0]


def project_out_step(cfg: ModelConfig, p: dict[str, torch.Tensor],
                     attn_out: torch.Tensor) -> torch.Tensor:
    flat = attn_out.reshape(attn_out.shape[0], cfg.num_heads * cfg.head_dim)
    return flat @ p["wo"]
