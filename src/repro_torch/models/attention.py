"""GQA attention, decode-step half: projections + RoPE, output projection."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import Param


def attn_specs(cfg: ModelConfig) -> dict[str, Param]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": Param((d, h * hd)),
        "wk": Param((d, kv * hd)),
        "wv": Param((d, kv * hd)),
        "wo": Param((h * hd, d)),
    }


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
