"""Shared layers: norms, activations, RoPE, embeddings, parameter init.

Parameters are plain nested dicts of tensors.  A :class:`Param` describes one
leaf (shape + init rule); :func:`init_tree` fills a tree of them from one
seeded ``torch.Generator`` on the requested device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name) -> torch.dtype:
    """Config dtype name (``cfg.dtype``) or torch dtype -> torch dtype."""
    return name if isinstance(name, torch.dtype) else DTYPES[name]


@dataclasses.dataclass(frozen=True)
class Param:
    """Declarative parameter: shape + init rule + init scale."""

    shape: tuple[int, ...]
    init: str = "normal"           # normal | zeros | ones
    scale: float = 1.0

    def initialize(self, gen: torch.Generator, dtype: torch.dtype,
                   device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        fan_in = self.shape[0] if len(self.shape) > 1 else max(self.shape[-1], 1)
        std = self.scale / math.sqrt(fan_in)
        x = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (x * std).to(dtype)


def init_tree(spec_tree: Any, gen: torch.Generator, dtype: torch.dtype,
              device) -> Any:
    """Initialize a tree (dicts and lists) of Params in traversal order."""
    if isinstance(spec_tree, Param):
        return spec_tree.initialize(gen, dtype, device)
    if isinstance(spec_tree, dict):
        return {k: init_tree(v, gen, dtype, device)
                for k, v in spec_tree.items()}
    return [init_tree(v, gen, dtype, device) for v in spec_tree]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_spec(d: int) -> Param:
    return Param((d,), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale.float()).to(dt)


def apply_norm(kind: str, x: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    return rmsnorm(x, scale) if kind == "rmsnorm" else layernorm(x, scale)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def act_fn(kind: str):
    # jax.nn.gelu defaults to the tanh approximation.
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[kind]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # theta filled on the device: an upload here would wait for the card
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=x.device), exps)
    ang = positions[..., None].float() * freqs               # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                        # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_spec(vocab: int, d: int) -> Param:
    return Param((vocab, d), scale=1.0)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor,
            softcap: float = 0.0) -> torch.Tensor:
    logits = x.float() @ table.float().T
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
