"""Model assembly, dense models: parameters, the sequence forward (prefill /
scoring), decode state and one decode step.

The port's parameters are a plain dict whose ``layers`` entry is a Python
list with one dict per layer (the reference stacks layers for
``jax.lax.scan``; :func:`repro_torch.weights.from_reference` unstacks them).
Every weight keeps the reference's ``[in, out]`` layout, so ``x @ w``
computes the reference's ``einsum("bd,de->be")``.

Only attention layers with a dense FFN run here; MoE, cross-attention,
the encoder and the recurrent blocks come with a later slice of the port.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import checkpoint as _checkpoint

from repro_torch.config import ATTENTION_KINDS, ModelConfig, SWA_ATTN
from repro_torch.core.kvbridge import (decode_attention_ref,
                                       masked_decode_attention)
from repro_torch.models import attention, layers
from repro_torch.models.layers import Param


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.is_moe or cfg.cross_attention or cfg.num_encoder_layers
            or any(k not in ATTENTION_KINDS for k in cfg.layers)):
        raise NotImplementedError(
            f"{cfg.name}: MoE, cross-attention, encoder and recurrent blocks "
            f"come with a later slice of the port (dense attention only)")


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def ffn_specs(cfg: ModelConfig) -> dict[str, Param]:
    d, ff = cfg.d_model, cfg.d_ff
    spec = {"wi": Param((d, ff)), "wo": Param((ff, d))}
    if cfg.glu:
        spec["wg"] = Param((d, ff))
    return spec


def block_specs(cfg: ModelConfig, kind: str) -> dict[str, Any]:
    if kind not in ATTENTION_KINDS:
        raise NotImplementedError(f"{kind} blocks come with a later slice")
    spec: dict[str, Any] = {"norm1": layers.norm_spec(cfg.d_model),
                            "attn": attention.attn_specs(cfg),
                            "norm2": layers.norm_spec(cfg.d_model)}
    if cfg.d_ff > 0:
        spec["ffn"] = ffn_specs(cfg)
    return spec


def model_specs(cfg: ModelConfig) -> dict[str, Any]:
    _check_supported(cfg)
    spec: dict[str, Any] = {
        "embed": layers.embed_spec(cfg.padded_vocab, cfg.d_model),
        "out_norm": layers.norm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = Param((cfg.padded_vocab, cfg.d_model))
    spec["layers"] = [block_specs(cfg, kind) for kind in cfg.layers]
    return spec


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device="cuda") -> dict[str, Any]:
    """Random weights from ``gen`` (a generator on ``device``), std
    ``scale / sqrt(fan_in)`` as in the reference; norms start at one."""
    return layers.init_tree(model_specs(cfg), gen,
                            layers.torch_dtype(cfg.dtype), device)


# ---------------------------------------------------------------------------
# Sequence forward (prefill / scoring)
# ---------------------------------------------------------------------------

def apply_ffn(cfg: ModelConfig, bp: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense or GLU FFN with its pre-norm and residual; x: [..., d]."""
    if cfg.d_ff <= 0:
        return x
    h = layers.apply_norm(cfg.norm, x, bp["norm2"])
    act = layers.act_fn(cfg.act)
    up = h @ bp["ffn"]["wi"]
    if cfg.glu:
        up = act(h @ bp["ffn"]["wg"]) * up
    else:
        up = act(up)
    return x + up @ bp["ffn"]["wo"]


def apply_block(cfg: ModelConfig, kind: str, bp: dict, x: torch.Tensor, *,
                causal: bool = True) -> torch.Tensor:
    """One attention block over a sequence; x: [B, S, d]."""
    h = layers.apply_norm(cfg.norm, x, bp["norm1"])
    q, k, v = attention.qkv(cfg, bp["attn"], h)
    att = attention.attend_train(cfg, kind, q, k, v, causal=causal)
    x = x + attention.project_out(cfg, bp["attn"], att)
    return apply_ffn(cfg, bp, x)


def _embed_inputs(cfg: ModelConfig, params: Any, batch: dict) -> torch.Tensor:
    if batch.get("embeds") is not None:
        return batch["embeds"].to(layers.torch_dtype(cfg.dtype))
    x = layers.embed(batch["tokens"], params["embed"])
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)


def _logits(cfg: ModelConfig, params: Any, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the float32 unembedding, sliced to the vocabulary."""
    x = layers.apply_norm(cfg.norm, x, params["out_norm"])
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = layers.unembed(x, head, cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    return logits


def forward(cfg: ModelConfig, params: Any, batch: dict,
            remat: str = "block") -> tuple[torch.Tensor, dict]:
    """Sequence forward: batch ``{"tokens": i32[B, S]}`` (or ``"embeds"``
    [B, S, d]) -> (logits f32[B, S, V], aux metrics).

    Every attention layer runs the flash kernel (causal, windowed on
    sliding-window layers).  ``remat`` is the reference's activation
    checkpointing: with anything but ``"none"``, while autograd records,
    each layer runs under ``torch.utils.checkpoint`` (non-reentrant), so
    the backward recomputes a layer's activations from its input, as the
    reference's ``jax.checkpoint`` of its scanned period body does (a
    period of one layer for the dense configs; the port loops over
    ``params["layers"]`` and checkpoints layer by layer, which gives the
    same gradients).  Without grad it changes nothing.  The reference's
    ``attn_impl`` picks its Pallas kernel or its chunked XLA flash; the port
    has one kernel, so the argument does not exist here.  ``aux`` stays
    empty: only MoE layers fill it.
    """
    _check_supported(cfg)
    x = _embed_inputs(cfg, params, batch)
    remat_on = remat != "none" and torch.is_grad_enabled()
    for kind, bp in zip(cfg.layers, params["layers"]):
        if remat_on:
            x = _checkpoint.checkpoint(apply_block, cfg, kind, bp, x,
                                       use_reentrant=False)
        else:
            x = apply_block(cfg, kind, bp, x)
    return _logits(cfg, params, x), {}


def loss_fn(cfg: ModelConfig, params: Any, batch: dict,
            remat: str = "block") -> tuple[torch.Tensor, dict]:
    """Masked mean next-token NLL over ``labels >= 0`` -> (loss, {"loss",
    "tokens"}), the reference's ``loss_fn`` (float32 log-softmax of the
    float32 logits; ``tokens`` the int32 count of labelled positions, at
    least 1)."""
    logits, _ = forward(cfg, params, batch, remat)
    labels = batch["labels"]
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    denom = torch.clamp(valid.sum(dtype=torch.int32), min=1)
    loss = torch.sum(nll * valid) / denom
    return loss, {"loss": loss, "tokens": denom}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, cache_ops) -> dict:
    """Whole-model decode state: lengths, one cache state per layer (a
    Python list) and the cache placement's shared state, if any."""
    _check_supported(cfg)
    state: dict[str, Any] = {
        "lengths": torch.zeros((batch,), dtype=torch.int32,
                               device=cache_ops.device),
        "layers": [cache_ops.init_layer(
            cfg, batch, window=cfg.window_size if k == SWA_ATTN else 0)
            for k in cfg.layers],
    }
    shared = cache_ops.init_shared(cfg, batch)
    if shared is not None:
        state["kv_shared"] = shared
    return state


def apply_block_step(cfg: ModelConfig, kind: str, bp: dict, x: torch.Tensor,
                     st: Any, lengths: torch.Tensor, cache_ops,
                     shared: Any = None) -> tuple[torch.Tensor, Any]:
    h = layers.apply_norm(cfg.norm, x, bp["norm1"])
    q, k_new, v_new = attention.qkv_step(cfg, bp["attn"], h, lengths)
    window = cfg.window_size if kind == SWA_ATTN else 0
    att, st = cache_ops.append_and_attend(cfg, st, shared, lengths, q,
                                          k_new, v_new, window=window)
    x = x + attention.project_out_step(cfg, bp["attn"], att)
    return apply_ffn(cfg, bp, x), st


def decode_step(cfg: ModelConfig, params: Any, state: dict,
                tokens: torch.Tensor, cache_ops) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: [B] -> (logits f32[B, V], new state).

    The caches in ``state`` are updated in place; the returned state holds
    them and the advanced lengths.
    """
    x = layers.embed(tokens, params["embed"])
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    lengths = state["lengths"]
    shared = state.get("kv_shared")
    new_layers = []
    for kind, bp, st in zip(cfg.layers, params["layers"], state["layers"]):
        x, st = apply_block_step(cfg, kind, bp, x, st, lengths, cache_ops,
                                 shared)
        new_layers.append(st)
    return (_logits(cfg, params, x),
            dict(state, layers=new_layers, lengths=lengths + 1))


# ---------------------------------------------------------------------------
# Dense (local) KV cache ops: the no-bridge baseline
# ---------------------------------------------------------------------------

class DenseCacheOps:
    """Per-layer state: {k, v: [B, S_max, kv, hd]}, written in place.

    Sliding-window layers mask positions older than the window.
    """

    def __init__(self, max_len: int, dtype=torch.bfloat16, *, device="cuda"):
        self.max_len = max_len
        self.dtype = dtype
        self.device = torch.device(device)

    def init_shared(self, cfg: ModelConfig, batch: int):
        return None

    def init_layer(self, cfg: ModelConfig, batch: int, window: int = 0):
        shape = (batch, self.max_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

    def append_and_attend(self, cfg, st, shared, lengths, q, k_new, v_new, *,
                          window: int = 0):
        rows = torch.arange(q.shape[0], device=q.device)
        # A row at or past max_len drops its write, as the reference's
        # ``.at[].set`` does; the mask stays on the device (no sync).
        pos = lengths.clamp(max=self.max_len - 1)
        keep = (lengths < self.max_len)[:, None, None]
        for name, new in (("k", k_new), ("v", v_new)):
            cache = st[name]
            cache[rows, pos] = torch.where(keep, new.to(self.dtype),
                                           cache[rows, pos])
        visible = lengths + 1
        if window > 0:
            lo = (visible - window).clamp(min=0)
            pos = torch.arange(self.max_len, device=q.device)[None, :]
            mask = (pos >= lo[:, None]) & (pos < visible[:, None])
            att = masked_decode_attention(q, st["k"], st["v"], mask)
        else:
            att = decode_attention_ref(q, st["k"], st["v"], visible)
        return att, st
