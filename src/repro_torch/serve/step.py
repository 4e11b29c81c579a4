"""Serve-step builder: one batched greedy decode step with a KV placement."""
from __future__ import annotations

import torch

from repro_torch.config import RunConfig
from repro_torch.models import transformer
from repro_torch.serve.cache_ops import BridgeCacheOps


def make_cache_ops(run: RunConfig, max_len: int, page_tokens: int = 512, *,
                   num_nodes: int = 1, dtype=torch.bfloat16, device="cuda"):
    """Build the KV-placement ops for a serve step (``local`` or
    ``bridge_pull``; the other placements come with later slices).

    ``num_nodes`` is the size of the memory axis the KV pool is striped
    over, on one device: 1 runs the loopback bridge, more the fused N-node
    engine (the reference's ``mesh``); ``run.bridge`` gives the round budget
    and the channels."""
    kp = run.kv_placement
    if kp == "local":
        return transformer.DenseCacheOps(max_len, dtype, device=device)
    if kp == "bridge_pull":
        return BridgeCacheOps(mode="pull", max_len=max_len,
                              page_tokens=page_tokens, num_nodes=num_nodes,
                              budget=run.bridge.epoch_budget,
                              channels=run.bridge.channels, dtype=dtype,
                              device=device)
    raise NotImplementedError(
        f"kv placement {kp!r} comes with a later slice of the port")


def init_serve_state(run: RunConfig, batch: int, cache_ops) -> dict:
    return transformer.init_decode_state(run.model, batch, cache_ops)


def build_serve_step(run: RunConfig, cache_ops):
    cfg = run.model

    def serve_step(params, state, tokens):
        logits, state = transformer.decode_step(cfg, params, state, tokens,
                                                cache_ops)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, state

    return serve_step
