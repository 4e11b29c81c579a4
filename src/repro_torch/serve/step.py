"""Serve-step builder: one batched greedy decode step with a KV placement."""
from __future__ import annotations

import torch

from repro_torch.config import FULL_ATTN, GLOBAL_ATTN, RunConfig
from repro_torch.models import transformer
from repro_torch.serve.cache_ops import BridgeCacheOps, RingCacheOps
from repro_torch.telemetry import counters as telemetry_counters


def make_cache_ops(run: RunConfig, max_len: int, page_tokens: int = 512, *,
                   num_nodes: int = 1, collect_telemetry: bool = False,
                   tenant_of_seq=None, max_tenants: int = 0, topology=None,
                   dtype=torch.bfloat16, device="cuda"):
    """Build the KV-placement ops for a serve step: ``local`` (a ring
    buffer when every layer is sliding-window), ``ring``, ``bridge_pull``
    or ``bridge_push``.

    ``num_nodes`` is the size of the memory axis the KV pool is striped
    over, on one device: 1 runs the loopback bridge, more an N-node
    engine (the reference's ``mesh``); ``run.bridge`` gives the round
    budget, the channels, ``edge_buffer`` and ``fused`` (False: the
    bufferless bridge, the unfused engine).  ``collect_telemetry``,
    ``tenant_of_seq``, ``max_tenants`` and ``topology`` go to the bridge
    placements and are ignored by the others (no bridge traffic to
    count)."""
    kp = run.kv_placement
    if kp == "local":
        cfgm = run.model
        if (all(k not in (FULL_ATTN, GLOBAL_ATTN) for k in cfgm.layers)
                and cfgm.window_size > 0):
            return RingCacheOps(max_len, dtype, device=device)
        return transformer.DenseCacheOps(max_len, dtype, device=device)
    if kp == "ring":
        return RingCacheOps(max_len, dtype, device=device)
    if kp in ("bridge_pull", "bridge_push"):
        return BridgeCacheOps(mode=kp.split("_")[1], max_len=max_len,
                              page_tokens=page_tokens, num_nodes=num_nodes,
                              budget=run.bridge.epoch_budget,
                              edge_buffer=run.bridge.edge_buffer,
                              channels=run.bridge.channels,
                              fused=run.bridge.fused,
                              collect_telemetry=collect_telemetry,
                              tenant_of_seq=tenant_of_seq,
                              max_tenants=max_tenants, topology=topology,
                              dtype=dtype, device=device)
    raise ValueError(kp)


def collect_state_telemetry(state):
    """Sum the cumulative bridge counters carried in a decode state: one
    :class:`~repro_torch.telemetry.counters.BridgeTelemetry` (layers
    summed), or None when the state carries none (collection off, or a
    placement without the bridge)."""
    total = None
    for st in state["layers"]:
        telem = st.get("telem") if isinstance(st, dict) else None
        if telem is not None:
            total = (telem if total is None
                     else telemetry_counters.add(total, telem))
    return total


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
