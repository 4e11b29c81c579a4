"""KV-cache placement through the bridge (the serve-side bridge client).

Implements the cache-ops protocol used by
:func:`repro_torch.models.transformer.decode_step`:

    init_shared(cfg, batch) -> dict | None        (memport table)
    init_layer(cfg, batch, window=0) -> dict
    append_and_attend(cfg, st, shared, lengths, q, k_new, v_new, *, window)
        -> (att_out [B, H, hd], new_st)

:class:`BridgeCacheOps` keeps every layer's KV pages in a pool addressed
through one memport table and, in ``pull`` mode, pulls them back through the
loopback bridge each step.  ``push`` mode (compute at the memory), the
sliding-window ring buffer and telemetry come with later slices of the port.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import kvbridge
from repro_torch.core.memport import MemPortTable


class BridgeCacheOps:
    """Disaggregated paged KV through the loopback bridge, ``pull`` mode."""

    def __init__(self, *, mode: str, max_len: int, page_tokens: int,
                 budget: int = 8, dtype=torch.bfloat16, device="cuda"):
        if mode != "pull":
            raise NotImplementedError(
                f"BridgeCacheOps mode {mode!r}: the push placement comes with "
                f"a later slice of the port")
        self.mode = mode
        self.max_len = max_len
        self.page_tokens = page_tokens
        self.max_pages = -(-max_len // page_tokens)
        self.budget = budget
        self.dtype = dtype
        self.device = torch.device(device)

    def init_shared(self, cfg: ModelConfig, batch: int):
        num_logical = batch * self.max_pages
        return {"table": MemPortTable.striped(num_logical, 1, num_logical,
                                              device=self.device)}

    def init_layer(self, cfg: ModelConfig, batch: int, window: int = 0):
        if window > 0:
            raise NotImplementedError(
                "sliding-window layers keep a local ring buffer, which comes "
                "with a later slice of the port")
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        pool = (batch * self.max_pages, self.page_tokens, kv, hd)
        tail = (batch, self.page_tokens, kv, hd)

        def zeros(shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        return {"paged": kvbridge.PagedKVLayer(
            k_pool=zeros(pool), v_pool=zeros(pool),
            tail_k=zeros(tail), tail_v=zeros(tail))}

    def append_and_attend(self, cfg, st, shared, lengths, q, k_new, v_new, *,
                          window: int = 0):
        table = shared["table"]
        layer = kvbridge.append(
            st["paged"], table, lengths, k_new, v_new,
            page_tokens=self.page_tokens, max_pages=self.max_pages,
            budget=self.budget)
        att = kvbridge.decode_attention_pull(
            q, layer, table, lengths + 1, page_tokens=self.page_tokens,
            max_pages=self.max_pages, budget=self.budget)
        return att, {"paged": layer}
