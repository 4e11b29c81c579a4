"""KV-cache placement through the bridge (the serve-side bridge client).

Implements the cache-ops protocol used by
:func:`repro_torch.models.transformer.decode_step`:

    init_shared(cfg, batch) -> dict | None        (memport table)
    init_layer(cfg, batch, window=0) -> dict
    append_and_attend(cfg, st, shared, lengths, q, k_new, v_new, *, window)
        -> (att_out [B, H, hd], new_st)

:class:`BridgeCacheOps` keeps every layer's KV pages in a pool striped over
``num_nodes`` memory nodes and addressed through one memport table and, in
``pull`` mode, pulls them back through the bridge each step: the loopback
path for one node, the fused N-node engine steered by a route program
otherwise.  The table and the program live in the shared state
(``state["kv_shared"]``) as runtime inputs: the control plane may swap either
between steps.  ``push`` mode (compute at the memory), the sliding-window
ring buffer and telemetry come with later slices of the port.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import kvbridge, steering
from repro_torch.core.memport import MemPortTable


class BridgeCacheOps:
    """Disaggregated paged KV through the bridge, ``pull`` mode, over
    ``num_nodes`` memory nodes with ``channels`` virtual channels a round."""

    def __init__(self, *, mode: str, max_len: int, page_tokens: int,
                 num_nodes: int = 1, budget: int = 8, channels: int = 1,
                 dtype=torch.bfloat16, device="cuda"):
        if mode != "pull":
            raise NotImplementedError(
                f"BridgeCacheOps mode {mode!r}: the push placement comes with "
                f"a later slice of the port")
        self.mode = mode
        self.max_len = max_len
        self.page_tokens = page_tokens
        self.max_pages = -(-max_len // page_tokens)
        self.budget = budget
        self.channels = channels
        self.dtype = dtype
        self.device = torch.device(device)
        self._num_nodes = num_nodes

    def num_nodes(self) -> int:
        return self._num_nodes

    def slots_per_node(self, batch: int) -> int:
        return -(-batch * self.max_pages // self.num_nodes())

    def init_shared(self, cfg: ModelConfig, batch: int):
        """The memport table, pages striped over the nodes, and (with more
        than one node) the route program, full bidirectional coverage."""
        n = self.num_nodes()
        shared = {"table": MemPortTable.striped(
            batch * self.max_pages, n, self.slots_per_node(batch),
            device=self.device)}
        if n > 1:
            shared["program"] = steering.bidirectional_program(
                n, device=self.device)
        return shared

    def init_layer(self, cfg: ModelConfig, batch: int, window: int = 0):
        if window > 0:
            raise NotImplementedError(
                "sliding-window layers keep a local ring buffer, which comes "
                "with a later slice of the port")
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        pool = (self.num_nodes() * self.slots_per_node(batch),
                self.page_tokens, kv, hd)
        tail = (batch, self.page_tokens, kv, hd)

        def zeros(shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        return {"paged": kvbridge.PagedKVLayer(
            k_pool=zeros(pool), v_pool=zeros(pool),
            tail_k=zeros(tail), tail_v=zeros(tail))}

    def append_and_attend(self, cfg, st, shared, lengths, q, k_new, v_new, *,
                          window: int = 0):
        table = shared["table"]
        kw = dict(page_tokens=self.page_tokens, max_pages=self.max_pages,
                  num_nodes=self.num_nodes(), budget=self.budget,
                  channels=self.channels, program=shared.get("program"))
        layer = kvbridge.append(st["paged"], table, lengths, k_new, v_new,
                                **kw)
        att = kvbridge.decode_attention_pull(q, layer, table, lengths + 1,
                                             **kw)
        return att, {"paged": layer}
