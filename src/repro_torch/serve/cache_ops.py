"""KV-cache placements through the bridge (the serve-side bridge client).

Implements the cache-ops protocol used by
:func:`repro_torch.models.transformer.decode_step`:

    init_shared(cfg, batch) -> dict | None        (memport table)
    init_layer(cfg, batch, window=0) -> dict
    append_and_attend(cfg, st, shared, lengths, q, k_new, v_new, *, window)
        -> (att_out [B, H, hd], new_st)

* :class:`RingCacheOps` — a bounded ring buffer of the last ``window``
  tokens (``max_len`` on full-attention layers);
* :class:`BridgeCacheOps` — every full-attention layer's KV pages in a pool
  striped over ``num_nodes`` memory nodes and addressed through one memport
  table.  ``pull`` mode pulls them back through the bridge each step (the
  loopback path for one node, the N-node engine steered by a route
  program otherwise: fused or unfused, as ``fused`` and ``edge_buffer``
  pick, :func:`~repro_torch.core.kvbridge._transfer_fused`); ``push`` mode
  computes attention at the memory nodes.  Sliding-window layers keep a
  local ring (their state is bounded).  The table and the program live in
  the shared state (``state["kv_shared"]``) as runtime inputs: the control
  plane may swap either between steps.  With ``collect_telemetry`` every
  pooled layer's state carries the cumulative bridge counters in
  ``st["telem"]``.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import kvbridge, steering
from repro_torch.core.kvbridge import masked_decode_attention
from repro_torch.core.memport import MemPortTable
from repro_torch.telemetry import counters as telemetry_counters


class RingCacheOps:
    """Bounded sliding-window cache: stores the last ``window`` tokens,
    written in place.  Attention is the reference's
    ``_masked_gqa_attention``
    (:func:`~repro_torch.core.kvbridge.masked_decode_attention`)."""

    def __init__(self, max_len: int, dtype=torch.bfloat16, *, device="cuda"):
        self.max_len = max_len
        self.dtype = dtype
        self.device = torch.device(device)

    def init_shared(self, cfg: ModelConfig, batch: int):
        return None

    def init_layer(self, cfg: ModelConfig, batch: int, window: int = 0):
        size = min(window, self.max_len) if window > 0 else self.max_len
        shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "pos": torch.full((batch, size), -1, dtype=torch.int32,
                                  device=self.device)}

    def append_and_attend(self, cfg, st, shared, lengths, q, k_new, v_new, *,
                          window: int = 0):
        rows = torch.arange(q.shape[0], device=q.device)
        slot = lengths % st["k"].shape[1]
        st["k"][rows, slot] = k_new.to(self.dtype)
        st["v"][rows, slot] = v_new.to(self.dtype)
        st["pos"][rows, slot] = lengths
        pos = st["pos"]
        visible = lengths + 1
        mask = (pos >= 0) & (pos < visible[:, None])
        if window > 0:
            mask &= pos >= (visible - window).clamp(min=0)[:, None]
        return masked_decode_attention(q, st["k"], st["v"], mask), st


class BridgeCacheOps:
    """Disaggregated paged KV through the bridge, ``pull`` or ``push`` mode,
    over ``num_nodes`` memory nodes with ``channels`` virtual channels a
    round; ``edge_buffer`` and ``fused`` go to the KV cache's bridge calls
    as in the reference (False: a bufferless bridge, the unfused engine).

    ``tenant_of_seq`` (one tenant id per batch slot; a list or array is
    converted once to a device int32 tensor) attributes every page a slot
    pulls or flushes to its tenant in the counters; ``max_tenants`` is their
    static width (0 = the default); ``topology`` the fabric the counters
    classify tiers by (default: one flat board).
    """

    def __init__(self, *, mode: str, max_len: int, page_tokens: int,
                 num_nodes: int = 1, budget: int = 8,
                 edge_buffer: bool = True, channels: int = 1,
                 fused: bool = True, collect_telemetry: bool = False,
                 tenant_of_seq=None,
                 max_tenants: int = 0, topology=None,
                 dtype=torch.bfloat16, device="cuda"):
        if mode not in ("pull", "push"):
            raise ValueError(f"BridgeCacheOps mode {mode!r}")
        self.mode = mode
        self.max_len = max_len
        self.page_tokens = page_tokens
        self.max_pages = -(-max_len // page_tokens)
        self.budget = budget
        self.edge_buffer = edge_buffer
        self.channels = channels
        self.fused = fused
        self.collect_telemetry = collect_telemetry
        self.device = torch.device(device)
        self.tenant_of_seq = (None if tenant_of_seq is None else
                              torch.as_tensor(tenant_of_seq).to(
                                  device=self.device, dtype=torch.int32))
        self.max_tenants = max_tenants
        self.topology = topology
        self.dtype = dtype
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

    def _ring(self) -> RingCacheOps:
        return RingCacheOps(self.max_len, self.dtype, device=self.device)

    def init_layer(self, cfg: ModelConfig, batch: int, window: int = 0):
        if window > 0:      # sliding-window layers stay local (bounded)
            return {"ring": self._ring().init_layer(cfg, batch, window)}
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        n = self.num_nodes()
        pool = (n * self.slots_per_node(batch), self.page_tokens, kv, hd)
        tail = (batch, self.page_tokens, kv, hd)

        def zeros(shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        st = {"paged": kvbridge.PagedKVLayer(
            k_pool=zeros(pool), v_pool=zeros(pool),
            tail_k=zeros(tail), tail_v=zeros(tail))}
        if self.collect_telemetry:
            st["telem"] = telemetry_counters.zeros(
                n, leading=(n,),
                max_tenants=(self.max_tenants
                             or telemetry_counters.DEFAULT_MAX_TENANTS),
                device=self.device)
        return st

    def append_and_attend(self, cfg, st, shared, lengths, q, k_new, v_new, *,
                          window: int = 0):
        if window > 0:
            att, ring = self._ring().append_and_attend(
                cfg, st["ring"], None, lengths, q, k_new, v_new,
                window=window)
            return att, {"ring": ring}
        table = shared["table"]
        collect = self.collect_telemetry
        kw = dict(page_tokens=self.page_tokens, max_pages=self.max_pages,
                  num_nodes=self.num_nodes())
        bridge_kw = dict(kw, budget=self.budget,
                         edge_buffer=self.edge_buffer,
                         channels=self.channels, fused=self.fused,
                         program=shared.get("program"),
                         collect_telemetry=collect, topology=self.topology,
                         tenant_of_seq=self.tenant_of_seq,
                         max_tenants=self.max_tenants)
        layer = kvbridge.append(st["paged"], table, lengths, k_new, v_new,
                                **bridge_kw)
        if collect:
            layer, telem = layer
        visible = lengths + 1
        if self.mode == "pull":
            att = kvbridge.decode_attention_pull(q, layer, table, visible,
                                                 **bridge_kw)
            if collect:
                att, pull_telem = att
                telem = telemetry_counters.add(telem, pull_telem)
        else:
            att = kvbridge.decode_attention_push(q, layer, table, visible,
                                                 **kw)
        new_st = {"paged": layer}
        if collect:
            new_st["telem"] = telemetry_counters.add(st["telem"], telem)
        return att, new_st
