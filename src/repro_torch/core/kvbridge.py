"""Disaggregated KV cache through the bridge (the paper's case study).

Layout, as in ``repro.core.kvbridge``: per layer, KV pages live in pools

    k_pool, v_pool : [num_slots, page_tokens, kv_heads, head_dim]

striped over ``num_nodes`` memory nodes (node-major rows, ``num_nodes *
slots_per_node`` of them) and addressed through one
:class:`~repro_torch.core.memport.MemPortTable` shared by all layers.  The
batch splits over the nodes: node i requests and flushes the pages of
sequences ``i * per_node .. (i + 1) * per_node - 1`` (``per_node =
ceil(B / N)``; padding rows carry FREE).  The tail (partially-filled) page
of each sequence stays in a local write buffer and is flushed through the
bridge once, when it fills.  Two decode-attention placements:

* ``bridge_pull`` pulls the flushed pages one bridge round at a time
  (``N * budget`` pages, node-major) and folds each round straight into the
  float32 flash-decode state (:func:`~repro_torch.kernels.bridge_attention.
  stream_decode_accumulate`), then merges the tail page's partial; with
  ``fused=False`` it pulls the whole request list at once through the
  unfused engine and attends with plain tensor code (per-page partials
  combined by their log-sum-exp), launching no kernel;
* ``bridge_push`` (compute at the memory) computes a partial attention per
  memory node over the slots it holds and combines the partials by their
  log-sum-exp (the reference's ``pmax`` / ``psum`` become a max and a sum
  over the node axis), then merges the tail.  As in the reference this is
  plain tensor code; only its flushes launch the bridge's write kernels.

``fused`` and ``edge_buffer`` pick the bridge's engine, as in the
reference: a bufferless bridge's N-node transfers run the unfused engine
(:func:`_transfer_fused`).  With ``collect_telemetry`` the flushes and
pulls also return the bridge's in-band counters, summed over the k and v
transfers and over the rounds.  The reference's buffers are immutable;
the port updates the pools and the tail buffers in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import bridge
from repro_torch.core.memport import FREE, MemPortTable
from repro_torch.core.steering import RouteProgram
from repro_torch.kernels.bridge_attention import stream_decode_accumulate
from repro_torch.telemetry import counters as telemetry_counters

NEG_INF = -1e30


@dataclass
class PagedKVLayer:
    """Per-layer paged KV state."""

    k_pool: torch.Tensor        # [slots, T, kv, hd]
    v_pool: torch.Tensor        # [slots, T, kv, hd]
    tail_k: torch.Tensor        # [B, T, kv, hd]  local write buffer
    tail_v: torch.Tensor        # [B, T, kv, hd]


@dataclass
class PagedKVCache:
    """Whole-model paged cache: the layers' tensors stacked on a leading
    layer axis (layer i is ``PagedKVLayer(*(t[i] for t in ...))``)."""

    layers: PagedKVLayer     # tensors [L, ...]
    table: MemPortTable      # shared logical (b, page) -> (home, slot)
    lengths: torch.Tensor    # i32[B] tokens already cached
    page_tokens: int
    max_pages: int

    @property
    def batch(self) -> int:
        return self.lengths.shape[0]


def init_cache(num_layers: int, batch: int, max_len: int, page_tokens: int,
               kv_heads: int, head_dim: int, *, num_nodes: int = 1,
               dtype=torch.bfloat16, table: Optional[MemPortTable] = None,
               lengths: Optional[torch.Tensor] = None,
               device="cuda") -> PagedKVCache:
    """An empty cache striped over ``num_nodes`` memory nodes."""
    max_pages = -(-max_len // page_tokens)
    slots_per_node = -(-batch * max_pages // num_nodes)
    num_slots = num_nodes * slots_per_node
    if table is None:
        table = MemPortTable.striped(batch * max_pages, num_nodes,
                                     slots_per_node, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    pool = (num_layers, num_slots, page_tokens, kv_heads, head_dim)
    tail = (num_layers, batch, page_tokens, kv_heads, head_dim)
    layers = PagedKVLayer(k_pool=zeros(*pool), v_pool=zeros(*pool),
                          tail_k=zeros(*tail), tail_v=zeros(*tail))
    if lengths is None:
        lengths = torch.zeros((batch,), dtype=torch.int32, device=device)
    return PagedKVCache(layers=layers, table=table, lengths=lengths,
                        page_tokens=page_tokens, max_pages=max_pages)


def logical_page_ids(batch: int, max_pages: int, *,
                     device="cuda") -> torch.Tensor:
    """Logical id of page p of sequence b is b * max_pages + p."""
    b = torch.arange(batch, dtype=torch.int32, device=device)
    p = torch.arange(max_pages, dtype=torch.int32, device=device)
    return b[:, None] * max_pages + p[None, :]


# ---------------------------------------------------------------------------
# Online-softmax helpers (flash-decode accumulators)
# ---------------------------------------------------------------------------

def _merge(m1, l1, o1, m2, l2, o2):
    """Merge two partial-softmax states (m: max, l: denom, o: weighted sum)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, l1 * a1 + l2 * a2, o1 * a1[..., None] + o2 * a2[..., None]


def _page_partial(q, k, v, valid):
    """Partial attention of per-page queries q [R, H, hd] against one page
    each: k, v [R, T, kv, hd], valid [R, T] bool.  Returns per-page
    partials (m [R, H], l [R, H], o [R, H, hd])."""
    r, t, kv, hd = k.shape
    h = q.shape[-2]
    g = h // kv
    qf = q.reshape(r, kv, g, hd).float()
    s = torch.einsum("rkgd,rtkd->rkgt", qf, k.float()) * hd ** -0.5
    mask = valid[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, 0.0)
    l = p.sum(-1)
    o = torch.einsum("rkgt,rtkd->rkgd", p, v.float())
    return m.reshape(r, h), l.reshape(r, h), o.reshape(r, h, hd)


def _segment_combine(m, l, o, seg, num_segments):
    """LSE-combine per-page partials into per-segment accumulators; pages
    with ``seg`` outside ``[0, num_segments)`` are dropped."""
    seg = torch.where((seg >= 0) & (seg < num_segments), seg,
                      num_segments).long()
    h = m.shape[-1]
    m_seq = torch.full((num_segments + 1, h), float("-inf"),
                       dtype=m.dtype, device=m.device)
    m_seq.scatter_reduce_(0, seg[:, None].expand(-1, h), m, "amax")
    m_seq = m_seq[:num_segments].clamp(min=NEG_INF)
    a = torch.exp(m - m_seq[seg.clamp(max=num_segments - 1)])
    a = torch.where((seg < num_segments)[:, None], a, 0.0)
    l_seq = l.new_zeros((num_segments + 1, h)).index_add_(0, seg, l * a)
    o_seq = o.new_zeros((num_segments + 1,) + tuple(o.shape[1:])).index_add_(
        0, seg, o * a[..., None])
    return m_seq, l_seq[:num_segments], o_seq[:num_segments]


def _tail_partial(q, tail_k, tail_v, lengths, page_tokens):
    """Partial attention over the local write buffer (tail page)."""
    b, h, hd = q.shape
    kv = tail_k.shape[-2]
    g = h // kv
    start = (lengths // page_tokens) * page_tokens
    pos = start[:, None] + torch.arange(page_tokens, device=q.device)[None, :]
    valid = (pos < lengths[:, None])[:, None, None, :]           # [B,1,1,T]
    qf = q.reshape(b, kv, g, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qf, tail_k.float())
    s = s * (hd ** -0.5)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid, p, 0.0)
    l = p.sum(-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, tail_v.float())
    return m.reshape(b, h), l.reshape(b, h), o.reshape(b, h, hd)


def _finalize(m, l, o):
    return o / l.clamp(min=1e-30)[..., None]


# ---------------------------------------------------------------------------
# Append (write path): edge-buffered write combining
# ---------------------------------------------------------------------------

def _by_node(x: torch.Tensor, num_nodes: int, fill=0) -> torch.Tensor:
    """[B, ...] -> [N, ceil(B / N), ...], padding rows filled with ``fill``."""
    per_node = -(-x.shape[0] // num_nodes)
    pad = num_nodes * per_node - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)], 0)
    return x.reshape((num_nodes, per_node) + tuple(x.shape[1:]))


def _transfer_fused(fused: bool, edge_buffer: bool, num_nodes: int) -> bool:
    """The bridge's ``fused`` for one transfer.  A bufferless bridge
    (``edge_buffer=False``) has no edge buffers to land a fused round in:
    its N-node transfers run the serial unfused engine, as the reference's
    do.  The loopback path has no wire and ignores it."""
    return fused and (edge_buffer or num_nodes == 1)


def append(layer: PagedKVLayer, table: MemPortTable, lengths: torch.Tensor,
           k_new: torch.Tensor, v_new: torch.Tensor, *, page_tokens: int,
           max_pages: int, num_nodes: int = 1, budget: int = 8,
           edge_buffer: bool = True, channels: int = 1,
           program: Optional[RouteProgram] = None,
           collect_telemetry: bool = False, topology=None,
           tenant_of_seq: Optional[torch.Tensor] = None,
           max_tenants: int = 0, fused: bool = True):
    """Append one token's (k, v) [B, kv, hd] for one layer.

    Tokens land in the local tail buffer; when a sequence's tail page fills,
    the page is flushed through the bridge to its pooled home (one masked
    ``push_pages`` per pool over ``num_nodes`` nodes: sequences not at a
    page boundary, and the padding rows of a batch that does not split
    evenly over the nodes, carry FREE).  ``channels`` and ``program``
    thread to the bridge; ``fused`` and ``edge_buffer`` pick its engine
    (:func:`_transfer_fused`).  Updates ``layer``'s
    tensors in place and returns it, or
    ``(layer, telemetry)`` with ``collect_telemetry``: the write-path
    counters of both pushes summed; ``tenant_of_seq`` (i32[B] on the
    device) attributes each sequence's flushes to its tenant.
    """
    b = lengths.shape[0]
    rows = torch.arange(b, device=lengths.device)
    off = lengths % page_tokens
    layer.tail_k[rows, off] = k_new.to(layer.tail_k.dtype)
    layer.tail_v[rows, off] = v_new.to(layer.tail_v.dtype)

    page_full = off == page_tokens - 1
    page_idx = lengths // page_tokens
    dest = torch.where(page_full & (page_idx < max_pages),
                       rows.to(torch.int32) * max_pages + page_idx, FREE)
    # Padding rows must carry FREE destinations: a zero pad would be a live
    # push into logical page 0 (sequence 0's first KV page) every step.
    dest = _by_node(dest.to(torch.int32), num_nodes, fill=FREE)  # [N, B/N]
    kw = dict(num_nodes=num_nodes, budget=budget, channels=channels,
              program=program, collect_telemetry=collect_telemetry,
              topology=topology, max_tenants=max_tenants,
              fused=_transfer_fused(fused, edge_buffer, num_nodes))
    if collect_telemetry and tenant_of_seq is not None:
        kw["tenant_ids"] = _by_node(tenant_of_seq.to(torch.int32), num_nodes)
    k_out = bridge.push_pages(layer.k_pool, dest,
                              _by_node(layer.tail_k, num_nodes), table, **kw)
    v_out = bridge.push_pages(layer.v_pool, dest,
                              _by_node(layer.tail_v, num_nodes), table, **kw)
    # A flushed tail restarts empty (zeros are fine: positions are masked).
    flushed = page_full[:, None, None, None]
    layer.tail_k.masked_fill_(flushed, 0)
    layer.tail_v.masked_fill_(flushed, 0)
    if collect_telemetry:
        return layer, telemetry_counters.add(k_out[1], v_out[1])
    return layer


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------

def decode_attention_pull(q: torch.Tensor, layer: PagedKVLayer,
                          table: MemPortTable, lengths: torch.Tensor, *,
                          page_tokens: int, max_pages: int,
                          num_nodes: int = 1, budget: int = 8,
                          edge_buffer: bool = True, channels: int = 1,
                          program: Optional[RouteProgram] = None,
                          collect_telemetry: bool = False, topology=None,
                          tenant_of_seq: Optional[torch.Tensor] = None,
                          max_tenants: int = 0, fused: bool = True):
    """Paper-faithful: pull pages through the bridge, attend locally.

    q: [B, H, hd] -> out [B, H, hd].  Node i requests the pages of its
    ``ceil(B / num_nodes)`` sequences; pages stream through the
    online-softmax accumulator one bridge round at a time, ``budget`` pages
    per node, node-major: every round of the request list is pulled,
    all-FREE rounds included, in the reference's order, so each lane lands
    where it lands in the reference.  ``channels`` and ``program`` thread
    to the bridge; ``edge_buffer=False`` keeps the fold but pulls each
    round through the unfused engine (:func:`_transfer_fused`).
    ``fused=False`` is the reference's unfused branch: one pull of the
    whole ``[N, per_node * max_pages]`` request list for k and one for v,
    then per-page partials (:func:`_page_partial`) combined per sequence
    (:func:`_segment_combine`); the pulled pages are bit-exact against
    ``fused=True`` and the output matches it to float tolerance (the pages
    are folded in another order).
    With ``collect_telemetry`` returns ``(out, telemetry)``: the counters of
    the k and v pulls added each round (fused) or once (unfused);
    ``tenant_of_seq`` (i32[B]) attributes each sequence's pulls.
    """
    b = q.shape[0]
    want = logical_page_ids(b, max_pages, device=q.device)       # [B, P]
    # Only fully-flushed pages live in the pool.
    flushed = lengths // page_tokens
    page = torch.arange(max_pages, device=q.device)
    want = torch.where(page[None, :] < flushed[:, None], want, FREE)
    want = _by_node(want.to(torch.int32), num_nodes, fill=FREE)
    want = want.reshape(num_nodes, -1)                  # [N, B/N * P]
    kw = dict(num_nodes=num_nodes, budget=budget, channels=channels,
              program=program, collect_telemetry=collect_telemetry,
              topology=topology, max_tenants=max_tenants,
              fused=_transfer_fused(fused, edge_buffer, num_nodes))
    tenants = None
    if collect_telemetry and tenant_of_seq is not None:
        ten_b = tenant_of_seq.to(torch.int32)[:, None].expand(b, max_pages)
        tenants = _by_node(ten_b, num_nodes).reshape(num_nodes, -1)
    if fused:
        m_s, l_s, o_s, telem = _pull_rounds(q, layer, table, want, tenants,
                                            kw, page_tokens=page_tokens,
                                            max_pages=max_pages)
    else:
        m_s, l_s, o_s, telem = _pull_whole(q, layer, table, want, tenants,
                                           flushed, kw,
                                           page_tokens=page_tokens,
                                           max_pages=max_pages)
    m_t, l_t, o_t = _tail_partial(q, layer.tail_k, layer.tail_v,
                                  lengths, page_tokens)
    m, l, o = _merge(m_s, l_s, o_s, m_t, l_t, o_t)
    out = _finalize(m, l, o).to(q.dtype)
    if collect_telemetry:
        return out, telem
    return out


def _pull_rounds(q, layer, table, want, tenants, kw, *, page_tokens: int,
                 max_pages: int):
    """The fused branch: pull one bridge round at a time and fold it into
    the flash-decode state.  Returns (m, l, o, telemetry or None)."""
    b, h, hd = q.shape
    kv = layer.k_pool.shape[-2]
    budget = kw["budget"]
    collect_telemetry = kw["collect_telemetry"]
    telem = None
    rtot = want.shape[-1]
    m_s = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
    l_s = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    o_s = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
    for start in range(0, rtot, budget):
        want_r = want[:, start:start + budget]
        if tenants is not None:
            kw["tenant_ids"] = tenants[:, start:start + budget]
        k_r = bridge.pull_pages(layer.k_pool, want_r, table, **kw)
        v_r = bridge.pull_pages(layer.v_pool, want_r, table, **kw)
        if collect_telemetry:
            (k_r, telem_k), (v_r, telem_v) = k_r, v_r
            round_t = telemetry_counters.add(telem_k, telem_v)
            telem = (round_t if telem is None
                     else telemetry_counters.add(telem, round_t))
        lanes = want_r.numel()
        wflat = want_r.reshape(-1)
        live = wflat >= 0
        # Logical page ids encode their sequence: id // max_pages.
        seq = torch.where(live, wflat // max_pages, -1)
        m_s, l_s, o_s = stream_decode_accumulate(
            q, k_r.reshape(lanes, page_tokens, kv, hd),
            v_r.reshape(lanes, page_tokens, kv, hd), seq,
            live.to(torch.int32), m_s, l_s, o_s)
    return m_s, l_s, o_s, telem


def _pull_whole(q, layer, table, want, tenants, flushed, kw, *,
                page_tokens: int, max_pages: int):
    """The unfused branch: one pull of the whole request list for k and one
    for v, then every page's partial combined per sequence.  Returns (m, l,
    o, telemetry or None)."""
    b, _, hd = q.shape
    kv = layer.k_pool.shape[-2]
    telem = None
    k_pages = bridge.pull_pages(layer.k_pool, want, table,
                                tenant_ids=tenants, **kw)
    v_pages = bridge.pull_pages(layer.v_pool, want, table,
                                tenant_ids=tenants, **kw)
    if kw["collect_telemetry"]:
        (k_pages, telem_k), (v_pages, telem_v) = k_pages, v_pages
        telem = telemetry_counters.add(telem_k, telem_v)
    # [N, per_node * P, T, kv, hd] -> [B * P, T, kv, hd] (padding rows cut)
    page_shape = (page_tokens, kv, hd)
    flat_k = k_pages.reshape((-1, max_pages) + page_shape)[:b].reshape(
        (b * max_pages,) + page_shape)
    flat_v = v_pages.reshape((-1, max_pages) + page_shape)[:b].reshape(
        (b * max_pages,) + page_shape)
    dev = q.device
    page_ids = torch.arange(b * max_pages, device=dev)
    seq_of_page, page_of = page_ids // max_pages, page_ids % max_pages
    pos = (page_of[:, None] * page_tokens
           + torch.arange(page_tokens, device=dev)[None, :])
    fl = flushed[seq_of_page]
    valid = pos < (fl * page_tokens)[:, None]
    m_p, l_p, o_p = _page_partial(q[seq_of_page], flat_k, flat_v, valid)
    seg = torch.where(page_of < fl, seq_of_page, -1)
    m_s, l_s, o_s = _segment_combine(m_p, l_p, o_p, seg, b)
    return m_s, l_s, o_s, telem


def _inverse_map(table: MemPortTable, slots_per_node: int,
                 num_slots: int) -> torch.Tensor:
    """i32[num_slots]: the logical page each pool row holds (FREE where
    none), by one scatter on the device through a dump row."""
    dev = table.home.device
    logical = torch.arange(table.num_logical, dtype=torch.int32, device=dev)
    home, slot = table.translate(logical)
    flat = home.long() * slots_per_node + slot
    flat = torch.where((home >= 0) & (flat >= 0) & (flat < num_slots), flat,
                       num_slots)
    inv = torch.full((num_slots + 1,), FREE, dtype=torch.int32, device=dev)
    return inv.scatter_(0, flat, logical)[:num_slots]


def decode_attention_push(q: torch.Tensor, layer: PagedKVLayer,
                          table: MemPortTable, lengths: torch.Tensor, *,
                          page_tokens: int, max_pages: int,
                          num_nodes: int = 1) -> torch.Tensor:
    """Beyond-paper: q goes to the memory nodes, each computes a partial
    attention over the flushed pages it holds, and the partials merge by
    their log-sum-exp (compute at memory / distributed flash-decode).

    q: [B, H, hd] -> out [B, H, hd].  The inverse memport map (pool row ->
    logical page) is computed on the device each call; the per-node
    partials are the segments ``node * B + sequence`` of one combine.
    """
    b, h, hd = q.shape
    num_slots = layer.k_pool.shape[0]
    slots_per_node = num_slots // num_nodes
    flushed = lengths // page_tokens
    inv = _inverse_map(table, slots_per_node, num_slots)
    seq = torch.where(inv >= 0, inv // max_pages, -1)
    pg = torch.where(inv >= 0, inv % max_pages, 0)
    fl = flushed[seq.clamp(0, b - 1)]
    live = (seq >= 0) & (pg < fl)
    pos = (pg[:, None] * page_tokens
           + torch.arange(page_tokens, device=q.device)[None, :])
    valid = live[:, None] & (pos < (fl * page_tokens)[:, None])
    m_p, l_p, o_p = _page_partial(q[seq.clamp(0, b - 1)], layer.k_pool,
                                  layer.v_pool, valid)
    node = torch.arange(num_slots, device=q.device) // slots_per_node
    seg = torch.where(live & (seq < b), node * b + seq, -1)
    m_l, l_l, o_l = _segment_combine(m_p, l_p, o_p, seg, num_nodes * b)
    if num_nodes == 1:
        m_s, l_s, o_s = m_l, l_l, o_l
    else:
        # Cross-node LSE combine: the max, then the sums, over the nodes.
        m_l = m_l.view(num_nodes, b, h)
        m_s = m_l.amax(0)
        a = torch.exp(m_l.clamp(min=NEG_INF) - m_s)
        l_s = (l_l.view(num_nodes, b, h) * a).sum(0)
        o_s = (o_l.view(num_nodes, b, h, hd) * a[..., None]).sum(0)

    m_t, l_t, o_t = _tail_partial(q, layer.tail_k, layer.tail_v,
                                  lengths, page_tokens)
    m, l, o = _merge(m_s, l_s, o_s, m_t, l_t, o_t)
    return _finalize(m, l, o).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Oracle: dense masked GQA decode attention.

    q: [B, H, hd]; k, v: [B, S, kv, hd]; positions >= lengths masked out.
    """
    valid = (torch.arange(k.shape[1], device=q.device)[None, :]
             < lengths[:, None])
    return masked_decode_attention(q, k, v, valid)


def masked_decode_attention(q, k, v, mask):
    """Dense GQA decode attention of q [B,H,hd] over k, v [B,S,kv,hd] at the
    positions where ``mask`` [B, S] is set."""
    b, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    mask = mask[:, None, None, :]
    qf = q.reshape(b, kv, g, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qf, k.float()) * hd ** -0.5
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, 0.0)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o.reshape(b, h, hd).to(q.dtype)
