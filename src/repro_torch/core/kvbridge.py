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
bridge once, when it fills.  Decode attention in ``bridge_pull`` placement
pulls the flushed pages one bridge round at a time (``N * budget`` pages,
node-major) and folds each round straight into the float32 flash-decode
state (:func:`~repro_torch.kernels.bridge_attention.
stream_decode_accumulate`), then merges the tail page's partial.

The reference's buffers are immutable; the port updates the pools and the
tail buffers in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import bridge
from repro_torch.core.memport import FREE, MemPortTable
from repro_torch.core.steering import RouteProgram
from repro_torch.kernels.bridge_attention import stream_decode_accumulate

NEG_INF = -1e30


@dataclass
class PagedKVLayer:
    """Per-layer paged KV state."""

    k_pool: torch.Tensor        # [slots, T, kv, hd]
    v_pool: torch.Tensor        # [slots, T, kv, hd]
    tail_k: torch.Tensor        # [B, T, kv, hd]  local write buffer
    tail_v: torch.Tensor        # [B, T, kv, hd]


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


def append(layer: PagedKVLayer, table: MemPortTable, lengths: torch.Tensor,
           k_new: torch.Tensor, v_new: torch.Tensor, *, page_tokens: int,
           max_pages: int, num_nodes: int = 1, budget: int = 8,
           channels: int = 1,
           program: Optional[RouteProgram] = None) -> PagedKVLayer:
    """Append one token's (k, v) [B, kv, hd] for one layer.

    Tokens land in the local tail buffer; when a sequence's tail page fills,
    the page is flushed through the bridge to its pooled home (one masked
    ``push_pages`` per pool over ``num_nodes`` nodes: sequences not at a
    page boundary, and the padding rows of a batch that does not split
    evenly over the nodes, carry FREE).  ``channels`` and ``program`` thread
    to the bridge.  Updates ``layer``'s tensors in place and returns it.
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
              program=program)
    bridge.push_pages(layer.k_pool, dest, _by_node(layer.tail_k, num_nodes),
                      table, **kw)
    bridge.push_pages(layer.v_pool, dest, _by_node(layer.tail_v, num_nodes),
                      table, **kw)
    # A flushed tail restarts empty (zeros are fine: positions are masked).
    flushed = page_full[:, None, None, None]
    layer.tail_k.masked_fill_(flushed, 0)
    layer.tail_v.masked_fill_(flushed, 0)
    return layer


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------

def decode_attention_pull(q: torch.Tensor, layer: PagedKVLayer,
                          table: MemPortTable, lengths: torch.Tensor, *,
                          page_tokens: int, max_pages: int,
                          num_nodes: int = 1, budget: int = 8,
                          channels: int = 1,
                          program: Optional[RouteProgram] = None
                          ) -> torch.Tensor:
    """Paper-faithful: pull pages through the bridge, attend locally.

    q: [B, H, hd] -> out [B, H, hd].  Node i requests the pages of its
    ``ceil(B / num_nodes)`` sequences; pages stream through the
    online-softmax accumulator one bridge round at a time, ``budget`` pages
    per node, node-major: every round of the request list is pulled,
    all-FREE rounds included, in the reference's order, so each lane lands
    where it lands in the reference.  ``channels`` and ``program`` thread to
    the bridge.
    """
    b, h, hd = q.shape
    kv = layer.k_pool.shape[-2]
    want = logical_page_ids(b, max_pages, device=q.device)       # [B, P]
    # Only fully-flushed pages live in the pool.
    flushed = lengths // page_tokens
    page = torch.arange(max_pages, device=q.device)
    want = torch.where(page[None, :] < flushed[:, None], want, FREE)
    want = _by_node(want.to(torch.int32), num_nodes, fill=FREE)
    want = want.reshape(num_nodes, -1)                  # [N, B/N * P]
    kw = dict(num_nodes=num_nodes, budget=budget, channels=channels,
              program=program)

    rtot = want.shape[-1]
    m_s = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
    l_s = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    o_s = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
    for start in range(0, rtot, budget):
        want_r = want[:, start:start + budget]
        k_r = bridge.pull_pages(layer.k_pool, want_r, table, **kw)
        v_r = bridge.pull_pages(layer.v_pool, want_r, table, **kw)
        lanes = want_r.numel()
        wflat = want_r.reshape(-1)
        live = wflat >= 0
        # Logical page ids encode their sequence: id // max_pages.
        seq = torch.where(live, wflat // max_pages, -1)
        m_s, l_s, o_s = stream_decode_accumulate(
            q, k_r.reshape(lanes, page_tokens, kv, hd),
            v_r.reshape(lanes, page_tokens, kv, hd), seq,
            live.to(torch.int32), m_s, l_s, o_s)

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
