"""The bridge transfer engine: the loopback path and the fused N-node engine.

Ports ``repro.core.bridge.pull_pages`` / ``push_pages`` with the fused
datapath.  Requests pad to whole rounds of ``budget`` pages with FREE; the
runtime rate limiter ``active_budget`` spills what lies past
``rounds * active_budget``; each request is translated through the
:class:`~repro_torch.core.memport.MemPortTable` to its home node and slot.

* ``num_nodes == 1`` (loopback): the page moves through one
  :func:`~repro_torch.kernels.bridge_gather.gather_pages` or
  :func:`~repro_torch.kernels.bridge_gather.scatter_pages` launch at the
  flat pool row ``home * pages_per_node + slot``.  The pool may still model
  ``table_nodes`` logical memory nodes, node-major
  (``pages_per_node = pool rows // table_nodes``): request row i is logical
  requester i, a route program for ``table_nodes`` nodes drops the requests
  whose ring distance it does not wire (:func:`repro_torch.core.ref.
  served_mask`), and the counters classify each row's requests on that
  logical ring, as the reference's loopback path does.
* ``num_nodes > 1``: the N memory nodes of the ring are an axis of one
  device, the pool ``[N * ppn, *page]`` node-major (the reference's global
  view of its sharded pool).  A :class:`~repro_torch.core.steering.
  RouteProgram` steers each request onto the circuit of its ring distance,
  as the reference's fused engine with its "a2a" exchange does.  The
  round's all-gather of request windows is the identity (every window is
  already on the device); the serving side of all N nodes is one
  ``gather_pages`` launch into the all-to-all send buffer
  ``[N, N, lanes, *page]``; the all-to-all is an index transpose that
  :func:`~repro_torch.kernels.bridge_gather.pull_commit` reads in place; on
  the write path the all-gather of data windows is an index that
  :func:`~repro_torch.kernels.bridge_gather.push_commit` reads in place.
  The Python loop runs over rounds, never over nodes.

``channels`` splits each round's ``budget`` lanes into virtual channels of
``ceil(budget / channels)`` lanes: what is served never changes, the push
commit order follows the reference's grid.  ``overprovision`` multiplies
the round count, so a throttled rate limiter can still serve every
request.  The table, the program, ``active_budget`` and the tenant lane
stay device tensors: nothing here copies a value to the host, so swapping
any of them between calls builds and synchronises nothing.

``collect_telemetry`` also returns the transfer's in-band counters
(:mod:`repro_torch.telemetry.counters`), computed from the same request
lists with tensor ops for all requester rows at once; they launch none of
the port's kernels.  The unfused, pipelined and bufferless engines and the
"ladder" exchange lowering are not ported (the port runs the fused "a2a"
engine).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import ref as _ref
from repro_torch.core import steering
from repro_torch.core.memport import FREE, MemPortTable
from repro_torch.core.steering import RouteProgram
from repro_torch.core.topology import Topology
from repro_torch.kernels import bridge_gather as _bg
from repro_torch.telemetry import counters as _telemetry


def _resolve_channels(channels: int) -> int:
    if channels < 1:
        raise ValueError(f"channels must be >= 1, got {channels}")
    return int(channels)


_DEFAULT_PROGRAMS: dict = {}


def _resolve_program(program: Optional[RouteProgram], num_nodes: int,
                     device) -> RouteProgram:
    """Default program (full bidirectional coverage, built once per node
    count and device) + static shape check."""
    if program is None:
        key = (num_nodes, str(device))
        if key not in _DEFAULT_PROGRAMS:
            _DEFAULT_PROGRAMS[key] = steering.bidirectional_program(
                num_nodes, device=device)
        return _DEFAULT_PROGRAMS[key]
    if program.num_slots != num_nodes - 1:
        raise ValueError(
            f"route program has {program.num_slots} slots; a {num_nodes}-node "
            f"ring needs {num_nodes - 1}")
    return program


_FLAT_TOPOLOGIES: dict = {}


def _resolve_topology(topology: Optional[Topology],
                      num_nodes: int) -> Topology:
    """Default (flat single-board, one per node count) fabric + node-count
    check; a Topology keeps its device tables, so reusing one uploads
    nothing."""
    if topology is None:
        if num_nodes not in _FLAT_TOPOLOGIES:
            _FLAT_TOPOLOGIES[num_nodes] = Topology.flat(num_nodes)
        return _FLAT_TOPOLOGIES[num_nodes]
    if topology.num_nodes != num_nodes:
        raise ValueError(
            f"topology spans {topology.num_nodes} endpoints; the bridge has "
            f"{num_nodes}")
    return topology


def _budget_vec(active_budget, num_nodes: int, budget: int,
                device) -> torch.Tensor:
    """Per-node rate limiter i64[N] clipped to ``[0, budget]`` (a scalar is
    shared by every node)."""
    if active_budget is None or (not torch.is_tensor(active_budget)
                                 and np.ndim(active_budget) == 0):
        ab = budget if active_budget is None else int(active_budget)
        return torch.full((num_nodes,), min(max(ab, 0), budget),
                          dtype=torch.long, device=device)
    ab = torch.as_tensor(active_budget).to(device=device, dtype=torch.long)
    return torch.broadcast_to(ab, (num_nodes,)).clamp(0, budget)


# ---------------------------------------------------------------------------
# One-device loopback path
# ---------------------------------------------------------------------------

def _loopback_rows(ids: torch.Tensor, table: MemPortTable,
                   program: Optional[RouteProgram], pool_rows: int, tn: int,
                   rounds: int, budget: int, active_budget):
    """Padded requests [..., rounds*budget] -> (flat pool rows i32[N*R],
    the requests' home nodes); the pool is ``tn`` logical nodes of
    ``pool_rows // tn`` slots, node-major."""
    home, slot = table.translate(ids.reshape(-1))
    flat = torch.where(home >= 0, home * (pool_rows // tn) + slot, FREE)
    if active_budget is not None:
        # Rate-limiter parity with the N-node path: round r serves request
        # indices [r*ab, (r+1)*ab), so anything past rounds*ab spills off
        # the end of the round budget and is dropped.
        ab = torch.as_tensor(active_budget, device=ids.device).reshape(-1)[0]
        ab = ab.clamp(0, budget)
        idx = torch.arange(ids.shape[-1], device=ids.device)
        served = torch.broadcast_to(idx < rounds * ab, ids.shape).reshape(-1)
        flat = torch.where(served, flat, FREE)
    if program is not None:
        # Row i is logical requester i: a distance the program does not
        # wire for it is dropped, as on the N-node path.
        rows = ids.reshape(-1, ids.shape[-1])
        flat = torch.where(_ref.served_mask(table, rows, program).reshape(-1),
                           flat, FREE)
    return flat, home


def _pad_requests(ids: torch.Tensor, rounds: int, budget: int):
    pad = rounds * budget - ids.shape[-1]
    if pad:
        ids = torch.cat([ids, ids.new_full(ids.shape[:-1] + (pad,), FREE)], -1)
    return ids, pad


# ---------------------------------------------------------------------------
# Fused N-node engine on a node axis of one device
# ---------------------------------------------------------------------------

def _fused_window(ids: torch.Tensor, rnd: int, ab: torch.Tensor,
                  lanes: int) -> torch.Tensor:
    """Round ``rnd``'s request windows [N, lanes]: node j's window starts at
    ``rnd * ab[j]`` (the pointer advances by the node's own budget); lanes
    past ``ab[j]`` or past the request list carry FREE."""
    length = ids.shape[-1]
    lane = torch.arange(lanes, device=ids.device)[None, :]
    idx = rnd * ab[:, None] + lane
    ok = (lane < ab[:, None]) & (idx < length)
    win = ids.gather(1, idx.clamp(max=length - 1))
    return torch.where(ok, win, FREE)


def _fused_steering(window: torch.Tensor, table: MemPortTable,
                    program: RouteProgram, num_nodes: int):
    """Steer every node's window at once: (home, slot, loopback, remote).

    Requester j's request to ``home`` lies at ring distance
    ``d = (home - j) mod N``; distance 0 is the loopback, and slot ``d - 1``
    serves it iff the program wires that slot for requester j.
    """
    home, slot = table.translate(window)
    me = torch.arange(num_nodes, device=window.device)[:, None]
    dist = steering.ring_distance(home, me, num_nodes)
    k = (dist - 1).clamp(0, num_nodes - 2)
    wired = program.live[k] & (program.rank_epoch[k, me] >= 0)
    return home, slot, dist == 0, (dist >= 1) & wired


def _reassemble(chunks: torch.Tensor, length: int,
                ab: torch.Tensor) -> torch.Tensor:
    """Served round lanes [rounds, N, lanes, *page] -> [N, length, *page].

    Round ``r`` of node j served ``want[j, r*ab[j] + k]`` in lane ``k``
    (``k < ab[j]``); other lanes carried FREE and are dropped.  Lanes add
    into zeros, as the reference's do (a -0.0 element comes back +0.0).
    """
    rounds, n, lanes = chunks.shape[:3]
    page_shape = tuple(chunks.shape[3:])
    dev = chunks.device
    r = torch.arange(rounds, device=dev)[:, None, None]
    k = torch.arange(lanes, device=dev)[None, None, :]
    node = torch.arange(n, device=dev)[None, :, None]
    dest = r * ab[None, :, None] + k
    live = (k < ab[None, :, None]) & (dest < length)
    flat = torch.where(live, node * length + dest, n * length)
    out = chunks.new_zeros((n * length + 1,) + page_shape)
    out.index_add_(0, flat.reshape(-1), chunks.reshape((-1,) + page_shape))
    return out[:-1].view((n, length) + page_shape)


def _pull_operands(window: torch.Tensor, table: MemPortTable,
                   program: RouteProgram, num_nodes: int, ppn: int):
    """One pull round's kernel operands: the send buffer's pool rows
    i32[N, N, lanes] (``[h, j, lane]``: what home h serves for requester
    j's lane, FREE elsewhere), and the commit's choice and loopback slot,
    i32[N, lanes] each."""
    home, slot, loop, remote = _fused_steering(window, table, program,
                                               num_nodes)
    homes = torch.arange(num_nodes, device=window.device)[:, None, None]
    # A slot past the home's pool reads its last row, as the reference's
    # shard-local fetch does.
    rows = home * ppn + slot.clamp(max=ppn - 1)
    serve = (home[None] == homes) & (remote & (slot >= 0))[None]
    send_rows = torch.where(serve, rows[None], FREE).to(torch.int32)
    choice = torch.where(loop, 0, torch.where(remote, home + 1, -1))
    loop_slot = torch.where(loop, slot, FREE)
    return send_rows, choice.to(torch.int32), loop_slot.to(torch.int32)


def _pull_nodes(pool: torch.Tensor, want: torch.Tensor, table: MemPortTable,
                ab: torch.Tensor, program: RouteProgram, *, num_nodes: int,
                budget: int, channels: int, rounds: int) -> torch.Tensor:
    """Fused pull: per round one gather into the a2a send buffer and one
    commit, for all N nodes."""
    ppn = pool.shape[0] // num_nodes
    lanes = channels * -(-budget // channels)
    chunks = []
    for rnd in range(rounds):
        window = _fused_window(want, rnd, ab, lanes)
        send_rows, choice, loop_slot = _pull_operands(window, table, program,
                                                      num_nodes, ppn)
        send = _bg.gather_pages(pool, send_rows)      # [N, N, lanes, *page]
        chunks.append(_bg.pull_commit(pool, send, choice, loop_slot))
    return _reassemble(torch.stack(chunks), want.shape[-1], ab)


def _push_slots(window: torch.Tensor, table: MemPortTable,
                program: RouteProgram, num_nodes: int) -> torch.Tensor:
    """One push round's commit slots i32[N, N, lanes]: row k of home h holds
    the slots requester (h - k) mod N writes there (row 0 the loopback)."""
    home, slot, loop, remote = _fused_steering(window, table, program,
                                               num_nodes)
    homes = torch.arange(num_nodes, device=window.device)[:, None]
    req = torch.remainder(
        homes - torch.arange(num_nodes, device=window.device)[None, :],
        num_nodes)
    mine = (home[req] == homes[..., None]) & (loop | remote)[req]
    return torch.where(mine, slot[req], FREE).to(torch.int32)


def _push_nodes(pool: torch.Tensor, dest: torch.Tensor, payload: torch.Tensor,
                table: MemPortTable, ab: torch.Tensor, program: RouteProgram,
                *, num_nodes: int, budget: int, channels: int,
                rounds: int) -> None:
    """Fused push: per round one in-place commit for all N homes."""
    cb = -(-budget // channels)
    for rnd in range(rounds):
        window = _fused_window(dest, rnd, ab, channels * cb)
        _bg.push_commit(pool, _push_slots(window, table, program, num_nodes),
                        payload, (rnd * ab).to(torch.int32),
                        channels=channels, cb=cb)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _check_nodes(pool_pages: torch.Tensor, ids: torch.Tensor,
                 num_nodes: int, program, table_nodes: int):
    """Shape checks; (the route program, the logical node count of the
    table).  On the loopback path, whose request rows may have any leading
    shape, the program is checked against ``table_nodes`` and stays None
    when none was given (nothing is masked then)."""
    if num_nodes == 1:
        tn = table_nodes or 1
        if program is not None:
            _resolve_program(program, tn, pool_pages.device)
        return program, tn
    if table_nodes and table_nodes != num_nodes:
        raise ValueError(f"table has {table_nodes} nodes but the memory axis "
                         f"has {num_nodes}")
    if num_nodes < 1 or ids.dim() != 2 or ids.shape[0] != num_nodes:
        raise ValueError(f"requests {list(ids.shape)} must be [num_nodes="
                         f"{num_nodes}, R]")
    if pool_pages.shape[0] % num_nodes:
        raise ValueError(f"pool of {pool_pages.shape[0]} pages does not "
                         f"split over {num_nodes} nodes")
    return _resolve_program(program, num_nodes, pool_pages.device), num_nodes


def _telemetry_inputs(ids: torch.Tensor, tenant_ids, max_tenants: int):
    """Check the tenant lane's shape; the static tenant width (0 = the
    default)."""
    if tenant_ids is not None and tuple(tenant_ids.shape) != tuple(ids.shape):
        raise ValueError(f"tenant_ids shape {list(tenant_ids.shape)} != "
                         f"request shape {list(ids.shape)}")
    return max_tenants if max_tenants > 0 else _telemetry.DEFAULT_MAX_TENANTS


def _loopback_telemetry(ids: torch.Tensor, home: torch.Tensor,
                        table: MemPortTable, program: Optional[RouteProgram],
                        tn: int, topology: Optional[Topology], active_budget,
                        budget: int, rounds: int, tenant_ids,
                        max_tenants: int) -> _telemetry.BridgeTelemetry:
    """Counters of the loopback path: row i of the padded requests ``ids``
    (``home``: their home nodes) is logical requester i on a ``tn``-node
    ring, under ``program`` (default: full bidirectional coverage) and
    ``topology`` for ``tn`` nodes; every row shares ``active_budget``'s
    first value, as the loopback rate limiter does."""
    dev = ids.device
    topo = _resolve_topology(topology, tn)
    if active_budget is None or not torch.is_tensor(active_budget):
        ab = torch.full((), budget if active_budget is None
                        else int(np.asarray(active_budget).reshape(-1)[0]),
                        dtype=torch.long, device=dev)
    else:
        ab = active_budget.reshape(-1)[0].to(device=dev, dtype=torch.long)
    rows = ids.reshape(-1, ids.shape[-1])
    if tenant_ids is not None:
        tenant_ids, _ = _pad_requests(tenant_ids.reshape(rows.shape[0], -1),
                                      rounds, budget)
    ring = tn > 1
    return _telemetry.transfer_telemetry(
        rows, table, _resolve_program(program, tn, dev) if ring else None, ab,
        my=torch.arange(rows.shape[0], device=dev), num_nodes=tn,
        budget=budget, rounds=rounds,
        pairs=topo.pair_table(dev) if ring else None, tenant_ids=tenant_ids,
        max_tenants=max_tenants, home=home.reshape(rows.shape))


def _nodes_telemetry(ids: torch.Tensor, table: MemPortTable,
                     program: RouteProgram, topology: Optional[Topology],
                     ab: torch.Tensor, *, num_nodes: int, budget: int,
                     rounds: int, tenant_ids,
                     max_tenants: int) -> _telemetry.BridgeTelemetry:
    """Counters of the N-node engine: one row per ring node."""
    return _telemetry.transfer_telemetry(
        ids, table, program, ab,
        my=torch.arange(num_nodes, device=ids.device), num_nodes=num_nodes,
        budget=budget, rounds=rounds,
        pairs=_resolve_topology(topology, num_nodes).pair_table(ids.device),
        tenant_ids=tenant_ids, max_tenants=max_tenants)


def pull_pages(pool_pages: torch.Tensor, want: torch.Tensor,
               table: MemPortTable, *, num_nodes: int = 1, budget: int = 8,
               channels: int = 1, overprovision: int = 1, active_budget=None,
               program: Optional[RouteProgram] = None,
               table_nodes: int = 0, collect_telemetry: bool = False,
               topology: Optional[Topology] = None,
               tenant_ids: Optional[torch.Tensor] = None,
               max_tenants: int = 0):
    """Pull logical pages through the bridge.

    Args:
      pool_pages: [num_nodes * pages_per_node, *page_shape], node-major.
      want: [num_nodes, R] per-node request lists (logical page ids, FREE
        pad), int32.
      table: memport table.
      num_nodes: size of the memory axis (1 = the loopback path).
      budget: pages per round (static).
      channels: virtual channels per round (static, >= 1); what is served
        does not depend on it.  Ignored on the loopback path.
      overprovision: round-count multiplier (static, >= 1).
      active_budget: runtime rate limiter (int, or a device tensor of one
        value or one per node), clipped to ``[0, budget]``; None serves
        every request.  The loopback path applies its first value.
      program: runtime route program (default: full bidirectional
        coverage); requests whose circuit it does not wire come back as
        zeros.  On the loopback path it is one for ``table_nodes`` nodes,
        and None masks nothing.
      table_nodes: logical node count of the table (0 = ``num_nodes``).  On
        the loopback path the pool may still model several logical memory
        nodes, node-major; with ``num_nodes > 1`` it must equal
        ``num_nodes``.
      collect_telemetry: also return the transfer's
        :class:`~repro_torch.telemetry.counters.BridgeTelemetry` (one row
        per node; on the loopback path one row per request row, on a ring
        of ``table_nodes`` logical nodes).
      topology: the static board + rack fabric the counters classify tiers
        by (default: one flat board), of ``table_nodes`` nodes on the
        loopback path.
      tenant_ids: tenant-id lane of ``want``'s shape, only observed by the
        counters (None = all tenant 0); ignored without
        ``collect_telemetry``.
      max_tenants: static width of the tenant histograms (0 = the default).
    Returns:
      [num_nodes, R, *page_shape] gathered pages (zeros for FREE, spilled,
      unwired and unmapped requests), or ``(pages, telemetry)`` when
      ``collect_telemetry`` is set.
    """
    channels = _resolve_channels(channels)
    max_tenants = _telemetry_inputs(want, tenant_ids, max_tenants)
    program, tn = _check_nodes(pool_pages, want, num_nodes, program,
                               table_nodes)
    r = want.shape[-1]
    rounds = steering.num_rounds(r, budget, overprovision)
    if num_nodes > 1:
        ab = _budget_vec(active_budget, num_nodes, budget, pool_pages.device)
        if rounds == 0:
            out = pool_pages.new_zeros((num_nodes, r) + pool_pages.shape[1:])
        else:
            out = _pull_nodes(pool_pages, want, table, ab, program,
                              num_nodes=num_nodes, budget=budget,
                              channels=channels, rounds=rounds)
        if collect_telemetry:
            return out, _nodes_telemetry(
                want, table, program, topology, ab, num_nodes=num_nodes,
                budget=budget, rounds=rounds, tenant_ids=tenant_ids,
                max_tenants=max_tenants)
        return out
    padded, _ = _pad_requests(want, rounds, budget)
    flat, home = _loopback_rows(padded, table, program, pool_pages.shape[0],
                                tn, rounds, budget, active_budget)
    out = _bg.gather_pages(pool_pages, flat)
    out = out.view(tuple(padded.shape) + tuple(pool_pages.shape[1:]))
    # Trim the round padding on the request dim.
    out = out.narrow(want.dim() - 1, 0, r)
    if collect_telemetry:
        return out, _loopback_telemetry(padded, home, table, program, tn,
                                        topology, active_budget, budget,
                                        rounds, tenant_ids, max_tenants)
    return out


def push_pages(pool_pages: torch.Tensor, dest: torch.Tensor,
               payload: torch.Tensor, table: MemPortTable, *,
               num_nodes: int = 1, budget: int = 8, channels: int = 1,
               overprovision: int = 1, active_budget=None,
               program: Optional[RouteProgram] = None,
               table_nodes: int = 0, collect_telemetry: bool = False,
               topology: Optional[Topology] = None,
               tenant_ids: Optional[torch.Tensor] = None,
               max_tenants: int = 0):
    """Write pages to their homes through the bridge.

    Args as :func:`pull_pages`, plus dest: [num_nodes, R] logical page ids
    each node writes and payload: [num_nodes, R, *page_shape] (cast to the
    pool's dtype).  Writes past ``rounds * active_budget`` spill and drop,
    as do writes over an unwired circuit; among one node's writes to one
    page the last wins (pages have a single writer node).  Where the
    reference donates the pool buffer, the port updates ``pool_pages`` in
    place and returns it, or ``(pool_pages, telemetry)`` with
    ``collect_telemetry``.
    """
    channels = _resolve_channels(channels)
    max_tenants = _telemetry_inputs(dest, tenant_ids, max_tenants)
    program, tn = _check_nodes(pool_pages, dest, num_nodes, program,
                               table_nodes)
    r = dest.shape[-1]
    rounds = steering.num_rounds(r, budget, overprovision)
    if tuple(payload.shape) != tuple(dest.shape) + tuple(pool_pages.shape[1:]):
        raise ValueError(f"payload {list(payload.shape)} does not match "
                         f"dest {list(dest.shape)} pages of "
                         f"{list(pool_pages.shape[1:])}")
    payload = payload.to(pool_pages.dtype)
    if num_nodes > 1:
        ab = _budget_vec(active_budget, num_nodes, budget, pool_pages.device)
        if rounds:
            _push_nodes(pool_pages, dest, payload.contiguous(), table, ab,
                        program, num_nodes=num_nodes, budget=budget,
                        channels=channels, rounds=rounds)
        if collect_telemetry:
            return pool_pages, _nodes_telemetry(
                dest, table, program, topology, ab, num_nodes=num_nodes,
                budget=budget, rounds=rounds, tenant_ids=tenant_ids,
                max_tenants=max_tenants)
        return pool_pages
    padded, pad = _pad_requests(dest, rounds, budget)
    if pad:
        zeros = payload.new_zeros(payload.shape[:1] + (pad,)
                                  + payload.shape[2:])
        payload = torch.cat([payload, zeros], 1)
    flat, home = _loopback_rows(padded, table, program, pool_pages.shape[0],
                                tn, rounds, budget, active_budget)
    flat_pay = payload.reshape((-1,) + tuple(payload.shape[2:]))
    out = _bg.scatter_pages(pool_pages, flat, flat_pay.contiguous())
    if collect_telemetry:
        return out, _loopback_telemetry(padded, home, table, program, tn,
                                        topology, active_budget, budget,
                                        rounds, tenant_ids, max_tenants)
    return out
