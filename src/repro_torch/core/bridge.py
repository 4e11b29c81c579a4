"""The bridge transfer engine: the loopback path, the fused N-node engine and
the unfused serial engine.

Ports ``repro.core.bridge.pull_pages`` / ``push_pages``.  Requests pad to
whole rounds of ``budget`` pages with FREE; the runtime rate limiter
``active_budget`` spills what lies past ``rounds * active_budget``; each
request is translated through the :class:`~repro_torch.core.memport.
MemPortTable` to its home node and slot.

* ``num_nodes == 1`` (loopback): the page moves through one
  :func:`~repro_torch.kernels.bridge_gather.gather_pages` or
  :func:`~repro_torch.kernels.bridge_gather.scatter_pages` launch (with
  ``fused=False``, one masked gather or scatter of tensor ops) at the
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

``fused=False`` runs the reference's serial unfused engine instead, as
plain tensor ops with no kernel: per round an epoch-0 loopback gather,
then for each circuit slot one request "ppermute" (a roll of the requests
along the node axis by the slot's distance), one masked gather at the
homes and one data "ppermute" back, for all N nodes at once.  It ignores
``channels``: the reference's pipelined engine (``channels > 1``) overlaps
chunk g+1's request flits with chunk g's data flits across devices, and on
one stream that would only reorder independent tensor ops, with the same
pages and commit order.  The reference's bufferless bridge
(``edge_buffer=False``) also runs its serial engine; the port has no such
argument here: callers that carry it (:mod:`repro_torch.core.kvbridge`)
pass ``fused=False`` for a bufferless transfer.  On the loopback path
``fused=False`` moves the pages by the same masked gather and scatter in
place of the kernels.  Both engines serve the same pages and commit in the
same order, so pages and counters are bit-exact across them.

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
the port's kernels.  The fused engine's "ladder" exchange lowering is not
ported (the port's fused engine runs the "a2a" lowering).
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
# The unfused engine on a node axis of one device (no kernel)
# ---------------------------------------------------------------------------
#
# The reference's ``ppermute(perm=[(j, j + d)])`` lands node ``i - d``'s row
# at node ``i``: on the node axis that is ``torch.roll(x, d, 0)``, and the
# data flits' way back ``torch.roll(x, -d, 0)``.  Each slot of a round is
# one such step for all N nodes; the Python loops run over rounds and
# slots, never over nodes.  One stream runs the steps in program order, so
# the reference's pipelined schedule (``channels > 1``) would only reorder
# independent tensor ops, and its bufferless ``optimization_barrier`` has
# nothing to order: the serial engine stands for all three.

def _page_mask(mask: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """``mask`` [...] broadcast over the page dims of ``pages``."""
    return mask.view(tuple(mask.shape) + (1,) * (pages.dim() - mask.dim()))


def _gather_local(pool: torch.Tensor, slots: torch.Tensor, ppn: int,
                  node=0) -> torch.Tensor:
    """Masked local gather: node ``node``'s pool row ``slot`` per lane
    (``node`` broadcasts against ``slots``); FREE gathers zeros, a slot past
    the node's pages reads its last row, as JAX's clamped gather does."""
    rows = node * ppn + slots.clamp(0, ppn - 1)
    out = pool.index_select(0, rows.reshape(-1)).view(
        tuple(slots.shape) + tuple(pool.shape[1:]))
    return out.masked_fill(~_page_mask(slots >= 0, out), 0)


def _scatter_local(pool: torch.Tensor, slots: torch.Tensor,
                   data: torch.Tensor, ppn: int, node=0) -> None:
    """``pool.at[node * ppn + slots].set(data, mode="drop")`` in place: a
    FREE slot or one past the node's pages drops (it must not land in the
    next node's rows); among lanes that write one row the later lane wins.

    Dropped and shadowed lanes still take part in the one indexed copy,
    each rewriting a row with the bytes that row ends up holding (the first
    kept lane's, or row 0's own when no lane is kept), so no write races
    and nothing is read back to the host."""
    if slots.numel() == 0:
        return
    page = tuple(pool.shape[1:])
    live = (slots >= 0) & (slots < ppn)
    rows = torch.where(live, node * ppn + slots, -1).reshape(-1).long()
    data = data.reshape((-1,) + page)
    w, n_rows = rows.shape[0], pool.shape[0]
    pos = torch.arange(w, device=rows.device)
    dump = torch.where(rows >= 0, rows, n_rows)
    last = torch.full((n_rows + 1,), -1, dtype=torch.long, device=rows.device)
    last.scatter_reduce_(0, dump, pos, reduce="amax")
    keep = (rows >= 0) & (last.index_select(0, dump) == pos)
    first = keep.to(torch.int32).argmax().view(1)
    some = keep.any().view(1)
    fill_row = torch.where(some, rows.index_select(0, first), 0)
    src = torch.cat([data, pool[:1]])
    fill_src = torch.where(some, first, w)
    pool.index_copy_(0, torch.where(keep, rows, fill_row),
                     src.index_select(0, torch.where(keep, pos, fill_src)))


def _slot_serve(dist: torch.Tensor, program: RouteProgram, k: int,
                d: int) -> torch.Tensor:
    """Slot k carries requester j's lane (row j of ``dist`` [N, L]) iff the
    lane lies at the slot's distance ``d`` and the program wires the slot
    for j."""
    return ((dist == d) & program.live[k]
            & (program.rank_epoch[k] >= 0)[:, None])


def _data_window(payload: torch.Tensor, rnd: int, ab: torch.Tensor,
                 lanes: int) -> torch.Tensor:
    """Round ``rnd``'s payload windows [N, lanes, *page]: node j's lane k
    carries ``payload[j, rnd * ab[j] + k]`` (its last page past the list;
    such lanes carry FREE in the request window and drop)."""
    n, length = payload.shape[:2]
    lane = torch.arange(lanes, device=payload.device)[None, :]
    idx = (rnd * ab[:, None] + lane).clamp(max=length - 1)
    node = torch.arange(n, device=payload.device)[:, None]
    return payload[node, idx]


def _round_pull(pool: torch.Tensor, window: torch.Tensor, table: MemPortTable,
                program: RouteProgram, me: torch.Tensor, num_nodes: int,
                ppn: int) -> torch.Tensor:
    """Serve one round's windows [N, L] -> [N, L, *page] (the reference's
    ``_round_pull``): the epoch-0 loopback, then slot after slot."""
    home, slot = table.translate(window)
    dist = steering.ring_distance(home, me, num_nodes)
    out = _gather_local(pool, torch.where(dist == 0, slot, FREE), ppn, me)
    for k, d in enumerate(steering.default_route_schedule(num_nodes)):
        serve = _slot_serve(dist, program, k, d)
        req_at_home = torch.roll(torch.where(serve, slot, FREE), d, 0)
        payload = torch.roll(_gather_local(pool, req_at_home, ppn, me), -d, 0)
        out = torch.where(_page_mask(serve, payload), payload, out)
    return out


def _pull_unfused(pool: torch.Tensor, want: torch.Tensor, table: MemPortTable,
                  ab: torch.Tensor, program: RouteProgram, *, num_nodes: int,
                  budget: int, rounds: int) -> torch.Tensor:
    """The serial engine: :func:`_round_pull` a round."""
    ppn = pool.shape[0] // num_nodes
    me = torch.arange(num_nodes, device=pool.device)[:, None]
    chunks = torch.stack([
        _round_pull(pool, _fused_window(want, rnd, ab, budget), table,
                    program, me, num_nodes, ppn)
        for rnd in range(rounds)])
    return _reassemble(chunks, want.shape[-1], ab)


def _push_unfused(pool: torch.Tensor, dest: torch.Tensor,
                  payload: torch.Tensor, table: MemPortTable,
                  ab: torch.Tensor, program: RouteProgram, *, num_nodes: int,
                  budget: int, rounds: int) -> None:
    """The serial engine (the reference's serial ``_push_local`` body): per
    round the epoch-0 loopback writes, then slot after slot, each slot's
    flits leaving after the previous slot's commit."""
    ppn = pool.shape[0] // num_nodes
    me = torch.arange(num_nodes, device=pool.device)[:, None]
    for rnd in range(rounds):
        home, slot = table.translate(_fused_window(dest, rnd, ab, budget))
        data = _data_window(payload, rnd, ab, budget)
        dist = steering.ring_distance(home, me, num_nodes)
        _scatter_local(pool, torch.where(dist == 0, slot, FREE), data, ppn,
                       me)
        for k, d in enumerate(steering.default_route_schedule(num_nodes)):
            serve = _slot_serve(dist, program, k, d)
            _scatter_local(pool,
                           torch.roll(torch.where(serve, slot, FREE), d, 0),
                           torch.roll(data, d, 0), ppn, me)


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
               max_tenants: int = 0, fused: bool = True):
    """Pull logical pages through the bridge.

    Args:
      pool_pages: [num_nodes * pages_per_node, *page_shape], node-major.
      want: [num_nodes, R] per-node request lists (logical page ids, FREE
        pad), int32.
      table: memport table.
      num_nodes: size of the memory axis (1 = the loopback path).
      budget: pages per round (static).
      channels: virtual channels per round (static, >= 1); what is served
        does not depend on it.  Ignored on the loopback path and by the
        unfused engine.
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
      fused: run the fused engine (the default: its kernels, one gather and
        one commit a round) or, with False, the serial unfused engine,
        which launches no kernel (the reference's unfused, pipelined and
        bufferless engines all land here).  Pages and counters are
        bit-exact either way.  On the loopback path False replaces the
        gather kernel by a masked gather of tensor ops.
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
        elif fused:
            out = _pull_nodes(pool_pages, want, table, ab, program,
                              num_nodes=num_nodes, budget=budget,
                              channels=channels, rounds=rounds)
        else:
            out = _pull_unfused(pool_pages, want, table, ab, program,
                                num_nodes=num_nodes, budget=budget,
                                rounds=rounds)
        if collect_telemetry:
            return out, _nodes_telemetry(
                want, table, program, topology, ab, num_nodes=num_nodes,
                budget=budget, rounds=rounds, tenant_ids=tenant_ids,
                max_tenants=max_tenants)
        return out
    padded, _ = _pad_requests(want, rounds, budget)
    flat, home = _loopback_rows(padded, table, program, pool_pages.shape[0],
                                tn, rounds, budget, active_budget)
    if fused:
        out = _bg.gather_pages(pool_pages, flat)
    else:
        out = _gather_local(pool_pages, flat, pool_pages.shape[0])
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
               max_tenants: int = 0, fused: bool = True):
    """Write pages to their homes through the bridge.

    Args as :func:`pull_pages`, plus dest: [num_nodes, R] logical page ids
    each node writes and payload: [num_nodes, R, *page_shape] (cast to the
    pool's dtype).  Writes past ``rounds * active_budget`` spill and drop,
    as do writes over an unwired circuit; among one node's writes to one
    page the last wins (pages have a single writer node).  Both engines
    commit in the serial engine's order (each round's loopback writes,
    then slot after slot), so the pool comes out the same.  Where the
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
        if rounds and fused:
            _push_nodes(pool_pages, dest, payload.contiguous(), table, ab,
                        program, num_nodes=num_nodes, budget=budget,
                        channels=channels, rounds=rounds)
        elif rounds:
            _push_unfused(pool_pages, dest, payload, table, ab, program,
                          num_nodes=num_nodes, budget=budget, rounds=rounds)
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
    if fused:
        out = _bg.scatter_pages(pool_pages, flat, flat_pay.contiguous())
    else:
        _scatter_local(pool_pages, flat, flat_pay, pool_pages.shape[0])
        out = pool_pages
    if collect_telemetry:
        return out, _loopback_telemetry(padded, home, table, program, tn,
                                        topology, active_budget, budget,
                                        rounds, tenant_ids, max_tenants)
    return out
