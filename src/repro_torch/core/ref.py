"""Oracles for the bridge transfer engine (no engine code).

The port's copy of ``repro.core.ref``'s non-pipelined oracles.
:func:`flat_index` and :func:`served_mask` compute, by direct lookup
through the memport table, where a request lands and whether its circuit
is wired; :func:`pull_pages_ref` and :func:`push_pages_ref` move the pages
by one gather or one indexed write over the global pool (plain tensor code
on any device); :func:`expected_transfer_telemetry` is the oracle of
the measurement plane: a per-request walk in plain Python and numpy,
nothing like the engine's masked sums, that the ``collect_telemetry``
counters of :func:`repro_torch.core.bridge.pull_pages` / ``push_pages``
must match exactly.  It reads the table, the program and the topology on
the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import steering
from repro_torch.core.memport import MemPortTable
from repro_torch.core.steering import RouteProgram, to_numpy
from repro_torch.core.topology import Topology


def flat_index(table: MemPortTable, page_ids: torch.Tensor,
               pages_per_node: int) -> torch.Tensor:
    """logical page -> row in the node-major global pool array (-1 where
    unmapped)."""
    home, slot = table.translate(page_ids)
    flat = home * pages_per_node + slot
    return torch.where((home >= 0) & (slot >= 0), flat, -1)


def served_mask(table: MemPortTable, ids: torch.Tensor,
                program: Optional[RouteProgram]) -> torch.Tensor:
    """bool[num_nodes, R]: is this request's ring distance wired?

    Row i of ``ids`` is node i's request list; distance 0 (the loopback)
    is always wired, other distances only if the program's slot is live
    and its group mask wires it for requester i.  ``program=None`` means
    full coverage.
    """
    if program is None:
        return torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    n = program.num_nodes
    home, _ = table.translate(ids)
    if n == 1:
        return home >= 0
    me = torch.arange(ids.shape[0], device=ids.device)[:, None]
    dist = torch.remainder(home - me, n)
    slot = (dist - 1).clamp(0, n - 2)
    rank = me.clamp(0, n - 1)
    wired = program.live[slot] & (program.rank_epoch[slot, rank] >= 0)
    return torch.where(home >= 0, (dist == 0) | wired, False)


def pull_pages_ref(pool_pages: torch.Tensor, want: torch.Tensor,
                   table: MemPortTable, pages_per_node: int,
                   program: Optional[RouteProgram] = None) -> torch.Tensor:
    """Oracle for :func:`repro_torch.core.bridge.pull_pages`.

    Args:
      pool_pages: [num_nodes * pages_per_node, *page_shape] (global view).
      want: [num_nodes, R] logical ids (FREE-padded).
      program: optional route program; requests whose ring distance has no
        wired circuit come back as zeros.
    Returns: [num_nodes, R, *page_shape].
    """
    flat = flat_index(table, want.reshape(-1), pages_per_node)
    flat = torch.where(served_mask(table, want, program).reshape(-1), flat,
                       -1)
    valid = flat >= 0
    # A row past the pool reads its last row, as JAX's clamped gather does.
    out = pool_pages[torch.where(valid, flat, 0).clamp(
        max=pool_pages.shape[0] - 1).long()]
    out = torch.where(valid.view((-1,) + (1,) * (out.dim() - 1)), out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out.view(tuple(want.shape) + tuple(pool_pages.shape[1:]))


def push_pages_ref(pool_pages: torch.Tensor, dest: torch.Tensor,
                   payload: torch.Tensor, table: MemPortTable,
                   pages_per_node: int,
                   program: Optional[RouteProgram] = None) -> torch.Tensor:
    """Oracle for :func:`repro_torch.core.bridge.push_pages`: a new pool
    with every served write applied; among writes to one page the later one
    (in ``dest``'s row-major order) wins."""
    flat = flat_index(table, dest.reshape(-1), pages_per_node)
    flat = torch.where(served_mask(table, dest, program).reshape(-1), flat,
                       -1)
    rows = pool_pages.shape[0]
    flat = torch.where((flat >= 0) & (flat < rows), flat, rows).long()
    # Keep each page's last write only: a write is dropped when a later one
    # lands on the same row.
    pos = torch.arange(flat.shape[0], device=flat.device)
    last = torch.full((rows + 1,), -1, dtype=torch.long, device=flat.device)
    last.scatter_reduce_(0, flat, pos, reduce="amax")
    keep = (flat < rows) & (last[flat] == pos)
    pay = payload.reshape((-1,) + tuple(payload.shape[2:])).to(
        pool_pages.dtype)
    out = torch.cat([pool_pages, pool_pages[:1]])
    out.index_copy_(0, torch.where(keep, flat, rows), pay)
    return out[:rows]


def rate_limit_mask(num_requests: int, budget: int, active_budget,
                    overprovision: int = 1) -> np.ndarray:
    """bool[num_requests]: which request indices the rate limiter serves.

    Round ``r`` serves indices [r*ab, (r+1)*ab): everything past
    ``rounds * ab`` spills off the (overprovisioned) round budget.
    """
    rounds = steering.num_rounds(num_requests, budget, overprovision)
    ab = int(np.clip(to_numpy(active_budget).reshape(-1)[0], 0, budget))
    return np.arange(num_requests) < rounds * ab


def expected_transfer_telemetry(ids, table: MemPortTable,
                                program: Optional[RouteProgram], *,
                                num_nodes: int, budget: int,
                                active_budget=None, overprovision: int = 1,
                                topology: Optional[Topology] = None,
                                tenant_ids=None, max_tenants: int = 0):
    """Oracle for ``pull_pages`` / ``push_pages`` ``collect_telemetry``.

    Walks every request of every row (row i = requester i) and bins it as
    the bridge must have: rate-limiter spill, loopback hit, pruned-circuit
    drop (whole distance dead or this rank's pairing group-masked), or
    served by its distance's slot at the epoch the program assigns this
    requester.  Per-tier counters follow the topology's realization
    contract; ``topology=None`` means the flat single-board fabric.

    ``active_budget`` may be per-requester ([rows]) or one value shared by
    every row (what the loopback path applies).  ``tenant_ids`` ([rows, r],
    aligned with ``ids``; None = all tenant 0) attributes every outcome to
    its request's tenant, ids clipped into ``[0, max_tenants)``;
    ``max_tenants=0`` uses the default width.  Returns a
    :class:`~repro_torch.telemetry.counters.BridgeTelemetry` of CPU int32
    tensors with [rows, ...] fields.
    """
    from repro_torch.telemetry.counters import (BridgeTelemetry,
                                                DEFAULT_MAX_TENANTS,
                                                num_epoch_bins)

    ids = to_numpy(ids)
    rows, r = ids.shape
    n = num_nodes
    if max_tenants <= 0:
        max_tenants = DEFAULT_MAX_TENANTS
    if tenant_ids is None:
        tenant = np.zeros((rows, r), np.int64)
    else:
        tenant = to_numpy(tenant_ids).astype(np.int64).reshape(rows, r)
    tenant = np.clip(tenant, 0, max_tenants - 1)
    rounds = steering.num_rounds(r, budget, overprovision)
    ab = np.broadcast_to(
        to_numpy(budget if active_budget is None else active_budget)
        .astype(np.int64).reshape(-1), (rows,))
    if program is None:
        program = steering.bidirectional_program(n, device="cpu")
    if topology is None:
        topology = Topology.flat(n)
    live = to_numpy(program.live)
    off = to_numpy(program.offsets)
    rank_epoch = to_numpy(program.rank_epoch)
    home_col = to_numpy(table.home)

    s = max(n - 1, 0)
    e = num_epoch_bins(n)
    slot_served = np.zeros((rows, s), np.int32)
    loopback = np.zeros((rows,), np.int32)
    spilled = np.zeros((rows,), np.int32)
    pruned = np.zeros((rows,), np.int32)
    traffic = np.zeros((rows, n), np.int32)
    epoch_cw = np.zeros((rows, e), np.int32)
    epoch_ccw = np.zeros((rows, e), np.int32)
    slot_intra = np.zeros((rows, s), np.int32)
    tier_hops = np.zeros((rows, 2), np.int32)
    tenant_served = np.zeros((rows, max_tenants), np.int32)
    tenant_spilled = np.zeros((rows, max_tenants), np.int32)
    tenant_pruned = np.zeros((rows, max_tenants), np.int32)
    for i in range(rows):
        lim = rounds * int(np.clip(ab[i], 0, budget))
        for j, pid in enumerate(ids[i]):
            if pid < 0 or home_col[pid] < 0:
                continue  # FREE hole or unmapped page: not a live request
            t = int(tenant[i, j])
            if j >= lim:
                spilled[i] += 1
                tenant_spilled[i, t] += 1
                continue
            h = int(home_col[pid])
            d = (h - i) % n
            if d == 0:
                loopback[i] += 1
                traffic[i, h] += 1
                tenant_served[i, t] += 1
                continue
            if not live[d - 1] or rank_epoch[d - 1, i] < 0:
                pruned[i] += 1
                tenant_pruned[i, t] += 1
                continue
            slot_served[i, d - 1] += 1
            traffic[i, h] += 1
            tenant_served[i, t] += 1
            bins = epoch_cw if off[d - 1] > 0 else epoch_ccw
            bins[i, rank_epoch[d - 1, i]] += 1
            sign = 1 if off[d - 1] > 0 else -1
            if topology.pair_intra(i, h):
                slot_intra[i, d - 1] += 1
            bh, rh = topology.pair_hops(i, h, sign)
            tier_hops[i, 0] += int(bh)
            tier_hops[i, 1] += int(rh)
    return BridgeTelemetry(*(torch.from_numpy(a) for a in (
        slot_served, loopback, spilled, pruned, traffic, epoch_cw, epoch_ccw,
        slot_intra, tier_hops, tenant_served, tenant_spilled,
        tenant_pruned)))
