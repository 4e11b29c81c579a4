"""Weighted-fair, work-conserving partition of the bridge round budget.

The bridge rate-limits every node to ``budget`` pages per round
(``active_budget`` lanes live at runtime).  With several tenants sharing the
pool, *whose* requests fill those lanes is the QoS policy: this module
compiles tenant shares into the two knobs the datapath already consumes —

* a per-tenant **request window** (pages per node per step): each step's
  request list is the concatenation of the tenants' windows, interactive
  classes first, so latency-sensitive requests land in the earliest bridge
  rounds while a batch tenant's backlog is clipped to its window instead of
  flooding the round budget (the noisy-neighbour cure);
* the per-node **active_budget** (the sum of the windows), handed straight
  to ``pull_pages`` / ``push_pages``.

The split is weighted-fair with work conservation by water-filling: each
tenant's fair share is ``budget * share / sum(shares)``, but a tenant whose
*measured demand* (telemetry: last step's served + spilled pages) is below
its share only gets its demand — the surplus re-splits among the still-
hungry tenants, so unused interactive budget spills to batch and the wire
never idles while anyone has work.  Shares, windows and the composed
request/tenant lanes are all runtime values: a re-fit never retraces.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.memport import FREE
from repro_torch.orchestrator.tenants import TenantSpec, qos_rank


@dataclass(frozen=True)
class Schedule:
    """One control period's compiled budget partition.

    Attributes:
      windows: tenant_id -> pages per node per step (its request window).
      order: tenant ids in composition order (interactive first).
      budget: the bridge round budget the windows partition.
    """

    windows: Dict[int, int]
    order: tuple
    budget: int

    @property
    def total_window(self) -> int:
        return int(sum(self.windows.values()))

    def active_budget(self, num_nodes: int) -> np.ndarray:
        """Per-node ``active_budget`` vector for the bridge (runtime input)."""
        return np.full((num_nodes,), min(self.total_window, self.budget),
                       np.int32)

    def compose_requests(self, backlogs: Dict[int, Sequence[Sequence[int]]],
                         num_nodes: int
                         ) -> tuple[np.ndarray, np.ndarray, Dict[int, int]]:
        """Fill each tenant's window from its per-node backlog queues.

        Args:
          backlogs: tenant_id -> per-node queues of logical page ids (only
            the front ``window`` entries of each are consumed — pop them
            after the transfer using the returned take counts).
        Returns:
          (want [num_nodes, W], tenant_lane [num_nodes, W], taken) where
          ``W == total_window``; unused lanes are FREE (tenant lane 0 —
          FREE requests are never live, so attribution ignores them) and
          ``taken[tid]`` is the max pages consumed from any node's queue.
        """
        w = self.total_window
        want = np.full((num_nodes, max(w, 1)), FREE, np.int32)
        lane = np.zeros((num_nodes, max(w, 1)), np.int32)
        taken: Dict[int, int] = {}
        at = 0
        for tid in self.order:
            win = self.windows.get(tid, 0)
            if win <= 0:
                continue
            rows = backlogs.get(tid, [])
            got = 0
            for node in range(min(num_nodes, len(rows))):
                head = list(rows[node])[:win]
                want[node, at: at + len(head)] = head
                # Tag only the filled prefix: lanes past len(head) stay FREE
                # and must keep tenant lane 0 (the docstring contract) so
                # composed lanes reconcile with per-tenant telemetry
                # attribution without phantom tenant tags on dead lanes.
                lane[node, at: at + len(head)] = tid
                got = max(got, len(head))
            taken[tid] = got
            at += win
        return want[:, :max(w, 1)], lane[:, :max(w, 1)], taken


def water_fill(shares: np.ndarray, demand: np.ndarray,
               budget: int) -> np.ndarray:
    """Weighted-fair split of ``budget`` with demand caps (work conserving).

    Repeatedly splits the unassigned budget among still-hungry tenants in
    proportion to their shares; a tenant capped by its demand frees its
    surplus for the next pass.  Terminates when every tenant is satisfied
    or the budget is exhausted.  Returns real-valued allocations.

    A zero *effective* weight vector (every still-hungry tenant has share
    0 — e.g. shares zeroed by an operator override) falls back to an even
    split among the hungry tenants instead of dividing by zero: NaN
    allocations would otherwise propagate straight into compiled windows.
    Negative shares are clipped to zero.
    """
    n = shares.shape[0]
    shares = np.maximum(np.asarray(shares, float), 0.0)
    alloc = np.zeros((n,))
    remaining = float(budget)
    hungry = demand > 0
    while remaining > 1e-9 and hungry.any():
        w = shares * hungry
        if w.sum() <= 0.0:
            # Zero effective weight: even split keeps the fill NaN-free.
            w = hungry.astype(float)
        fair = remaining * w / w.sum()
        grant = np.minimum(fair, demand - alloc)
        alloc += grant
        remaining -= grant.sum()
        newly_full = hungry & (demand - alloc <= 1e-9)
        if not newly_full.any():
            break  # nobody capped: the whole remainder was dealt fairly
        hungry &= ~newly_full
    return alloc


def _largest_remainder(alloc: np.ndarray, demand: np.ndarray,
                       budget: int) -> np.ndarray:
    """Round real allocations to integers without exceeding the budget."""
    floors = np.floor(alloc).astype(np.int64)
    spare = min(budget, int(np.ceil(alloc.sum() - 1e-9))) - floors.sum()
    if spare > 0:
        frac = alloc - floors
        room = np.minimum(np.ceil(demand), budget) - floors
        order = np.argsort(-frac, kind="stable")
        for i in order:
            if spare <= 0:
                break
            if frac[i] > 1e-9 and room[i] > 0:
                floors[i] += 1
                spare -= 1
    return floors


class WeightedFairScheduler:
    """Compiles tenant specs + measured demand into a :class:`Schedule`."""

    def __init__(self, budget: int):
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        self.budget = budget

    def compile(self, specs: Sequence[TenantSpec],
                demand: Optional[Dict[int, float]] = None) -> Schedule:
        """Partition the round budget across ``specs``.

        Args:
          demand: tenant_id -> measured offered pages per node per step
            (e.g. ``TelemetryAggregator.tenant_demand()`` normalized per
            node).  None (or a missing tenant) means unknown — treated as
            unbounded, so the tenant gets its full weighted-fair share.
        """
        if not specs:
            return Schedule(windows={}, order=(), budget=self.budget)
        order = tuple(s.tenant_id for s in sorted(
            specs, key=lambda s: (qos_rank(s.qos), -s.priority, s.tenant_id)))
        shares = np.asarray([s.share for s in specs], float)
        dem = np.asarray([
            float("inf") if demand is None
            or demand.get(s.tenant_id) is None
            else max(float(demand[s.tenant_id]), 0.0) for s in specs])
        alloc = water_fill(shares, dem, self.budget)
        windows = _largest_remainder(alloc, dem, self.budget)
        # Work conservation floor: a hungry tenant never rounds to zero
        # while the budget has unassigned lanes.
        spare = self.budget - int(windows.sum())
        for i in np.argsort([qos_rank(s.qos) for s in specs], kind="stable"):
            if spare <= 0:
                break
            if windows[i] == 0 and dem[i] > 0:
                windows[i] += 1
                spare -= 1
        return Schedule(
            windows={s.tenant_id: int(w) for s, w in zip(specs, windows)},
            order=order, budget=self.budget)

    def refit(self, specs: Sequence[TenantSpec], telemetry,
              num_nodes: int, saturated: Sequence[int] = ()) -> Schedule:
        """Re-compile from a :class:`~repro_torch.telemetry.TelemetryAggregator`.

        Uses the aggregator's raw last-step per-tenant demand (served +
        spilled, the offered load under the current split) normalized per
        node.  A tenant whose demand was *clipped* by its current window
        may want more: any tenant that spilled — or whose id is in
        ``saturated`` (the orchestrator passes tenants whose composed
        window was completely filled, i.e. host-side clipping may have
        hidden further backlog) — is treated as unbounded so the next
        split lets it bid for the spare budget.

        Measured demand is floored at one page per node: a tenant that
        offered nothing this period keeps one lane's worth of bid.
        Treating a zero measurement as a hard cap would be a livelock — a
        zero window serves nothing, so the next measurement is zero again
        and the window can never reopen.
        """
        dem = np.asarray(telemetry.tenant_demand(), float) / max(num_nodes, 1)
        spilled = np.asarray(telemetry.last_tenant_spilled, float)
        demand: Dict[int, float] = {}
        for s in specs:
            if s.tenant_id < dem.shape[0]:
                if (spilled[s.tenant_id] > 0
                        or s.tenant_id in saturated):
                    demand[s.tenant_id] = float("inf")  # clipped: wants more
                else:
                    demand[s.tenant_id] = max(float(dem[s.tenant_id]), 1.0)
        return self.compile(specs, demand)
