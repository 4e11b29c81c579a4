"""The software control plane (paper §2: "deep software-defined support").

The port's copy of ``repro.core.control_plane``: the host-side orchestrator
that owns the logical page space of every pooled region, programs memport
tables at run time, and reacts to infrastructure events:

* region allocation with placement policies (striped / affinity / hashed),
* run-time re-programming that builds nothing (tables are step inputs),
* node-failure handling: pages homed on a dead node are re-homed onto
  survivors and a migration plan is emitted; :func:`execute_plan` carries
  a plan out on the device pool with one gather and one scatter kernel,
* straggler mitigation: step-time telemetry drives per-node rate limits
  (the bridge's ``active_budget``),
* pipeline depth: :meth:`ControlPlane.select_channels` picks the bridge's
  channel count from telemetry-measured wire occupancy — serial until the
  wire is demonstrably busy,
* circuit scheduling: :meth:`ControlPlane.route_program` compiles the
  bridge's run-time :class:`~repro_torch.core.steering.RouteProgram` from
  the live placement table — bidirectional by default, pruned to the ring
  distances that actually carry traffic, rerouted around a failed ring
  link, and **hierarchical** when the pool spans a board + rack
  :class:`~repro_torch.core.topology.Topology` (placement, overflow and
  affinity migration then prefer intra-board homes).

The **closed control loop** (measure -> aggregate -> recompile): the
bridge's in-band counters (``pull_pages`` / ``push_pages`` with
``collect_telemetry=True``) fold into a
:class:`~repro_torch.telemetry.TelemetryAggregator`, and every policy here
can consume the aggregate instead of steering blind —
:meth:`ControlPlane.route_program` ``(telemetry=...)`` compiles a
load-balanced bidirectional program pruned from *measured* traffic;
:meth:`ControlPlane.rate_limits` ``(telemetry=...)`` restores throttled
budgets when observed spills show the limiter dropping real work; and
:meth:`ControlPlane.affinity_migration` re-homes hot pages toward their
dominant requester as :class:`MigrationStep` plans.

Every decision is host numpy, step for step the reference's (the same
``np.random.default_rng(seed)`` draws for ``hashed``), so one sequence of
operations gives bit-identical tables, free lists, plans and programs in
both packages.  Only the outputs live on ``device``: :meth:`table` and the
compiled program are built there, and stay run-time inputs of the bridge.
Telemetry may lie on the card: it is read through
:func:`repro_torch.telemetry.aggregate.to_host`.  With a flight recorder
attached (:meth:`ControlPlane.attach_flight`) every decision is journaled
record for record as the reference journals it, so one sequence of
operations gives both packages the same journal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch.analysis.findings import ProgramVerificationError, errors
from repro_torch.analysis.program_check import check_program
from repro_torch.core import perfmodel, steering
from repro_torch.core.memport import FREE, MemPortTable
from repro_torch.core.steering import to_device, to_numpy
from repro_torch.core.topology import Topology
from repro_torch.kernels import bridge_gather as _bg
from repro_torch.obs import flight as _fl
from repro_torch.telemetry.aggregate import dominant_requester, to_host
from repro_torch.telemetry.counters import BridgeTelemetry

Policy = Literal["striped", "hashed", "affinity"]


def _host_telemetry(telemetry):
    """A raw :class:`~repro_torch.telemetry.counters.BridgeTelemetry`
    copied off the device in one transfer; an aggregator or a plain vector
    as given."""
    if isinstance(telemetry, BridgeTelemetry):
        return to_host(telemetry)
    return telemetry


@dataclass
class Region:
    region_id: int
    name: str
    page_ids: np.ndarray          # logical ids owned by this region
    policy: str


@dataclass
class MigrationStep:
    page_id: int
    old_home: int
    old_slot: int
    new_home: int
    new_slot: int


@dataclass
class NodeState:
    alive: bool = True
    budget: int = 0               # manual rate-limit override; 0 = unlimited
                                  # (use the static/adaptive budget)
    step_times: list = field(default_factory=list)


def plan_rows(plan: list[MigrationStep], pages_per_node: int,
              device) -> torch.Tensor:
    """i32[2, M]: the old and the new node-major pool row of every step of a
    migration plan, uploaded to ``device`` in one copy.

    The steps of a plan are carried out as one parallel move
    (:func:`execute_plan`); a plan that moves a page written by an earlier
    step of its own is refused, since a parallel move would read that page
    before the earlier step wrote it.
    """
    rows = np.array([[s.old_home * pages_per_node + s.old_slot,
                      s.new_home * pages_per_node + s.new_slot]
                     for s in plan], np.int64).reshape(-1, 2)
    written = set()
    for old, new in rows.tolist():
        if old in written:
            raise ValueError(f"the plan moves pool row {old} after writing "
                             "it; carry it out in two plans")
        written.add(new)
    return torch.from_numpy(np.ascontiguousarray(rows.T, np.int32)).to(device)


def execute_plan(pool: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Carry out a migration plan on a node-major pool in place: one
    :func:`~repro_torch.kernels.bridge_gather.gather_pages` of every step's
    old row, then one :func:`~repro_torch.kernels.bridge_gather.
    scatter_pages` into the new rows (``rows`` from :func:`plan_rows`).
    Nothing is read back to the host."""
    if rows.shape[1] == 0:
        return pool
    return _bg.scatter_pages(pool, rows[1], _bg.gather_pages(pool, rows[0]))


class ControlPlane:
    """Owns placement for one pool (num_nodes x pages_per_node slots)."""

    def __init__(self, num_nodes: int, pages_per_node: int,
                 num_logical: int, seed: int = 0,
                 topology: Optional[Topology] = None, *, device="cuda"):
        if topology is not None and topology.num_nodes != num_nodes:
            raise ValueError(f"topology spans {topology.num_nodes} "
                             f"endpoints; the pool has {num_nodes}")
        self.num_nodes = num_nodes
        self.topology = topology or Topology.flat(num_nodes)
        self.pages_per_node = pages_per_node
        self.num_logical = num_logical
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._free: list[list[int]] = [
            list(range(pages_per_node)) for _ in range(num_nodes)]
        self._home = np.full((num_logical,), FREE, np.int64)
        self._slot = np.full((num_logical,), FREE, np.int64)
        self._next_logical = 0
        self._free_logical: list[int] = []   # released ids, recycled first
        self._regions: dict[int, Region] = {}
        self._next_region = 0
        self.nodes = [NodeState() for _ in range(num_nodes)]
        self._failed_link_direction: Optional[int] = None
        self.device = torch.device(device)
        # Optional flight recorder (repro_torch.obs.flight.FlightRecorder).
        self.flight = None

    # -- flight journal --------------------------------------------------------
    def attach_flight(self, recorder) -> None:
        """Journal every subsequent decision into ``recorder``.

        Records a ``cp_init`` genesis carrying the constructor arguments
        *and* a full placement-state snapshot (tables, free lists, RNG
        state, live regions), so a journal attached mid-life still
        replays bit-identically from its own first record.
        """
        self.flight = recorder
        topo = self.topology
        recorder.record(
            "cp_init", num_nodes=self.num_nodes,
            pages_per_node=self.pages_per_node,
            num_logical=self.num_logical, seed=self._seed,
            group_sizes=np.asarray(topo.group_sizes).tolist(),
            topo_hw=[topo.board_hop_us, topo.rack_hop_us,
                     topo.board_link_gbps, topo.rack_link_gbps],
            state=self._state_snapshot())

    def _state_snapshot(self) -> dict:
        return {
            "home": self._home.tolist(),
            "slot": self._slot.tolist(),
            "free": [list(f) for f in self._free],
            "free_logical": list(self._free_logical),
            "next_logical": self._next_logical,
            "next_region": self._next_region,
            "alive": [bool(n.alive) for n in self.nodes],
            "failed_link": self._failed_link_direction,
            "rng_state": self._rng.bit_generator.state,
            "regions": {str(rid): {
                "name": r.name, "policy": r.policy,
                "page_ids": np.asarray(r.page_ids).tolist()}
                for rid, r in self._regions.items()},
        }

    def _journal(self, kind: str, **detail) -> None:
        if self.flight is not None:
            self.flight.record(kind, **detail)

    # -- table export ---------------------------------------------------------
    def table(self) -> MemPortTable:
        """The placement as a memport table on the plane's device (an
        upload that does not wait for the card)."""
        return MemPortTable(home=to_device(self._home.astype(np.int32),
                                           self.device),
                            slot=to_device(self._slot.astype(np.int32),
                                           self.device))

    def free_slots(self, node: int) -> int:
        return len(self._free[node])

    def free_logical(self) -> int:
        """Unclaimed logical page ids (released-and-recycled + never minted).

        The admission-control side of capacity: an allocation needs this
        many ids free *and* enough physical slots (``free_slots``)."""
        return (len(self._free_logical)
                + self.num_logical - self._next_logical)

    @property
    def alive_nodes(self) -> list[int]:
        return [i for i, n in enumerate(self.nodes) if n.alive]

    # -- allocation -----------------------------------------------------------
    def _take_logical(self, num_pages: int) -> np.ndarray:
        """Claim ``num_pages`` logical ids, recycling released ones first.

        ``_next_logical`` alone is monotonic: allocate/release churn (lease
        turnover in the orchestrator) would exhaust the logical space while
        the pool still has free slots.  Released ids return via
        :meth:`release` and are handed out again (lowest first, for
        deterministic placement) before fresh ids are minted.
        """
        fresh = self.num_logical - self._next_logical
        if num_pages > len(self._free_logical) + fresh:
            raise RuntimeError("logical page space exhausted")
        self._free_logical.sort()
        reuse = self._free_logical[:num_pages]
        del self._free_logical[:num_pages]
        n_new = num_pages - len(reuse)
        ids = np.asarray(
            reuse + list(range(self._next_logical,
                               self._next_logical + n_new)), np.int64)
        self._next_logical += n_new
        return ids

    def allocate(self, num_pages: int, name: str = "",
                 policy: Policy = "striped", affinity: int = 0) -> Region:
        alive = self.alive_nodes
        if not alive:
            raise RuntimeError("no alive nodes")
        if policy == "striped":
            homes = [alive[i % len(alive)] for i in range(num_pages)]
        elif policy == "hashed":
            homes = [alive[int(self._rng.integers(len(alive)))]
                     for _ in range(num_pages)]
        elif policy == "affinity":
            if not 0 <= affinity < self.num_nodes:
                raise ValueError(f"affinity node {affinity} out of range")
            homes = [affinity] * num_pages
        else:
            raise ValueError(policy)
        ids = self._take_logical(num_pages)
        for pid, h in zip(ids, homes):
            # A dead affinity target must not home pages even when its free
            # list still has entries (a monitor may mark a node dead without
            # a fail_node remap — its slots are quarantined, not reusable).
            if not self._free[h] or not self.nodes[h].alive:
                # Topology-aware spill: a full/dead home overflows onto its
                # own board first (board-ring traffic instead of rack-ring),
                # then onto the globally emptiest survivor.
                h = max(alive, key=lambda n: (
                    len(self._free[n]) > 0
                    and self.topology.group[n] == self.topology.group[h],
                    len(self._free[n])))
                if not self._free[h]:
                    # Roll the partial allocation back: slots placed so far
                    # return to their free lists, every claimed id is
                    # recycled.
                    for i in ids:
                        if self._home[i] != FREE:
                            self._free[int(self._home[i])].append(
                                int(self._slot[i]))
                            self._home[i] = FREE
                            self._slot[i] = FREE
                        self._free_logical.append(int(i))
                    raise RuntimeError("pool out of slots")
            s = self._free[h].pop(0)
            self._home[pid] = h
            self._slot[pid] = s
        region = Region(self._next_region, name or f"region{self._next_region}",
                        ids, policy)
        self._regions[region.region_id] = region
        self._next_region += 1
        if self.flight is not None:
            self._journal(
                "allocate", num_pages=num_pages, name=region.name,
                policy=policy, affinity=affinity, region_id=region.region_id,
                page_ids=ids.tolist(),
                homes=[int(self._home[i]) for i in ids],
                slots=[int(self._slot[i]) for i in ids])
        return region

    def release(self, region: Region) -> None:
        if region.region_id not in self._regions:
            # Stale handle: the region was already released.  With logical
            # ids recycled on release, acting on a stale handle would free
            # pages now owned by a *different* region (alias two tenants);
            # idempotence here is what makes recycling safe.
            return
        for pid in region.page_ids:
            h, s = int(self._home[pid]), int(self._slot[pid])
            if h == FREE:
                # Unplaced id (defensive): nothing to free.
                continue
            # Slot quarantine: a dead node's slots must not return to its
            # free list (a monitor may mark a node dead before/without a
            # fail_node remap).  revive_node rebuilds the free list from the
            # table, so slots released while the node was down reappear then.
            if self.nodes[h].alive:
                self._free[h].append(s)
            self._home[pid] = FREE
            self._slot[pid] = FREE
            # Logical ids are recycled (lease churn must not exhaust the
            # monotonic id space while the pool has free slots).
            self._free_logical.append(int(pid))
        self._regions.pop(region.region_id, None)
        if self.flight is not None:
            self._journal("release", region_id=region.region_id,
                          page_ids=np.asarray(region.page_ids).tolist())

    # -- failure handling (elastic remap) --------------------------------------
    def fail_node(self, node: int) -> list[MigrationStep]:
        """Mark ``node`` dead; re-home its pages; return the migration plan.

        The *data* on the failed node is gone — the plan's executor decides
        whether the new slots are refilled from a checkpoint shard, from a
        replica, or recomputed (KV pages: sequence is re-prefetched).
        """
        self.nodes[node].alive = False
        survivors = self.alive_nodes
        if not survivors:
            raise RuntimeError("all nodes dead")
        plan: list[MigrationStep] = []
        victims = np.nonzero(self._home == node)[0]
        for i, pid in enumerate(victims):
            h = survivors[i % len(survivors)]
            if not self._free[h]:
                h = max(survivors, key=lambda n: len(self._free[n]))
                if not self._free[h]:
                    raise RuntimeError("survivors out of slots during remap")
            s = self._free[h].pop(0)
            plan.append(MigrationStep(int(pid), node, int(self._slot[pid]),
                                      int(h), int(s)))
            self._home[pid] = h
            self._slot[pid] = s
        # Failed node's slots return to a quarantine (not reusable).
        self._free[node] = []
        self._journal("fail_node", node=node,
                      plan=[[s.page_id, s.old_home, s.old_slot,
                             s.new_home, s.new_slot] for s in plan])
        return plan

    def revive_node(self, node: int) -> None:
        self.nodes[node].alive = True
        self._free[node] = [s for s in range(self.pages_per_node)
                            if not np.any((self._home == node)
                                          & (self._slot == s))]
        self._journal("revive_node", node=node)

    # -- straggler mitigation ---------------------------------------------------
    def record_step_time(self, node: int, seconds: float) -> None:
        t = self.nodes[node].step_times
        t.append(seconds)
        if len(t) > 32:
            del t[:-32]

    def detect_stragglers(self, threshold: float = 1.5) -> list[int]:
        med = np.median([np.mean(n.step_times) for n in self.nodes
                         if n.alive and n.step_times] or [0.0])
        out = []
        for i, n in enumerate(self.nodes):
            if n.alive and n.step_times and np.mean(n.step_times) > threshold * med:
                out.append(i)
        return out

    def rate_limits(self, static_budget: int, threshold: float = 1.5,
                    factor: float = 0.5, telemetry=None) -> np.ndarray:
        """Per-node ``active_budget`` vector for the bridge (runtime input).

        Three layers, weakest to strongest:

        * straggler throttling from step-time telemetry (the static policy);
        * **measured feedback** (``telemetry``: a
          :class:`~repro_torch.telemetry.TelemetryAggregator`): a node whose
          observed spill rate is positive is having real requests dropped by
          the limiter — its budget is restored to ``static_budget``, so one
          measure -> recompile iteration drives spills to zero;
        * a manual per-node override (:attr:`NodeState.budget` > 0) pinned
          by the operator, which wins over both.
        """
        telemetry = _host_telemetry(telemetry)
        budgets = np.full((self.num_nodes,), static_budget, np.int32)
        for i in self.detect_stragglers(threshold):
            budgets[i] = max(1, int(static_budget * factor))
        if telemetry is not None:
            # Key on the LAST measurement's raw spills where available: the
            # EWMA rate only decays and would keep overriding the straggler
            # throttle long after the drops stopped.  A bare BridgeTelemetry
            # (one step's counters) works too via its ``spilled`` field.
            spill = to_numpy(
                telemetry.last_spilled if hasattr(telemetry, "last_spilled")
                else telemetry.spilled).reshape(-1)
            for i in range(min(self.num_nodes, spill.shape[0])):
                if spill[i] > 0:
                    budgets[i] = static_budget
        for i, node in enumerate(self.nodes):
            if node.budget > 0:
                budgets[i] = node.budget
        return budgets

    # -- circuit scheduling ------------------------------------------------------
    def report_link_failure(self, direction: int) -> None:
        """Record a failed directed ring link (from fault telemetry).

        ``direction`` is +1 (a clockwise serdes lane died) or -1.  Any
        circuit in that direction crosses every directed link of the ring,
        so subsequent :meth:`route_program` calls route all traffic the
        other way round.
        """
        if direction not in (1, -1):
            raise ValueError("direction must be +1 or -1")
        self._failed_link_direction = direction
        self._journal("link_failure", direction=direction)

    def clear_link_failure(self) -> None:
        self._failed_link_direction = None
        self._journal("link_clear")

    def live_distances(self, requesters: Optional[list[int]] = None
                       ) -> list[int]:
        """Ring distances that can carry traffic under current placement.

        A distance d is live iff some requester r could address a page homed
        at (r + d) mod N.  ``requesters`` defaults to every mesh rank — a
        failed node loses its *memory*, not its mesh slot: the rank keeps
        issuing bridge requests (the mesh never shrinks), so the distances
        it needs must stay wired or its traffic is silently FREE-masked.
        """
        if requesters is None:
            requesters = range(self.num_nodes)
        homed = set(np.nonzero(self.occupancy() > 0)[0].tolist())
        dists = {(h - r) % self.num_nodes
                 for h in homed for r in requesters}
        return sorted(dists - {0})

    def route_program(self, requesters: Optional[list[int]] = None,
                      bidirectional: bool = True, prune: bool = True,
                      telemetry=None, program: Optional[
                          steering.RouteProgram] = None,
                      verify: bool = True) -> steering.RouteProgram:
        """Compile (or verify-and-install) the bridge's circuit schedule.

        With ``program=None`` the schedule is compiled from placement /
        telemetry (see :meth:`_compile_route_program`); passing a
        hand-constructed :class:`~repro_torch.core.steering.RouteProgram` makes
        this the *install path* for externally built schedules.  Either
        way, ``verify=True`` (the default) runs the static verifier
        (:func:`repro_torch.analysis.program_check.check_program`) against the
        plane's topology and raises
        :class:`~repro_torch.analysis.findings.ProgramVerificationError` — with
        the structured finding list — instead of silently handing the
        datapath a schedule that would drop, double-serve or collide
        traffic.  ``verify=False`` is the escape hatch for callers that
        *want* an unchecked install (benchmarked fault injection).
        """
        compiled = program is None
        telemetry = _host_telemetry(telemetry)
        if compiled:
            program = self._compile_route_program(
                requesters, bidirectional=bidirectional, prune=prune,
                telemetry=telemetry)
        if verify:
            bad = errors(check_program(program, self.topology))
            if bad:
                raise ProgramVerificationError(bad)
        if self.flight is not None:
            snap = (_fl.route_telemetry_snapshot(telemetry)
                    if compiled else None)
            measured = bool(snap is not None and snap["dist"]
                            and sum(snap["dist"]) > 0)
            self._journal(
                "route_program", compiled=compiled,
                requesters=(None if requesters is None
                            else [int(r) for r in requesters]),
                bidirectional=bidirectional, prune=prune, verified=verify,
                variant=_fl.route_variant(
                    compiled=compiled,
                    hierarchical=self.topology.num_groups > 1,
                    failed_link=self._failed_link_direction is not None,
                    bidirectional=bidirectional, measured=measured),
                telemetry=snap, program=_fl.program_to_dict(program),
                digest=_fl.program_digest(program))
        return program

    def _compile_route_program(self, requesters: Optional[list[int]] = None,
                               bidirectional: bool = True, prune: bool = True,
                               telemetry=None) -> steering.RouteProgram:
        """Compile the bridge's run-time circuit schedule (builds nothing).

        Like :meth:`rate_limits`, the result is a *step input*: the
        orchestrator calls this after every placement change / telemetry
        event and feeds the program to ``pull_pages`` / ``push_pages``.
        Combines the policies:

        * bidirectional min(d, N-d) routing (⌊N/2⌋ epochs instead of N-1),
        * pruning of distances with zero homed pages in reach,
        * rerouting around a failed directed ring link (everything drives
          the surviving direction),
        * **measured steering** (``telemetry``: a
          :class:`~repro_torch.telemetry.TelemetryAggregator` or a raw ``[N-1]``
          per-distance load vector): circuit pruning from distances that
          *measurably* carry traffic instead of placement reachability, and
          a load-balanced direction assignment putting each live distance on
          the direction that minimizes the bottleneck direction's bytes
          (``steering.load_balanced_program``).  An empty measurement (no
          traffic observed yet) falls back to the placement-based compile.

        Censorship guard: only served requests are binned by distance, so a
        measurement taken while the limiter spilled (or a previous program
        pruned) requests is blind to the demand it dropped.  While the
        aggregate shows drops, distances are *not* pruned — every distance
        stays wired as a zero-weight free rider of the balanced split —
        and pruning resumes after the first clean (drop-free) measurement.
        """
        n = self.num_nodes
        dev = dict(device=self.device)
        telemetry = _host_telemetry(telemetry)
        w = None
        if telemetry is not None:
            w = to_numpy(telemetry.distance_pages()
                      if hasattr(telemetry, "distance_pages")
                      else telemetry).astype(float).reshape(-1)
            if w.sum() <= 0:
                w = None  # nothing measured yet: steer from placement
        # The guard reads the LAST measurement's raw drops (an aggregator's
        # EWMA decays but never reaches zero); a bare BridgeTelemetry's
        # spilled/pruned are per-step already.
        drops = 0.0
        for names in (("last_spilled", "last_pruned"), ("spilled", "pruned")):
            if telemetry is not None and any(hasattr(telemetry, f)
                                             for f in names):
                drops = sum(float(to_numpy(getattr(telemetry, f)).sum())
                            for f in names if hasattr(telemetry, f))
                break
        measured_prune = prune and drops <= 0
        if (self.topology.num_groups > 1 and bidirectional
                and self._failed_link_direction is None):
            # Board + rack fabric: compile the two-tier schedule (intra-board
            # epochs concurrent across boards, exclusive gateway epochs).
            # The censorship guard applies unchanged: a measurement taken
            # while requests were dropped prunes nothing.  A failed ring
            # link falls through to the flat link-avoiding compile (every
            # circuit of one direction is lost on both tiers alike).
            if w is not None:
                wi = (np.asarray(telemetry.distance_intra_pages(),
                                 float).reshape(-1)
                      if hasattr(telemetry, "distance_intra_pages") else None)
                return steering.hierarchical_program(
                    self.topology, dist_weight=w, prune=measured_prune,
                    intra_weight=wi, **dev)
            if not prune:
                return steering.hierarchical_program(self.topology, **dev)
            return steering.hierarchical_program(
                self.topology, live_distances=self.live_distances(requesters),
                **dev)
        if self._failed_link_direction is not None:
            base = steering.link_avoiding_program(
                n, self._failed_link_direction, **dev)
            if not prune:
                return base
            if w is not None:
                live = ((np.nonzero(w > 0)[0] + 1).tolist() if measured_prune
                        else self.live_distances(requesters))
            else:
                live = self.live_distances(requesters)
            return steering.pruned_program(base, live)
        if w is not None and bidirectional:
            return steering.load_balanced_program(n, w, prune=measured_prune,
                                                  **dev)
        if bidirectional:
            base = steering.bidirectional_program(n, **dev)
        else:
            # bidirectional=False pins one ring direction: honour it even
            # under measured steering (there is nothing to balance), only
            # the pruning side of the measurement applies.
            base = steering.unidirectional_program(n, **dev)
        if not prune:
            return base
        if w is not None and measured_prune:
            return steering.pruned_program(base,
                                           (np.nonzero(w > 0)[0] + 1).tolist())
        return steering.pruned_program(base, self.live_distances(requesters))

    def select_channels(self, budget: int, page_bytes: int, telemetry=None,
                        max_channels: int = 8, program=None,
                        calibrator=None) -> int:
        telemetry = _host_telemetry(telemetry)
        pick = self._select_channels(budget, page_bytes, telemetry,
                                     max_channels, program, calibrator)
        if self.flight is not None:
            self._journal(
                "select_channels", budget=budget, page_bytes=page_bytes,
                max_channels=max_channels,
                telemetry=_fl.wire_telemetry_snapshot(telemetry),
                calibrator=_fl.calibrator_snapshot(calibrator),
                program=(None if program is None
                         else _fl.program_to_dict(program)),
                pick=pick)
        return pick

    def _select_channels(self, budget: int, page_bytes: int, telemetry=None,
                         max_channels: int = 8, program=None,
                         calibrator=None) -> int:
        """Pick the bridge's pipeline depth from measured wire occupancy.

        The pipelined round engine (``pull_pages``/``push_pages``
        ``channels=``) overlaps chunk g+1's request flits with chunk g's
        data flits, hiding min(wire, RTT) behind max(wire, RTT) with
        1/channels of the hidden term left exposed as pipeline fill/drain
        (``perfmodel._overlap_round_us``).  Doubling the depth halves that
        exposure, so the smallest power-of-two depth leaving under ~10 % of
        the round exposed is chosen, capped at ``max_channels`` and the
        lane ``budget`` (a chunk needs at least one lane).

        ``telemetry`` is a :class:`~repro_torch.telemetry.TelemetryAggregator`
        (or one step's raw
        :class:`~repro_torch.telemetry.counters.BridgeTelemetry`, whose
        tensors may lie on the card);
        the measured per-direction wire pages give the round's wire time and
        the deepest measurably-live distance its RTT.  Pass the active
        :class:`~repro_torch.core.steering.RouteProgram` as ``program`` to price
        RTT from the hops each circuit *actually drives*: a unidirectional,
        pruned or load-balanced schedule may route a distance the long way
        round, and the shortest-way fallback would underestimate its RTT —
        keeping the engine serial in exactly the latency-bound regime where
        overlap wins.  With no measurement — or no circuit traffic observed
        — the serial engine (1) is kept: overlap is pure win only once the
        wire is demonstrably busy, and an idle bridge should not pay the
        deeper engine's compiled datapath.

        ``calibrator`` is a fitted
        :class:`~repro_torch.core.perfmodel.Calibrator`
        (ignored until it has enough samples): the wire/RTT terms are then
        priced with the **fitted** hop latency and payload bandwidth, and
        doubling the depth must also beat the fitted per-chunk dispatch
        overhead — the software cost that makes deep pipelines a measured
        loss where dispatch dominates flight time, which the static model
        cannot see.
        """
        hw = perfmodel.DEVICE_HW
        chunk_us = 0.0
        if calibrator is not None and calibrator.fitted:
            hw = calibrator.hw()
            chunk_us = calibrator.chunk_overhead_us
        if telemetry is None or budget < 2:
            return 1
        telemetry = _host_telemetry(telemetry)
        if hasattr(telemetry, "link_pages"):          # TelemetryAggregator
            lp = telemetry.link_pages()
            cw, ccw = float(lp["cw"]), float(lp["ccw"])
            dist = np.asarray(telemetry.distance_pages(), float)
            served = np.asarray(telemetry.served, float)
        else:                                         # raw BridgeTelemetry
            cw = float(telemetry.epoch_cw.sum())
            ccw = float(telemetry.epoch_ccw.sum())
            s = telemetry.slot_served
            dist = s.reshape((-1, s.shape[-1])).sum(0).astype(float)
            served = (telemetry.loopback_served + s.sum(-1)).astype(
                float).reshape(-1)
        busy = max(cw, ccw)
        if busy <= 0 or not (dist > 0).any():
            return 1
        n = self.num_nodes
        live_d = np.nonzero(dist > 0)[0] + 1
        if program is not None:
            # The schedule's real per-slot hop counts (long-way routes pay
            # their full depth), restricted to measurably-loaded live slots.
            hops = np.abs(to_numpy(program.offsets))
            lv = to_numpy(program.live)
            loaded = [d - 1 for d in live_d if lv[d - 1]]
            deepest = int(hops[loaded].max()) if loaded else 0
        else:
            deepest = max(min(int(d), n - int(d)) for d in live_d)
        if deepest == 0:
            return 1
        rtt_us = 2.0 * deepest * hw.hop_latency_us
        # Per-round wire time on the busier direction: the measurement spans
        # however many rounds the busiest requester needed.
        rounds = max(1.0, float(np.ceil(served.max() / max(budget, 1))))
        wire_us = busy / rounds * page_bytes / (hw.link_gbps * 1e9) * 1e6
        hidden, exposed = min(wire_us, rtt_us), max(wire_us, rtt_us)
        if hidden <= 0:
            return 1
        depth = 1
        while depth < min(max_channels, budget):
            # Doubling the depth recovers half the remaining exposure but
            # dispatches ``depth`` more chunks per round; with a fitted
            # calibrator that software cost is known and must be beaten.
            saved = hidden / depth - hidden / (2 * depth)
            if hidden / depth <= 0.1 * exposed or saved <= chunk_us * depth:
                break
            depth *= 2
        return min(depth, budget, max_channels)

    def affinity_migration(self, telemetry, min_share: float = 0.5,
                           limit: Optional[int] = None
                           ) -> list[MigrationStep]:
        """Re-home hot pages toward their dominant requester (measured).

        For every home node whose measured traffic (the aggregator's EWMA
        requester->home matrix) is dominated by one *remote* requester —
        its share of all pages served from that home exceeds ``min_share``
        — pages homed there migrate into the dominant requester's free
        slots, turning circuit traffic into loopback hits.  On a
        hierarchical fabric the migration is topology-aware: once the
        dominant requester itself is full, pages homed on *another board*
        keep moving into the requester's board mates (rack-ring traffic
        becomes board-ring traffic — the next-best home).  The placement
        table is updated (a runtime reprogram, like :meth:`fail_node`) and
        the plan is returned for the executor to copy page contents.
        ``limit`` caps the total moves per call (migration bandwidth).
        """
        telemetry = _host_telemetry(telemetry)
        tm = to_numpy(telemetry.traffic_matrix()
                   if hasattr(telemetry, "traffic_matrix")
                   else telemetry).astype(float)
        if tm.shape != (self.num_nodes, self.num_nodes):
            raise ValueError(f"traffic matrix shape {tm.shape} != "
                             f"({self.num_nodes}, {self.num_nodes})")
        plan: list[MigrationStep] = []
        for h in range(self.num_nodes):
            if limit is not None and len(plan) >= limit:
                break
            # Slot quarantine (symmetric to release()): a dead home is no
            # migration source — its data is gone and its vacated slots must
            # not re-enter the free list.  fail_node owns that path.
            if not self.nodes[h].alive:
                continue
            r, share = dominant_requester(tm, h)
            if r == h or share < min_share:
                continue
            if not self.nodes[r].alive:
                continue
            # Intra-board preference: the requester itself first (loopback),
            # then — only when the page currently lives on a different
            # board — the requester's board mates (rack -> board win).
            group = self.topology.group
            targets = [r]
            if group[h] != group[r]:
                targets += sorted(
                    (m for m in self.alive_nodes
                     if m != r and m != h and group[m] == group[r]),
                    key=lambda m: -len(self._free[m]))
            for pid in np.nonzero(self._home == h)[0]:
                if limit is not None and len(plan) >= limit:
                    break
                t = next((m for m in targets if self._free[m]), None)
                if t is None:
                    break
                s = self._free[t].pop(0)
                plan.append(MigrationStep(int(pid), h, int(self._slot[pid]),
                                          t, s))
                self._free[h].append(int(self._slot[pid]))
                self._home[pid] = t
                self._slot[pid] = s
        if self.flight is not None:
            self._journal(
                "migration", traffic=tm.tolist(), min_share=min_share,
                limit=limit, plan=[[s.page_id, s.old_home, s.old_slot,
                                    s.new_home, s.new_slot] for s in plan])
        return plan

    # -- introspection ----------------------------------------------------------
    def occupancy(self) -> np.ndarray:
        occ = np.zeros((self.num_nodes,), np.int64)
        for h in self._home:
            if h != FREE:
                occ[h] += 1
        return occ

    def describe(self) -> str:
        occ = self.occupancy()
        lines = [f"pool: {self.num_nodes} nodes x {self.pages_per_node} slots"]
        for i, n in enumerate(self.nodes):
            lines.append(
                f"  node {i}: {'up ' if n.alive else 'DOWN'} occ={occ[i]}"
                f" free={len(self._free[i])}")
        return "\n".join(lines)
