"""The orchestrator facade: multi-tenant QoS-aware control of one pool (the
port's copy of ``repro.orchestrator.orchestrator``).

This is the "datacenter orchestration tool" of the paper's closing claim,
driving every knob the earlier layers made runtime-programmable through one
``step()`` lifecycle:

    register tenants -> lease pages -> schedule windows -> measure -> re-fit

* **Placement** — each tenant anchors to a board (round-robin over the
  :class:`~repro_torch.core.topology.Topology` groups at registration), and its
  leases allocate with board affinity: a tenant's pages cluster on its
  board's local ring, so its traffic stays intra-board and tenants mostly
  do not contend for the rack gateways.
* **Leases** — step-denominated terms; expiry releases the region (logical
  ids recycle through the control plane's free list) or auto-renews, and
  freed capacity immediately drains the admission queue.
* **Admission** — :class:`~repro_torch.orchestrator.admission.AdmissionController`
  rules over live capacity, tenant quota, and the perfmodel-predicted
  completion latency of the tenant's window vs its SLO.
* **Scheduling** — the
  :class:`~repro_torch.orchestrator.scheduler.WeightedFairScheduler` partitions
  the bridge round budget into per-tenant request windows, re-fit every
  ``control_period`` steps from the *measured* per-tenant demand (the
  datapath's tenant-attributed telemetry), interactive unused budget
  spilling to batch.
* **Datapath refresh** — the same control period recompiles the route
  program from measured traffic (``ControlPlane.route_program``), re-picks
  the pipeline depth (``select_channels``) and plans cross-tenant affinity
  migrations (hot pages re-home toward their dominant requester's board).

Every output is a run-time input of the datapath — tables, programs,
budgets, windows, tenant lanes — handed over as tensors on the plane's
device, so a full orchestration cycle builds nothing, and installing them
between steps makes no host sync.  The decisions are host numpy, step for
step the reference's: one sequence of operations gives both packages the
same leases, schedules and flight journal.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import perfmodel
from repro_torch.core.control_plane import ControlPlane, MigrationStep
from repro_torch.core.steering import to_device
from repro_torch.obs.detect import Sentinel
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import MetricsRegistry, SLOMonitor
from repro_torch.orchestrator.admission import (ADMITTED, REJECTED,
                                          AdmissionController,
                                          AdmissionDecision, PendingRequest,
                                          QUEUED)
from repro_torch.orchestrator.scheduler import Schedule, WeightedFairScheduler
from repro_torch.orchestrator.tenants import Lease, TenantSpec, validate_tenants
from repro_torch.telemetry.aggregate import TelemetryAggregator, to_host
from repro_torch.telemetry.counters import DEFAULT_MAX_TENANTS


class Orchestrator:
    """Owns tenancy for one
    :class:`~repro_torch.core.control_plane.ControlPlane`; its device
    outputs live on the plane's device."""

    def __init__(self, control_plane: ControlPlane, *, budget: int = 8,
                 page_bytes: int = 0, channels: int = 1,
                 control_period: int = 4,
                 max_tenants: int = DEFAULT_MAX_TENANTS,
                 default_term: int = 32, queue_limit: int = 64,
                 queue_max_attempts: int = 0, queue_ttl_steps: int = 0,
                 migrate: bool = True, migration_limit: int = 8,
                 alpha: float = 0.25,
                 flight: Optional[FlightRecorder] = None):
        self.cp = control_plane
        self.budget = budget
        self.page_bytes = page_bytes
        self.max_tenants = max_tenants
        self.control_period = max(control_period, 1)
        self.default_term = default_term
        self.migrate = migrate
        self.migration_limit = migration_limit
        self.scheduler = WeightedFairScheduler(budget)
        self.admission = AdmissionController(
            queue_limit, max_attempts=queue_max_attempts,
            ttl_steps=queue_ttl_steps)
        self.telemetry = TelemetryAggregator(
            control_plane.num_nodes, page_bytes=page_bytes, alpha=alpha,
            max_tenants=max_tenants)
        self.specs: Dict[int, TenantSpec] = {}
        self.leases: Dict[int, Lease] = {}
        self.step_count = 0
        self.schedule: Schedule = Schedule(windows={}, order=(),
                                           budget=budget)
        self.channels = channels
        # Observability plane: exact counters + EWMA gauges + span latency
        # histograms (metrics), per-tenant SLO burn rates (slo), and the
        # online perfmodel calibration (measured round latencies -> fitted
        # constants driving select_channels and the admission pricing).
        self.metrics = MetricsRegistry()
        self.slo = SLOMonitor(registry=self.metrics)
        self.calibrator = perfmodel.Calibrator()
        # Decision plane: every control-plane action below journals into
        # the flight recorder (attach records the cp_init genesis, so the
        # initial route-program install is the journal's first decision);
        # the sentinel watches latency/residual/SLO/telemetry for drift.
        self.flight = flight if flight is not None else FlightRecorder()
        control_plane.attach_flight(self.flight)
        self.sentinel = Sentinel(registry=self.metrics, flight=self.flight,
                                 calibrator=self.calibrator, slo=self.slo)
        self._program = control_plane.route_program()
        self._program_stale = False
        self._next_lease = 0
        self._anchor_group: Dict[int, int] = {}   # tenant -> home board
        self._migration_log: List[MigrationStep] = []
        self._last_taken: Dict[int, int] = {}     # last compose consumption

    # -- tenants ---------------------------------------------------------------
    def register(self, spec: TenantSpec) -> TenantSpec:
        """Add a tenant; anchors it to a board and re-fits the schedule."""
        validate_tenants(list(self.specs.values()) + [spec],
                         self.max_tenants)
        self.specs[spec.tenant_id] = spec
        self._anchor_group[spec.tenant_id] = (
            len(self._anchor_group) % self.cp.topology.num_groups)
        self.schedule = self.scheduler.compile(list(self.specs.values()))
        self.flight.record(
            "register", tenant_id=spec.tenant_id, name=spec.name,
            qos=spec.qos, page_quota=spec.page_quota, share=spec.share,
            priority=spec.priority, slo_round_us=spec.slo_round_us,
            anchor_group=self._anchor_group[spec.tenant_id])
        self.flight.record("refit", mode="compile", budget=self.budget,
                           windows=dict(self.schedule.windows))
        return spec

    def held_pages(self, tenant_id: int) -> int:
        return sum(l.num_pages for l in self.leases.values()
                   if l.tenant_id == tenant_id)

    def tenant_leases(self, tenant_id: int) -> List[Lease]:
        return [l for l in self.leases.values()
                if l.tenant_id == tenant_id]

    def _anchor_node(self, tenant_id: int) -> int:
        """The tenant's preferred home: emptiest alive node on its board."""
        group = self._anchor_group.get(tenant_id, 0)
        topo = self.cp.topology
        mates = [n for n in self.cp.alive_nodes if topo.group[n] == group]
        pool = mates or self.cp.alive_nodes
        if not pool:
            raise RuntimeError("no alive nodes")
        return max(pool, key=lambda n: self.cp.free_slots(n))

    # -- admission + leasing ---------------------------------------------------
    def _free_capacity(self) -> Tuple[int, int]:
        slots = sum(self.cp.free_slots(n) for n in self.cp.alive_nodes)
        return slots, self.cp.free_logical()

    def _total_capacity(self) -> Tuple[int, int]:
        """Whole-pool capacity over alive nodes (free or held).

        The REJECT side of admission: a request bigger than this can
        never heal by waiting and must not park in the retry queue.
        """
        slots = len(self.cp.alive_nodes) * self.cp.pages_per_node
        return slots, self.cp.num_logical

    def can_ever_admit(self, tenant_id: int, num_pages: int) -> bool:
        """Whether ``num_pages`` could *ever* be admitted for the tenant.

        Checks only the terminal conditions — tenant quota and whole-pool
        capacity — ignoring current occupancy.  A serving layer uses this
        to shed impossible requests immediately instead of retrying them
        until a TTL fires.
        """
        spec = self.specs[tenant_id]
        if num_pages <= 0:
            return False
        if spec.page_quota > 0 and num_pages > spec.page_quota:
            return False
        total_slots, total_logical = self._total_capacity()
        return num_pages <= min(total_slots, total_logical)

    def predicted_window_us(self, tenant_id: int) -> Optional[float]:
        """perfmodel completion latency of the tenant's per-step window.

        Priced under the *measured* pool load when telemetry exists (each
        live slot's pages per requester-round), worst-case full-budget
        rounds otherwise.  None when the model has no page size to price.
        """
        if self.page_bytes <= 0:
            return None
        window = self.schedule.windows.get(tenant_id, 0) or self.budget
        slot_pages = self._measured_slot_pages()
        topo = (None if self.cp.topology.is_flat else self.cp.topology)
        if self.calibrator.fitted:
            # Price with the fitted constants (including the chunk/base
            # software overheads the static model omits).
            return self.calibrator.predict_transfer_latency_us(
                self.route_program(), self.page_bytes, self.budget, window,
                slot_pages=slot_pages, topology=topo,
                channels=self.channels)
        return perfmodel.predict_transfer_latency_us(
            self.route_program(), self.page_bytes, self.budget, window,
            slot_pages=slot_pages, topology=topo, channels=self.channels)

    def _measured_slot_pages(self):
        """Per-slot pages of one requester-round under the measured load
        (None with no telemetry yet)."""
        if self.telemetry.steps > 0:
            # distance_pages is a per-STEP histogram; one round carries
            # 1/rounds of it (rounds estimated from the busiest requester's
            # measured served pages vs the round budget) — pricing the
            # whole step as one round would overstate the load and starve
            # admission on any multi-round composition.
            rounds = max(1.0, float(np.ceil(
                np.max(self.telemetry.served) / max(self.budget, 1))))
            per_round = np.maximum(
                self.telemetry.distance_pages(), 0.0) / (
                    max(self.cp.num_nodes, 1) * rounds)
            return np.minimum(per_round, self.budget)
        return None

    def observe_round_latency(self, measured_us: float, *,
                              rounds: int = 1) -> float:
        """Feed one fenced span latency (us, ``rounds`` bridge rounds)
        into the calibrator under the currently-measured load.

        This is the measure half of the measure->fit->steer loop: the
        serving layer times its pull/push with a ``TraceRecorder`` span
        and hands the duration here; the next control period's
        ``select_channels`` / window pricing then runs on fitted
        constants.  Returns the calibrator's pre-fit prediction error.
        """
        if self.page_bytes <= 0:
            return 0.0
        topo = (None if self.cp.topology.is_flat else self.cp.topology)
        feats = perfmodel.route_features(
            self.route_program(), self.page_bytes, self.budget,
            rounds=max(rounds, 1), channels=self.channels,
            slot_pages=self._measured_slot_pages(), topology=topo)
        err = self.calibrator.observe(feats, measured_us)
        per_round = measured_us / max(rounds, 1)
        # Sentinel feed: the calibrator's pre-fit prediction for this very
        # sample (measured - err) is the drift reference; only meaningful
        # once the fit has enough samples to be trusted.
        self.sentinel.observe_latency(
            per_round,
            predicted_us=((measured_us - err) / max(rounds, 1)
                          if self.calibrator.fitted else None),
            residual_us=abs(err) if self.calibrator.fitted else None)
        self.metrics.histogram("obs_round_latency_us").record(
            measured_us / max(rounds, 1))
        self.metrics.gauge("calibrator_samples").set(
            self.calibrator.samples)
        self.metrics.gauge("calibrator_abs_error_us").set(abs(err))
        for tid, spec in self.specs.items():
            if spec.slo_round_us > 0:
                self.slo.record(tid, measured_us / max(rounds, 1),
                                spec.slo_round_us)
        return err

    def request_lease(self, tenant_id: int, num_pages: int, *,
                      policy: str = "affinity", term: Optional[int] = None,
                      auto_renew: bool = False, queue: bool = True,
                      request_id: Optional[int] = None
                      ) -> Tuple[AdmissionDecision, Optional[Lease]]:
        """Ask for ``num_pages`` pooled pages under admission control.

        Returns ``(decision, lease)``; the lease is None unless admitted.
        ``queue=True`` parks capacity/SLO-limited requests for retry on
        future steps (lease expiry frees capacity); quota violations always
        reject.  ``request_id`` tags the journaled admission verdict and
        lease grant with the serving request they decide, so
        ``FlightRecorder.why(request_id)`` can reconstruct the chain.
        """
        if tenant_id not in self.specs:
            raise KeyError(f"tenant {tenant_id} not registered")
        spec = self.specs[tenant_id]
        free_slots, free_logical = self._free_capacity()
        total_slots, total_logical = self._total_capacity()
        decision = self.admission.evaluate(
            spec, num_pages, free_slots=free_slots,
            free_logical=free_logical, held_pages=self.held_pages(tenant_id),
            predicted_us=self.predicted_window_us(tenant_id),
            total_slots=total_slots, total_logical=total_logical)
        if decision.status == ADMITTED:
            self._rec_admission(decision, tenant_id, num_pages, request_id)
            lease = self._grant(spec, num_pages, policy, term, auto_renew,
                                request_id=request_id)
            return decision, lease
        if decision.status == QUEUED and queue:
            self._rec_admission(decision, tenant_id, num_pages, request_id)
            return self.admission.enqueue(PendingRequest(
                tenant_id=tenant_id, num_pages=num_pages, policy=policy,
                term=term if term is not None else self.default_term,
                auto_renew=auto_renew, queued_step=self.step_count)), None
        self.admission.rejected_total += 1
        if decision.status == QUEUED:
            # queue=False: a queueable request that was not parked is a
            # rejection — a QUEUED status would promise a retry that will
            # never happen.
            decision = AdmissionDecision(REJECTED, decision.reason)
        self._rec_admission(decision, tenant_id, num_pages, request_id)
        return decision, None

    def _rec_admission(self, decision: AdmissionDecision, tenant_id: int,
                       num_pages: int,
                       request_id: Optional[int] = None) -> None:
        self.flight.record(
            "admission", request_id=request_id, tenant_id=tenant_id,
            num_pages=num_pages, status=decision.status,
            reason=decision.reason)

    def _grant(self, spec: TenantSpec, num_pages: int, policy: str,
               term: Optional[int], auto_renew: bool,
               request_id: Optional[int] = None) -> Lease:
        kw = {}
        if policy == "affinity":
            kw["affinity"] = self._anchor_node(spec.tenant_id)
        region = self.cp.allocate(
            num_pages, name=f"{spec.name}/lease{self._next_lease}",
            policy=policy, **kw)
        lease = Lease(lease_id=self._next_lease, tenant_id=spec.tenant_id,
                      region=region, granted_step=self.step_count,
                      term=term if term is not None else self.default_term,
                      auto_renew=auto_renew)
        self.leases[lease.lease_id] = lease
        self._next_lease += 1
        self.admission.admitted_total += 1
        self.flight.record(
            "lease_grant", request_id=request_id, lease_id=lease.lease_id,
            tenant_id=spec.tenant_id, region_id=region.region_id,
            num_pages=num_pages, policy=policy, term=lease.term,
            auto_renew=auto_renew)
        # Placement changed: the circuit schedule must reach the new pages
        # before the next transfer.  Marked stale and recompiled lazily in
        # route_program() — a step that churns many leases compiles once,
        # not once per lease.
        self._program_stale = True
        return lease

    def release_lease(self, lease: Lease) -> None:
        self.cp.release(lease.region)
        self.leases.pop(lease.lease_id, None)
        self._program_stale = True               # placement changed
        self.flight.record("lease_release", lease_id=lease.lease_id,
                           tenant_id=lease.tenant_id,
                           region_id=lease.region.region_id)

    # -- the step lifecycle ----------------------------------------------------
    def step(self, telemetry=None,
             measured_round_us: Optional[float] = None,
             rounds: int = 1) -> Dict[str, object]:
        """Advance the orchestration clock one serving step.

        Folds the step's measured telemetry, ages leases (expiry reclaims
        or auto-renews), drains the admission queue into freed capacity
        and — every ``control_period`` steps — re-fits the QoS schedule
        from measured per-tenant demand and refreshes the datapath's route
        program / pipeline depth / placement (affinity migration).

        ``measured_round_us`` is the step's fenced datapath span latency
        (``rounds`` bridge rounds' worth): it feeds the perfmodel
        calibrator and the per-tenant SLO burn rates, so the refit half
        of this method steers with fitted constants.

        Returns a report of the actions taken (expired/renewed lease ids,
        granted queued requests, new windows, migration plan).
        """
        self.step_count += 1
        if telemetry is not None:
            # counters on the card come off in one copy, read by every fold
            telemetry = to_host(telemetry)
            self.telemetry.update(telemetry)
            self.metrics.observe_telemetry(
                telemetry, page_bytes=self.page_bytes, specs=self.specs)
            self.metrics.observe_aggregator(self.telemetry)
            self.flight.epoch = self.telemetry.steps
            self.sentinel.check_telemetry(self.telemetry)
        if measured_round_us is not None:
            self.observe_round_latency(measured_round_us, rounds=rounds)
        self.sentinel.check_slo()

        expired, renewed = [], []
        for lease in list(self.leases.values()):
            if lease.expired(self.step_count):
                if lease.auto_renew:
                    lease.renew()
                    renewed.append(lease.lease_id)
                    self.flight.record("lease_renew",
                                       lease_id=lease.lease_id,
                                       tenant_id=lease.tenant_id,
                                       expires_step=lease.expires_step)
                else:
                    self.flight.record("lease_expiry",
                                       lease_id=lease.lease_id,
                                       tenant_id=lease.tenant_id)
                    self.release_lease(lease)
                    expired.append(lease.lease_id)

        # drain() removes every request whose retry is pointless (granted,
        # now-rejected, deregistered tenant); only grants created a lease,
        # so the report derives from the actual lease diff.
        before = set(self.leases)
        self.admission.drain(self._try_admit, step=self.step_count)
        report: Dict[str, object] = {
            "step": self.step_count, "expired": expired, "renewed": renewed,
            "granted": [l.tenant_id for lid, l in self.leases.items()
                        if lid not in before],
            "evicted": [r.tenant_id for r in self.admission.last_evicted],
            "refit": False, "migrations": [],
        }
        for r in self.admission.last_evicted:
            self.flight.record("admission", tenant_id=r.tenant_id,
                               num_pages=r.num_pages, status="EVICTED",
                               reason="queue ttl/attempt limit")
        if self.step_count % self.control_period == 0 and self.specs:
            report["refit"] = True
            if self.telemetry.steps > 0:
                # A tenant whose last composed window was completely
                # consumed may have more backlog hidden behind host-side
                # clipping: let it bid as unbounded.  Consumed on read —
                # a stale take from steps ago must not keep an idle tenant
                # bidding as saturated forever.
                saturated = [tid for tid, got in self._last_taken.items()
                             if got >= self.schedule.windows.get(tid, 0) > 0]
                self._last_taken = {}
                self.schedule = self.scheduler.refit(
                    list(self.specs.values()), self.telemetry,
                    self.cp.num_nodes, saturated=saturated)
                self.flight.record(
                    "refit", mode="telemetry", budget=self.budget,
                    num_nodes=self.cp.num_nodes,
                    demand=np.asarray(self.telemetry.tenant_demand(),
                                      float).tolist(),
                    spilled=np.asarray(self.telemetry.last_tenant_spilled,
                                       float).tolist(),
                    saturated=list(saturated),
                    windows=dict(self.schedule.windows))
                if self._program_stale:
                    # Placement changed this step: the measured compile
                    # would prune the new (not-yet-measured) distances, so
                    # placement reachability wins this period.
                    self._program = self.cp.route_program()
                    self._program_stale = False
                else:
                    self._program = self.cp.route_program(
                        telemetry=self.telemetry)
                if self.page_bytes > 0:
                    self.channels = self.cp.select_channels(
                        self.budget, self.page_bytes,
                        telemetry=self.telemetry, program=self._program,
                        calibrator=self.calibrator)
                    self.metrics.gauge("bridge_selected_channels").set(
                        self.channels)
                if self.migrate:
                    plan = self.cp.affinity_migration(
                        self.telemetry, limit=self.migration_limit)
                    self._migration_log.extend(plan)
                    report["migrations"] = plan
            else:
                self.schedule = self.scheduler.compile(
                    list(self.specs.values()))
                self.flight.record("refit", mode="compile",
                                   budget=self.budget,
                                   windows=dict(self.schedule.windows))
                self._program = self.cp.route_program()
                self._program_stale = False
            report["windows"] = dict(self.schedule.windows)
        self.flight.record(
            "step_report", step=self.step_count, expired=expired,
            renewed=renewed, granted=report["granted"],
            evicted=report["evicted"], refit=report["refit"],
            migrations=len(report["migrations"]))
        return report

    def refit_windows(self, demand: Dict[int, float]) -> Schedule:
        """Re-fit the QoS schedule from serving-layer queue depths.

        The periodic ``step()`` re-fit steers from *datapath* telemetry —
        pages actually moved — which lags the request queues: a tenant
        whose backlog just arrived has moved nothing yet and would bid
        zero.  A request-level front end (the continuous batcher) instead
        hands its live per-tenant queue depths here as the demand signal,
        so the bridge windows track offered load a control period early.
        """
        demand = {tid: max(float(d), 0.0) for tid, d in demand.items()}
        self.schedule = self.scheduler.compile(
            list(self.specs.values()), demand)
        self.flight.record("refit", mode="windows", budget=self.budget,
                           demand={str(k): v for k, v in demand.items()},
                           windows=dict(self.schedule.windows))
        return self.schedule

    def _try_admit(self, req: PendingRequest) -> bool:
        """Queue-drain executor: True removes the request from the queue.

        A queued request that has *become* a rejection (e.g. another lease
        pushed the tenant over quota) is dropped, not retried — waiting
        cannot heal it, and re-queueing forever would poison the queue.
        """
        spec = self.specs.get(req.tenant_id)
        if spec is None:
            return True  # tenant deregistered: drop the request
        free_slots, free_logical = self._free_capacity()
        total_slots, total_logical = self._total_capacity()
        decision = self.admission.evaluate(
            spec, req.num_pages, free_slots=free_slots,
            free_logical=free_logical,
            held_pages=self.held_pages(req.tenant_id),
            predicted_us=self.predicted_window_us(req.tenant_id),
            total_slots=total_slots, total_logical=total_logical)
        if decision.status == QUEUED:
            return False                 # still waiting: keep queued
        if decision.status == REJECTED:
            self.admission.rejected_total += 1
            return True                  # can never heal: drop
        self._grant(spec, req.num_pages, req.policy, req.term,
                    req.auto_renew)
        return True

    # -- datapath inputs -------------------------------------------------------
    def table(self):
        """The memport table, on the plane's device."""
        return self.cp.table()

    def route_program(self):
        if self._program_stale:
            # Recompile from placement reachability, not telemetry — newly
            # placed pages' distances have no measured traffic yet and
            # would be pruned; the periodic re-fit tightens back to
            # measured loads later.
            self._program = self.cp.route_program()
            self._program_stale = False
        return self._program

    def active_budget(self) -> torch.Tensor:
        """i32[num_nodes] per-node round budget, on the plane's device."""
        return to_device(self.schedule.active_budget(self.cp.num_nodes),
                         self.cp.device)

    def compose_requests(self, backlogs) -> tuple:
        """Schedule-ordered (want, tenant_lane, taken) for this step —
        see :meth:`repro_torch.orchestrator.scheduler.Schedule.
        compose_requests`; ``want`` and ``tenant_lane`` are i32 tensors on
        the plane's device.  The take counts are remembered: a window
        consumed in full marks its tenant as possibly-clipped for the next
        re-fit.
        """
        want, lane, taken = self.schedule.compose_requests(
            backlogs, self.cp.num_nodes)
        self._last_taken = dict(taken)
        return (to_device(want, self.cp.device),
                to_device(lane, self.cp.device), taken)

    # -- introspection ---------------------------------------------------------
    def dump_debug_bundle(self, path: str, trace=None) -> str:
        """Write one postmortem archive: journal + trace + metrics + state.

        The zip holds ``journal.jsonl`` (the flight journal —
        ``repro_torch.obs.replay()`` re-executes it), ``trace.json`` (Perfetto
        Chrome-trace of ``trace`` or the journal's attached recorder, when
        either exists), ``metrics.txt`` (Prometheus exposition) and
        ``describe.txt`` (orchestrator + pool state).  Returns ``path``.
        """
        import zipfile

        trace = trace if trace is not None else self.flight.trace
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("journal.jsonl", self.flight.to_jsonl())
            if trace is not None:
                z.writestr("trace.json", trace.to_json(indent=1))
            z.writestr("metrics.txt", self.metrics.to_text() + "\n")
            z.writestr("describe.txt", self.describe() + "\n")
        return path

    def describe(self) -> str:
        """Mirror of :meth:`ControlPlane.describe` for the tenancy layer."""
        lines = [f"orchestrator: step {self.step_count}, "
                 f"{len(self.specs)} tenants, {len(self.leases)} leases, "
                 f"budget {self.budget} "
                 f"(window {self.schedule.total_window}), "
                 f"channels {self.channels}"]
        for tid in sorted(self.specs):
            s = self.specs[tid]
            held = self.held_pages(tid)
            quota = s.page_quota if s.page_quota > 0 else "inf"
            lines.append(
                f"  tenant {tid} {s.name!r}: {s.qos} share={s.share:g} "
                f"window={self.schedule.windows.get(tid, 0)} "
                f"pages={held}/{quota} board={self._anchor_group[tid]}")
        for lid in sorted(self.leases):
            l = self.leases[lid]
            exp = ("never" if l.expires_step < 0
                   else f"step {l.expires_step}"
                        + (" (auto-renew)" if l.auto_renew else ""))
            lines.append(f"  lease {lid}: tenant {l.tenant_id} "
                         f"{l.num_pages} pages, expires {exp}")
        lines.append("  " + self.admission.describe())
        if self.calibrator.samples:
            c = self.calibrator.constants()
            lines.append(
                f"  calibrator: {c['samples']} samples, "
                f"hop {c['board_hop_rtts']:.3g}us, "
                f"link {c['link_payload_gbps']:.3g}GB/s, "
                f"chunk {self.calibrator.chunk_overhead_us:.3g}us, "
                f"base {self.calibrator.base_overhead_us:.3g}us"
                + ("" if self.calibrator.fitted else " (warming up)"))
        for tid, slo in self.slo.describe().items():
            lines.append(f"  slo tenant {tid}: burn {slo['burn_rate']:g} "
                         f"({slo['violations']}/{slo['samples']} over "
                         f"{slo['slo_us']:g}us)")
        snap = self.metrics.snapshot()
        if any(snap.values()):
            lines.append("  metrics:")
            lines.extend("    " + ln
                         for ln in self.metrics.to_text().splitlines())
        lines.append(self.cp.describe())
        return "\n".join(lines)
