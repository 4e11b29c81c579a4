"""Admission control: admit, queue or reject lease requests.

DDC-style disaggregated orchestration stands or falls on what it lets in:
an admitted lease consumes pooled slots for its whole term, so the decision
folds three signals —

* **capacity** — free slots across alive nodes (a full pool queues the
  request until lease expiry frees space; the orchestrator drains the queue
  on every ``step()``),
* **quota** — the tenant's ``page_quota`` across all its held leases (a
  quota violation can never heal by waiting, so it rejects outright),
* **SLO** — the :mod:`repro_torch.core.perfmodel`-predicted completion latency of
  the tenant's per-step window under the *measured* pool load
  (``perfmodel.predict_transfer_latency_us``); a pool too busy to meet the
  tenant's ``slo_round_us`` queues the request rather than admitting a
  lease the fabric cannot serve.

Decisions are pure data (:class:`AdmissionDecision`); the controller never
allocates — the orchestrator owns the control plane and executes admitted
requests, so this module stays independently testable.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.orchestrator.tenants import TenantSpec

ADMITTED = "admitted"
QUEUED = "queued"
REJECTED = "rejected"


@dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of one lease request."""

    status: str                  # admitted | queued | rejected
    reason: str = ""

    @property
    def admitted(self) -> bool:
        return self.status == ADMITTED


@dataclass
class PendingRequest:
    """A queued lease request, retried on every orchestrator step."""

    tenant_id: int
    num_pages: int
    policy: str = "affinity"
    term: int = 0
    auto_renew: bool = False
    queued_step: int = 0
    attempts: int = field(default=0)


class AdmissionController:
    """Stateless decision rules + a FIFO retry queue for deferred requests.

    ``max_attempts`` / ``ttl_steps`` bound how long a queued request may
    keep retrying (0 = unbounded): a request that outlives either bound is
    *evicted* from the FIFO on the next :meth:`drain` and counted as a
    rejection.  Without the bound, a request the pool can satisfy in
    principle but never does in practice (e.g. held capacity that never
    frees) parks in the FIFO forever and the serving layer's admission
    loop livelocks on it.
    """

    def __init__(self, queue_limit: int = 64, max_attempts: int = 0,
                 ttl_steps: int = 0):
        if queue_limit < 0:
            raise ValueError("queue_limit must be >= 0")
        if max_attempts < 0 or ttl_steps < 0:
            raise ValueError("max_attempts/ttl_steps must be >= 0")
        self.queue_limit = queue_limit
        self.max_attempts = max_attempts
        self.ttl_steps = ttl_steps
        self.pending: deque[PendingRequest] = deque()
        self.admitted_total = 0
        self.rejected_total = 0
        self.evicted_total = 0
        self.last_evicted: list[PendingRequest] = []

    # -- decision rules --------------------------------------------------------
    def evaluate(self, spec: TenantSpec, num_pages: int, *,
                 free_slots: int, free_logical: int, held_pages: int,
                 predicted_us: Optional[float] = None,
                 total_slots: Optional[int] = None,
                 total_logical: Optional[int] = None) -> AdmissionDecision:
        """Decide one request against the current pool state.

        Args:
          num_pages: pages the lease would pin.
          free_slots: free physical slots across alive nodes.
          free_logical: unclaimed logical page ids (recycled + fresh).
          held_pages: pages the tenant already holds across its leases.
          predicted_us: perfmodel-predicted completion latency of the
            tenant's per-step window if admitted (None = not modeled).
          total_slots: physical slots across *alive* nodes, free or held
            (None = unknown).  A request larger than the whole alive pool
            can never heal by waiting — it REJECTS instead of queueing,
            where it would retry in the FIFO forever.
          total_logical: the pool's whole logical id space (same rule).
        """
        if num_pages <= 0:
            return AdmissionDecision(REJECTED, "empty request")
        if spec.page_quota > 0 and held_pages + num_pages > spec.page_quota:
            # Waiting cannot heal a quota violation: reject, don't queue.
            return AdmissionDecision(
                REJECTED, f"quota: holds {held_pages} + {num_pages} > "
                          f"{spec.page_quota}")
        if total_slots is not None and num_pages > total_slots:
            return AdmissionDecision(
                REJECTED, f"capacity: {num_pages} pages exceeds the whole "
                          f"alive pool ({total_slots} slots)")
        if total_logical is not None and num_pages > total_logical:
            return AdmissionDecision(
                REJECTED, f"capacity: {num_pages} pages exceeds the "
                          f"logical id space ({total_logical})")
        if num_pages > free_slots:
            return AdmissionDecision(
                QUEUED, f"capacity: {num_pages} > {free_slots} free slots")
        if num_pages > free_logical:
            return AdmissionDecision(
                QUEUED, f"capacity: {num_pages} > {free_logical} free "
                        f"logical ids")
        if (spec.slo_round_us > 0 and predicted_us is not None
                and predicted_us > spec.slo_round_us):
            return AdmissionDecision(
                QUEUED, f"slo: predicted {predicted_us:.1f}us > "
                        f"{spec.slo_round_us:.1f}us")
        return AdmissionDecision(ADMITTED)

    # -- deferred-request queue ------------------------------------------------
    def enqueue(self, req: PendingRequest) -> AdmissionDecision:
        if len(self.pending) >= self.queue_limit:
            self.rejected_total += 1
            return AdmissionDecision(
                REJECTED, f"queue full ({self.queue_limit})")
        self.pending.append(req)
        return AdmissionDecision(QUEUED, "waiting for capacity")

    def drain(self, try_admit,
              step: Optional[int] = None) -> list[PendingRequest]:
        """Retry every queued request once, FIFO; return the admitted ones.

        ``try_admit(req) -> bool`` is the orchestrator's executor (evaluate
        against fresh state, allocate on admit).  Requests that still fail
        re-queue in order, so a starved head-of-line request keeps its
        place — unless it has exhausted ``max_attempts`` retries or (with
        ``step`` given) outlived ``ttl_steps`` since it was queued, in
        which case it is evicted and counted as rejected
        (``last_evicted`` holds this drain's evictions).
        """
        granted: list[PendingRequest] = []
        self.last_evicted = []
        for _ in range(len(self.pending)):
            req = self.pending.popleft()
            if (self.max_attempts > 0
                    and req.attempts >= self.max_attempts) or \
                    (self.ttl_steps > 0 and step is not None
                     and step - req.queued_step > self.ttl_steps):
                self.rejected_total += 1
                self.evicted_total += 1
                self.last_evicted.append(req)
                continue
            req.attempts += 1
            if try_admit(req):
                granted.append(req)
            else:
                self.pending.append(req)
        return granted

    def describe(self) -> str:
        return (f"admission: {self.admitted_total} admitted, "
                f"{self.rejected_total} rejected "
                f"({self.evicted_total} evicted), "
                f"{len(self.pending)} queued")
