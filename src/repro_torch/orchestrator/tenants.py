"""Tenants and leases — who owns the pooled pages, and for how long.

The paper closes by arguing the software-defined bridge "enables datacenter
orchestration tools to manage the disaggregated resource allocation"; this
module is the vocabulary those tools speak.  A :class:`TenantSpec` names a
workload and what it is owed — its QoS class, page quota, weighted budget
share and scheduling priority — and a :class:`Lease` ties a
:class:`~repro_torch.core.control_plane.Region` of pooled pages to a tenant with
a *step-denominated* expiry: the orchestrator's ``step()`` clock (not wall
time) ages leases, so reclamation is deterministic and testable.

Everything here is host-side plain data.  The only value that ever reaches
the device is ``TenantSpec.tenant_id`` — the per-request attribution lane
the datapath bins telemetry by — so registering, resizing or re-weighting
tenants never retraces anything.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.control_plane import Region

#: QoS classes, in scheduling-rank order: interactive windows compose ahead
#: of batch, batch ahead of best-effort, so latency-sensitive requests land
#: in the earliest bridge rounds of every step.
QOS_CLASSES = ("interactive", "batch", "best_effort")


def qos_rank(qos: str) -> int:
    """Composition order of a QoS class (lower = earlier rounds)."""
    return QOS_CLASSES.index(qos)


@dataclass(frozen=True)
class TenantSpec:
    """What one workload is owed by the pool.

    Attributes:
      tenant_id: the datapath attribution id (0 <= id < ``max_tenants``) —
        the value carried in the bridge's per-request tenant lane.
      name: human-readable workload name.
      qos: ``interactive`` | ``batch`` | ``best_effort`` (composition and
        spill order of the weighted-fair scheduler).
      page_quota: max pooled pages the tenant may hold across its leases
        (0 = unlimited) — the admission controller's hard cap.
      share: weighted-fair budget weight (> 0); the scheduler splits each
        bridge round's page budget proportionally.
      priority: tie-break within a QoS class (higher composes earlier).
      slo_round_us: admission SLO — the predicted completion latency (µs)
        of the tenant's per-step window must stay below this, else the
        request queues (0 = no SLO).
    """

    tenant_id: int
    name: str
    qos: str = "batch"
    page_quota: int = 0
    share: float = 1.0
    priority: int = 0
    slo_round_us: float = 0.0

    def __post_init__(self) -> None:
        if self.tenant_id < 0:
            raise ValueError(f"tenant_id must be >= 0, got {self.tenant_id}")
        if self.qos not in QOS_CLASSES:
            raise ValueError(f"qos must be one of {QOS_CLASSES}, "
                             f"got {self.qos!r}")
        if self.share <= 0:
            raise ValueError(f"share must be > 0, got {self.share}")


@dataclass
class Lease:
    """A tenant's claim on one allocated region, aged by the step clock.

    ``expires_step`` is absolute (the orchestrator step at which the lease
    lapses; -1 = never).  An ``auto_renew`` lease is re-armed for another
    ``term`` steps each time it would expire; otherwise expiry releases the
    region back to the control plane (its logical ids recycle) and frees
    capacity for queued admissions.
    """

    lease_id: int
    tenant_id: int
    region: Region
    granted_step: int
    term: int                     # steps per grant (<= 0: never expires)
    auto_renew: bool = False
    renewals: int = field(default=0)

    @property
    def expires_step(self) -> int:
        if self.term <= 0:
            return -1
        return self.granted_step + (self.renewals + 1) * self.term

    @property
    def num_pages(self) -> int:
        return len(self.region.page_ids)

    def expired(self, step: int) -> bool:
        return self.term > 0 and step >= self.expires_step

    def renew(self) -> None:
        self.renewals += 1


def validate_tenants(specs: list[TenantSpec], max_tenants: int) -> None:
    """Raise on duplicate / out-of-range tenant ids."""
    seen: set[int] = set()
    for spec in specs:
        if spec.tenant_id >= max_tenants:
            raise ValueError(
                f"tenant {spec.name!r} id {spec.tenant_id} >= max_tenants "
                f"{max_tenants} (the static telemetry histogram width)")
        if spec.tenant_id in seen:
            raise ValueError(f"duplicate tenant id {spec.tenant_id}")
        seen.add(spec.tenant_id)


def tenant_by_id(specs: list[TenantSpec],
                 tenant_id: int) -> Optional[TenantSpec]:
    for spec in specs:
        if spec.tenant_id == tenant_id:
            return spec
    return None
