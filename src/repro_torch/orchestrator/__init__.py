"""repro_torch.orchestrator — multi-tenant, QoS-aware orchestration of the
pool (the port's copy of ``repro.orchestrator``).

Tenants (:mod:`~repro_torch.orchestrator.tenants`), admission control
(:mod:`~repro_torch.orchestrator.admission`), weighted-fair QoS scheduling
(:mod:`~repro_torch.orchestrator.scheduler`) and the facade driving the
:class:`~repro_torch.core.control_plane.ControlPlane` through a measure ->
re-fit ``step()`` lifecycle (:mod:`~repro_torch.orchestrator.orchestrator`).
"""
from repro_torch.orchestrator.admission import (ADMITTED, QUEUED, REJECTED,
                                                AdmissionController,
                                                AdmissionDecision,
                                                PendingRequest)
from repro_torch.orchestrator.orchestrator import Orchestrator
from repro_torch.orchestrator.scheduler import (Schedule,
                                                WeightedFairScheduler,
                                                water_fill)
from repro_torch.orchestrator.tenants import (QOS_CLASSES, Lease, TenantSpec,
                                              qos_rank, validate_tenants)

__all__ = [
    "ADMITTED", "QUEUED", "REJECTED", "AdmissionController",
    "AdmissionDecision", "PendingRequest", "Orchestrator", "Schedule",
    "WeightedFairScheduler", "water_fill", "QOS_CLASSES", "Lease",
    "TenantSpec", "qos_rank", "validate_tenants",
]
