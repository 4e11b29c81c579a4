"""repro_torch.obs — tracing, metrics and the decision plane over the
in-band telemetry (the port's copy of ``repro.obs``).

Host-side layers:

- ``clock``: injectable monotonic clocks (wall for production, manual for
  deterministic tests).
- ``trace``: ``TraceRecorder`` wraps datapath calls in fenced wall-clock
  spans (a span waits on the card for the tensors it fences), decorates
  them with the matching ``BridgeTelemetry`` counters, and exports
  Chrome-trace/Perfetto JSON.
- ``metrics``: counter/gauge/log-bucketed-histogram registry with
  per-tenant / per-QoS / per-tier families fed by ``TelemetryAggregator``
  and spans, plus an SLO burn-rate monitor.
- ``flight``: the decision plane — ``FlightRecorder`` journals every
  control-plane action as a typed ``DecisionRecord`` (JSONL in/out) and
  ``replay()`` re-executes a journal bit-identically against a fresh
  control plane; ``why(request_id)`` walks the causal chain behind one
  serving request.
- ``detect``: the ``Sentinel`` — online latency-shift / calibration-drift
  / SLO-burn / telemetry-conservation detectors emitting ``Alert``
  records into the journal and ``obs_alerts_total`` counters.

The measured span latencies feed
``repro_torch.core.perfmodel.Calibrator`` so control-plane decisions run on
fitted, not guessed, constants.  The reference's ``phase_op_counts``
counts XLA HLO instructions per named scope and has no counterpart here.
"""

from repro_torch.obs.clock import Clock, ManualClock, MonotonicClock
from repro_torch.obs.detect import Alert, Sentinel
from repro_torch.obs.flight import (
    DecisionRecord,
    FlightRecorder,
    JournalError,
    JournalTruncatedError,
    ReplayDivergenceError,
    ReplayResult,
    program_digest,
    replay,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    SLOMonitor,
)
from repro_torch.obs.trace import Span, TraceRecorder

__all__ = [
    "Alert",
    "Clock",
    "DecisionRecord",
    "FlightRecorder",
    "JournalError",
    "JournalTruncatedError",
    "ManualClock",
    "MonotonicClock",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ReplayDivergenceError",
    "ReplayResult",
    "SLOMonitor",
    "Sentinel",
    "Span",
    "TraceRecorder",
    "program_digest",
    "replay",
]
