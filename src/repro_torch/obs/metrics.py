"""Metrics registry: counters, gauges, log-bucketed histograms, SLOs (the
port's copy of ``repro.obs.metrics``).

Host-side numpy; counters on the card come off in one copy a transfer.
Families follow a Prometheus-like naming scheme — ``bridge_*`` for
datapath counters fed from
:class:`~repro_torch.telemetry.counters.BridgeTelemetry`, ``obs_*`` for
span latencies, labels for per-tenant / per-QoS-class / per-tier /
per-link breakdowns:

    bridge_pages_served_total                    counter
    bridge_wire_pages_total{direction="cw"}      counter
    bridge_tier_hop_pages_total{tier="rack"}     counter
    bridge_tenant_pages_total{tenant="1",qos="interactive"}
    bridge_link_utilization{link="3"}            gauge (EWMA view)
    obs_span_latency_us{cat="round",name="pull"} histogram -> p50/p99

Histograms are log-bucketed (powers of ``growth`` from ``lo``), so one
static 32-bucket array spans 0.1 us .. ~3 min with bounded relative
error; quantiles interpolate geometrically inside the landing bucket.

:class:`SLOMonitor` tracks per-tenant round latencies against
``TenantSpec.slo_round_us`` and reports error-budget **burn rates**:
observed violation fraction over the window divided by the budgeted
violation fraction (burn > 1 means the tenant is eating budget faster
than sustainable).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.telemetry.aggregate import to_host

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Mapping[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus exposition escaping: backslash, double-quote, newline."""
    return (v.replace("\\", "\\\\")
             .replace('"', '\\"')
             .replace("\n", "\\n"))


def _render(name: str, key: LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return f"{name}{{{inner}}}"


@dataclass
class Counter:
    """Monotonically increasing count (pages, bytes, events)."""

    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v


@dataclass
class Gauge:
    """Point-in-time value (utilizations, EWMA views, picks)."""

    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


@dataclass
class Histogram:
    """Log-bucketed histogram with geometric quantile interpolation.

    Bucket ``i`` holds values in ``[lo*growth**(i-1), lo*growth**i)``;
    bucket 0 is the underflow bin ``[0, lo)``.  Values above the last
    bound land in the overflow bin and quantiles clamp to the top bound.
    """

    lo: float = 0.1
    growth: float = 2.0
    num_buckets: int = 32
    counts: np.ndarray = field(default=None)  # type: ignore[assignment]
    total: float = 0.0
    count: int = 0

    def __post_init__(self):
        if self.counts is None:
            self.counts = np.zeros(self.num_buckets + 1, np.int64)
        self.bounds = self.lo * self.growth ** np.arange(self.num_buckets)

    def record(self, v: float) -> None:
        v = float(max(v, 0.0))
        idx = int(np.searchsorted(self.bounds, v, side="right"))
        self.counts[idx] += 1
        self.total += v
        self.count += 1

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return float("nan")
        if q >= 1.0:
            # clamp to the upper edge of the highest occupied bucket
            # instead of interpolating past the recorded range
            top = int(np.flatnonzero(self.counts)[-1])
            return float(self.bounds[min(top, self.num_buckets - 1)])
        target = q * self.count
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, target, side="left"))
        idx = min(idx, self.num_buckets)
        below = cum[idx - 1] if idx > 0 else 0
        frac = (target - below) / max(self.counts[idx], 1)
        frac = min(max(frac, 0.0), 1.0)
        upper = self.bounds[min(idx, self.num_buckets - 1)]
        lower = upper / self.growth if idx > 0 else 0.0
        if lower <= 0.0:
            return frac * upper
        return lower * (upper / lower) ** frac

    def p50(self) -> float:
        return self.quantile(0.50)

    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    """Keyed store of metric families; the snapshot side of the plane."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, LabelKey], Any] = {}

    def _get(self, kind, name: str, labels: Mapping[str, Any], **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = kind(**kw)
            self._metrics[key] = m
        elif not isinstance(m, kind):
            raise TypeError(f"{_render(*key)} already registered as "
                            f"{type(m).__name__}")
        return m

    # The family name is positional-only so labels may legally be called
    # "name" (obs_span_latency_us{name="..."} is the shipped convention).
    def counter(self, name: str, /, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, /, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, /, lo: float = 0.1, growth: float = 2.0,
                  num_buckets: int = 32, **labels) -> Histogram:
        return self._get(Histogram, name, labels, lo=lo, growth=growth,
                         num_buckets=num_buckets)

    # ------------------------------------------------------------ ingestion
    def observe_telemetry(self, telem, *, page_bytes: int = 0,
                          specs: Optional[Mapping[int, Any]] = None) -> None:
        """Fold one transfer's BridgeTelemetry into the counter families.

        ``specs`` maps tenant index -> TenantSpec so per-tenant counters
        carry the QoS class label; unknown tenants get qos="unknown".
        Counters stay integer-exact: each call adds that transfer's counts.
        """
        telem = to_host(telem)
        a = lambda x: np.asarray(x)  # noqa: E731
        served = int(a(telem.served_total()).sum())
        self.counter("bridge_pages_served_total").inc(served)
        self.counter("bridge_pages_loopback_total").inc(
            int(a(telem.loopback_served).sum()))
        self.counter("bridge_pages_spilled_total").inc(
            int(a(telem.spilled).sum()))
        self.counter("bridge_pages_pruned_total").inc(
            int(a(telem.pruned).sum()))
        cw, ccw = telem.wire_pages()
        cw, ccw = int(a(cw).sum()), int(a(ccw).sum())
        self.counter("bridge_wire_pages_total", direction="cw").inc(cw)
        self.counter("bridge_wire_pages_total", direction="ccw").inc(ccw)
        if page_bytes:
            self.counter("bridge_bytes_served_total").inc(
                served * page_bytes)
            self.counter("bridge_wire_bytes_total").inc(
                (cw + ccw) * page_bytes)
        hops = a(telem.tier_hops).reshape(-1, 2).sum(0)
        self.counter("bridge_tier_hop_pages_total", tier="board").inc(
            int(hops[0]))
        self.counter("bridge_tier_hop_pages_total", tier="rack").inc(
            int(hops[1]))
        mt = telem.max_tenants
        tser = a(telem.tenant_served).reshape(-1, mt).sum(0)
        tspill = a(telem.tenant_spilled).reshape(-1, mt).sum(0)
        tprune = a(telem.tenant_pruned).reshape(-1, mt).sum(0)
        specs = specs or {}
        for t in range(mt):
            if not (tser[t] or tspill[t] or tprune[t]):
                continue
            spec = specs.get(t)
            qos = getattr(spec, "qos", "unknown")
            lbl = dict(tenant=str(t), qos=qos)
            self.counter("bridge_tenant_pages_total", **lbl).inc(
                int(tser[t]))
            self.counter("bridge_tenant_spilled_total", **lbl).inc(
                int(tspill[t]))
            self.counter("bridge_tenant_pruned_total", **lbl).inc(
                int(tprune[t]))

    def observe_aggregator(self, agg) -> None:
        """Snapshot the EWMA aggregator views into gauge families."""
        # spill/drop rates are per-node; the gauge carries the fleet mean.
        self.gauge("bridge_spill_rate").set(float(np.mean(agg.spill_rate())))
        self.gauge("bridge_drop_rate").set(float(np.mean(agg.drop_rate())))
        for direction, u in agg.link_utilization().items():
            self.gauge("bridge_link_utilization",
                       direction=direction).set(float(u))
        for tier, u in agg.tier_utilization().items():
            self.gauge("bridge_tier_utilization", tier=tier).set(float(u))
        demand = np.asarray(agg.tenant_demand())
        for t, d in enumerate(demand.tolist()):
            if d:
                self.gauge("bridge_tenant_demand_pages",
                           tenant=str(t)).set(float(d))

    def observe_span(self, span) -> None:
        """Record a closed span's latency into the span histogram family."""
        self.histogram("obs_span_latency_us", cat=span.cat,
                       name=span.name).record(span.duration_us)

    # -------------------------------------------------------------- export
    def family_quantiles(self, name: str, /, label: str = "qos"
                         ) -> Dict[str, Dict[str, float]]:
        """Quantile summary of one histogram family, keyed by a label.

        Returns ``{label_value: {count, mean, p50, p99}}`` — e.g. the
        per-QoS-class p50/p99 round latencies the serve bench reports
        (``family_quantiles("serve_request_latency_us")``).  Series
        missing the label key under an empty string.
        """
        out: Dict[str, Dict[str, float]] = {}
        for (n, key), m in sorted(self._metrics.items()):
            if n != name or not isinstance(m, Histogram):
                continue
            out[dict(key).get(label, "")] = {
                "count": m.count, "mean": m.mean,
                "p50": m.p50(), "p99": m.p99()}
        return out

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        for (name, key), m in sorted(self._metrics.items()):
            label = _render(name, key)
            if isinstance(m, Counter):
                out["counters"][label] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][label] = m.value
            else:
                out["histograms"][label] = {
                    "count": m.count, "sum": round(m.total, 3),
                    "mean": round(m.mean, 3),
                    "p50": round(m.p50(), 3), "p99": round(m.p99(), 3)}
        return out

    def to_text(self) -> str:
        """Prometheus-flavoured text exposition (deterministic order)."""
        lines: List[str] = []
        for (name, key), m in sorted(self._metrics.items()):
            label = _render(name, key)
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{label} {m.value:g}")
            else:
                base, br = (name, label[len(name):])
                lines.append(f"{base}_count{br} {m.count}")
                lines.append(f"{base}_sum{br} {m.total:g}")
                lines.append(f"{base}_p50{br} {m.p50():g}")
                lines.append(f"{base}_p99{br} {m.p99():g}")
        return "\n".join(lines)


@dataclass
class _TenantSLO:
    slo_us: float
    window: deque


class SLOMonitor:
    """Per-tenant SLO violation tracking and error-budget burn rates.

    ``record(tenant, latency_us, slo_us)`` appends one observation (a
    measured or predicted round/window latency vs the tenant's
    ``TenantSpec.slo_round_us``).  ``burn_rate`` is the windowed
    violation fraction over the budgeted fraction — 1.0 means burning
    exactly the allowed budget, >1 unsustainable, 0 no violations.
    """

    def __init__(self, *, window: int = 256,
                 budget_fraction: float = 0.01,
                 registry: Optional[MetricsRegistry] = None):
        self.window = int(window)
        self.budget_fraction = float(budget_fraction)
        self.registry = registry
        self._tenants: Dict[int, _TenantSLO] = {}

    def record(self, tenant_id: int, latency_us: float,
               slo_us: float) -> None:
        st = self._tenants.get(tenant_id)
        if st is None:
            st = _TenantSLO(slo_us=float(slo_us),
                            window=deque(maxlen=self.window))
            self._tenants[tenant_id] = st
        st.slo_us = float(slo_us)
        st.window.append(bool(slo_us > 0 and latency_us > slo_us))
        if self.registry is not None:
            self.registry.gauge("slo_burn_rate",
                                tenant=str(tenant_id)).set(
                self.burn_rate(tenant_id))

    def violation_fraction(self, tenant_id: int) -> float:
        st = self._tenants.get(tenant_id)
        if st is None or not st.window:
            return 0.0
        return sum(st.window) / len(st.window)

    def burn_rate(self, tenant_id: int) -> float:
        st = self._tenants.get(tenant_id)
        if st is None or not st.window or self.budget_fraction <= 0:
            return 0.0
        return self.violation_fraction(tenant_id) / self.budget_fraction

    def describe(self) -> Dict[str, Any]:
        return {
            str(t): {
                "slo_us": st.slo_us,
                "samples": len(st.window),
                "violations": int(sum(st.window)),
                "violation_fraction": round(
                    self.violation_fraction(t), 4),
                "burn_rate": round(self.burn_rate(t), 3),
            }
            for t, st in sorted(self._tenants.items())
        }
