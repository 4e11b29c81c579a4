"""Online anomaly / drift sentinel over the metrics plane.

Watches the live measure->fit->steer loop for the failure modes a
calibrated control plane is blind to on its own:

* **latency shift** — the windowed median of measured-over-predicted
  round latency (prediction from the fitted
  :class:`~repro_torch.core.perfmodel.Calibrator`) drifting past a factor
  threshold: the fabric got slower than the model steering it believes;
* **calibration-residual drift** — the windowed mean RLS residual
  climbing well above its healthy baseline: the fitted constants no
  longer describe the fabric.  The sentinel then *re-opens* the RLS
  covariance (:meth:`Calibrator.reset_covariance`) so the fit re-converges
  quickly, and journals the refit;
* **SLO burn** — a tenant's error-budget burn rate crossing an
  enter/clear hysteresis band (alert on the transition, not per sample);
* **telemetry conservation** — invariants the aggregator's linear EWMA
  folds preserve exactly by construction (``served = loopback +
  distance_pages`` in total, ``served >= loopback`` per node,
  non-negative finite counters).  A violation means an accounting bug,
  never load.

Every :class:`Alert` is appended to :attr:`Sentinel.alerts`, counted in
the ``obs_alerts_total{kind=...}`` counter family, and journaled as an
``alert`` :class:`~repro_torch.obs.flight.DecisionRecord` when a flight
recorder is attached.  All detectors carry hysteresis so a sustained
anomaly raises one alert, not one per sample.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass(frozen=True)
class Alert:
    """One sentinel finding (also journaled + counted when attached)."""

    kind: str          # "latency_shift" / "calibration_drift" / ...
    severity: str      # "warn" | "critical"
    message: str
    value: float       # the observed statistic
    threshold: float   # the threshold it crossed


class Sentinel:
    """Windowed detectors over latency ratios, residuals, SLOs, telemetry.

    ``window`` is the detection window: a sustained anomaly is flagged
    within at most ``window`` observations of its onset (the bench's
    injected 2x regression trips the median-ratio detector after about
    ``window/2 + 1`` samples).
    """

    def __init__(self, *, registry=None, flight=None, calibrator=None,
                 slo=None, window: int = 16,
                 shift_factor: float = 1.5, shift_clear: float = 1.2,
                 drift_factor: float = 4.0, drift_floor_us: float = 50.0,
                 burn_on: float = 2.0, burn_off: float = 1.0,
                 min_slo_samples: int = 8):
        self.registry = registry
        self.flight = flight
        self.calibrator = calibrator
        self.slo = slo
        self.window = int(window)
        self.shift_factor = float(shift_factor)
        self.shift_clear = float(shift_clear)
        self.drift_factor = float(drift_factor)
        self.drift_floor_us = float(drift_floor_us)
        self.burn_on = float(burn_on)
        self.burn_off = float(burn_off)
        self.min_slo_samples = int(min_slo_samples)
        self.alerts: List[Alert] = []
        self._ratios: deque = deque(maxlen=self.window)
        self._residuals: deque = deque(maxlen=self.window)
        self._resid_baseline: Optional[float] = None
        self._shift_alarm = False
        self._drift_alarm = False
        self._burn_alarm: Dict[int, bool] = {}

    # ----------------------------------------------------------------- emit
    def _emit(self, kind: str, severity: str, message: str, value: float,
              threshold: float) -> Alert:
        a = Alert(kind=kind, severity=severity, message=message,
                  value=float(value), threshold=float(threshold))
        self.alerts.append(a)
        if self.registry is not None:
            self.registry.counter("obs_alerts_total", kind=kind).inc()
        if self.flight is not None:
            self.flight.record("alert", alert_kind=kind, severity=severity,
                               message=message, value=float(value),
                               threshold=float(threshold))
        return a

    # ------------------------------------------------------------- latency
    def observe_latency(self, measured_us: float,
                        predicted_us: Optional[float] = None,
                        residual_us: Optional[float] = None) -> List[Alert]:
        """Feed one per-round measured latency (+ the calibrator's pre-fit
        prediction for it, when fitted).  Returns alerts raised now."""
        new: List[Alert] = []
        if predicted_us is not None and predicted_us > 0:
            self._ratios.append(float(measured_us) / float(predicted_us))
            if len(self._ratios) == self.window:
                med = float(np.median(self._ratios))
                if not self._shift_alarm and med > self.shift_factor:
                    self._shift_alarm = True
                    new.append(self._emit(
                        "latency_shift", "critical",
                        f"windowed median measured/predicted latency "
                        f"{med:.2f}x exceeds {self.shift_factor:g}x",
                        med, self.shift_factor))
                elif self._shift_alarm and med < self.shift_clear:
                    self._shift_alarm = False
        if residual_us is not None:
            new.extend(self._observe_residual(abs(float(residual_us))))
        return new

    def _observe_residual(self, resid_us: float) -> List[Alert]:
        self._residuals.append(resid_us)
        if len(self._residuals) < self.window:
            return []
        mean = float(np.mean(self._residuals))
        if self._resid_baseline is None:
            self._resid_baseline = mean
            return []
        threshold = max(self.drift_factor * self._resid_baseline,
                        self.drift_floor_us)
        if not self._drift_alarm and mean > threshold:
            self._drift_alarm = True
            a = self._emit(
                "calibration_drift", "warn",
                f"windowed mean RLS residual {mean:.1f}us exceeds "
                f"{threshold:.1f}us (baseline {self._resid_baseline:.1f}us)",
                mean, threshold)
            # The fitted constants no longer describe the fabric: re-open
            # the RLS gain so the next window re-converges, and journal
            # the triggered refit so replay/postmortems see it.
            if (self.calibrator is not None
                    and hasattr(self.calibrator, "reset_covariance")):
                self.calibrator.reset_covariance()
                if self.flight is not None:
                    self.flight.record("calibrator_refit",
                                       residual_us=mean,
                                       baseline_us=self._resid_baseline)
            self._residuals.clear()
            return [a]
        if self._drift_alarm and mean <= threshold:
            self._drift_alarm = False
        if not self._drift_alarm:
            # healthy: track the baseline slowly (EWMA over window means)
            self._resid_baseline = (0.9 * self._resid_baseline + 0.1 * mean)
        return []

    # ----------------------------------------------------------------- SLOs
    def check_slo(self) -> List[Alert]:
        """Burn-rate hysteresis over the attached SLOMonitor's tenants."""
        if self.slo is None:
            return []
        new: List[Alert] = []
        for tid_s, st in self.slo.describe().items():
            tid = int(tid_s)
            if st["samples"] < self.min_slo_samples:
                continue
            burn = float(st["burn_rate"])
            alarm = self._burn_alarm.get(tid, False)
            if not alarm and burn >= self.burn_on:
                self._burn_alarm[tid] = True
                new.append(self._emit(
                    "slo_burn", "critical",
                    f"tenant {tid} burn rate {burn:.2f} >= "
                    f"{self.burn_on:g} ({st['violations']}/{st['samples']} "
                    f"over {st['slo_us']:g}us)", burn, self.burn_on))
            elif alarm and burn <= self.burn_off:
                self._burn_alarm[tid] = False
        return new

    # ------------------------------------------------------------ telemetry
    def check_telemetry(self, agg) -> List[Alert]:
        """Conservation invariants of the aggregator's EWMA folds."""
        new: List[Alert] = []
        served = np.asarray(agg.served, float)
        loop = np.asarray(agg.loopback, float)
        dist = np.asarray(agg.distance_pages(), float)
        fields = {"served": served, "loopback": loop, "distance_pages": dist,
                  "spilled": np.asarray(agg.spilled, float),
                  "tenant_served": np.asarray(agg.tenant_served, float)}
        for name, arr in fields.items():
            if not np.all(np.isfinite(arr)) or np.any(arr < -1e-6):
                new.append(self._emit(
                    "conservation", "critical",
                    f"telemetry counter {name} is negative or non-finite",
                    float(np.min(arr)) if arr.size else 0.0, 0.0))
                return new
        # served folds loopback + per-distance slot pages of the same
        # steps with the same linear EWMA, so the totals agree exactly
        # (up to float rounding) — and served >= loopback per node.
        tot_served, tot_parts = float(served.sum()), float(
            loop.sum() + dist.sum())
        tol = 1e-6 * max(tot_served, 1.0)
        if abs(tot_served - tot_parts) > tol:
            new.append(self._emit(
                "conservation", "critical",
                f"served total {tot_served:.6f} != loopback + distance "
                f"pages {tot_parts:.6f}", tot_served - tot_parts, tol))
        if np.any(served + 1e-6 < loop):
            node = int(np.argmax(loop - served))
            new.append(self._emit(
                "conservation", "critical",
                f"node {node} loopback exceeds served",
                float((loop - served)[node]), 0.0))
        return new

    # ---------------------------------------------------------- introspect
    def describe(self) -> Dict[str, Any]:
        return {
            "alerts": len(self.alerts),
            "window": self.window,
            "shift_alarm": self._shift_alarm,
            "drift_alarm": self._drift_alarm,
            "burn_alarms": sorted(t for t, on in self._burn_alarm.items()
                                  if on),
            "resid_baseline_us": self._resid_baseline,
        }


__all__ = ["Alert", "Sentinel"]
