"""In-band traffic telemetry: the bridge's measurement plane.

  counters   — BridgeTelemetry + masked-sum datapath collection
  aggregate  — host-side EWMA aggregation feeding the control plane

pull/push(collect_telemetry=True) -> BridgeTelemetry ->
TelemetryAggregator.update -> the control plane's next runtime inputs.
"""
from repro_torch.telemetry.counters import (BridgeTelemetry, add,  # noqa: F401
                                            transfer_telemetry, zeros)
from repro_torch.telemetry.aggregate import TelemetryAggregator  # noqa: F401
