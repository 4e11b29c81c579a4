"""Heartbeat monitoring for node liveness (simulated clock for tests).

The port's copy of ``repro.ft.heartbeat``.  In a deployment each worker's
agent reports a heartbeat to the control plane; here the monitor is a pure
data structure driven by the serving or training loop (or a simulated
clock in tests), so failure detection is testable without real processes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class HeartbeatMonitor:
    num_nodes: int
    timeout: float = 30.0
    last_seen: dict = field(default_factory=dict)
    now: float = 0.0

    def beat(self, node: int, t: Optional[float] = None) -> None:
        self.now = t if t is not None else self.now
        self.last_seen[node] = self.now

    def tick(self, t: float) -> list[int]:
        """Advance the clock; return nodes newly considered dead."""
        self.now = t
        dead = []
        for node in range(self.num_nodes):
            seen = self.last_seen.get(node)
            if seen is not None and (t - seen) > self.timeout:
                dead.append(node)
                self.last_seen.pop(node)
        return dead
