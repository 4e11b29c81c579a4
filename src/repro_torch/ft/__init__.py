"""Fault tolerance of the port; so far the heartbeat monitor."""
from repro_torch.ft.heartbeat import HeartbeatMonitor  # noqa: F401
