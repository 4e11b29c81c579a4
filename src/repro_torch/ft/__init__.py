"""Fault tolerance of the port: the heartbeat monitor and the elastic
trainer."""
from repro_torch.ft.elastic import ElasticTrainer, FailureEvent  # noqa: F401
from repro_torch.ft.heartbeat import HeartbeatMonitor  # noqa: F401
