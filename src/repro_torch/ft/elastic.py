"""Elastic fault-tolerant training loop.

The port's copy of ``repro.ft.elastic``, on the port's control plane,
heartbeat monitor and telemetry aggregator:

* periodic **checkpointing** (atomic, retention-managed);
* **failure handling**: on a node-failure event the control plane re-homes
  the dead node's pool pages (a memport reprogram, nothing rebuilt), pooled
  state is restored from the last checkpoint through the bridge, and
  training resumes at the checkpointed step;
* **straggler mitigation**: step-time telemetry feeds per-node bridge rate
  limits (paper §2's software-controlled rate limiter);
* **traffic feedback**: in-band bridge counters recorded via
  :meth:`ElasticTrainer.record_telemetry` close the loop — rate limits
  adapt to observed spills and :meth:`ElasticTrainer.route_program`
  compiles load-balanced, measured-pruned circuit schedules;
* **elastic scaling**: the same remap path admits new nodes (revive) and
  re-stripes pages onto them.

The loop is synchronous and single-process; every decision point
(detect -> plan -> remap -> restore -> resume) is a function of explicit
state.  Host time goes through :mod:`repro_torch.obs.clock`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.control_plane import ControlPlane, MigrationStep
from repro_torch.ft.heartbeat import HeartbeatMonitor
from repro_torch.obs.clock import MonotonicClock
from repro_torch.telemetry import TelemetryAggregator


@dataclass
class FailureEvent:
    node: int                  # -1 for non-node events (e.g. link failures)
    at_step: int
    kind: str = "node_lost"
    direction: Optional[int] = None   # ring direction for link_lost events


@dataclass
class ElasticTrainer:
    """Wraps a step function with checkpoint/restart + elastic remap."""

    step_fn: Callable[[Any, Any], tuple[Any, dict]]
    ckpt: CheckpointManager
    cp: Optional[ControlPlane] = None
    ckpt_every: int = 50
    monitor: Optional[HeartbeatMonitor] = None
    telemetry: Optional[TelemetryAggregator] = None
    events: list = field(default_factory=list)
    _wall: MonotonicClock = field(default_factory=MonotonicClock, repr=False)

    def run(self, state: Any, batches, *, start_step: int = 0,
            num_steps: int = 100,
            failure_schedule: Optional[dict[int, int]] = None,
            on_remap: Optional[Callable[[list[MigrationStep]], None]] = None):
        """Run ``num_steps`` steps with injected failures (tests).

        failure_schedule: {step: node_to_kill}.
        Returns (state, history).
        """
        history = []
        step = start_step
        it = iter(batches)
        while step < num_steps:
            if failure_schedule and step in failure_schedule:
                node = failure_schedule.pop(step)
                state, step = self.handle_failure(node, step, state)
                continue
            batch = next(it)
            t0 = self._wall.now_us()
            state, metrics = self.step_fn(state, batch)
            dt = (self._wall.now_us() - t0) / 1e6
            if self.cp is not None:
                # single-host simulation: node 0 reports real time, others
                # are synthetic equal reports unless a test overrides
                for node in self.cp.alive_nodes:
                    self.cp.record_step_time(node, dt)
            step += 1
            history.append({"step": step, **{k: float(v)
                                             for k, v in metrics.items()}})
            if step % self.ckpt_every == 0:
                self.ckpt.save(step, state, extra={"step": step})
        return state, history

    def handle_failure(self, node: int, step: int, state: Any):
        """Failure path: remap pool pages, restore from last checkpoint."""
        self.events.append(FailureEvent(node, step))
        plan: list[MigrationStep] = []
        if self.cp is not None:
            plan = self.cp.fail_node(node)
        restore_step = self.ckpt.latest_step()
        if restore_step is None:
            raise RuntimeError(
                f"node {node} lost at step {step} with no checkpoint")
        restored, extra = self.ckpt.restore(state, step=restore_step)
        self.events.append(
            FailureEvent(node, restore_step, kind="restored"))
        # caller-provided executor refills re-homed pool pages (zero_bridge)
        self._last_plan = plan
        return restored, int(extra.get("step", restore_step))

    def record_telemetry(self, telem) -> None:
        """Fold one step's bridge counters into the trainer's aggregator
        (created on first use, sized from the control plane)."""
        if self.telemetry is None:
            n = (self.cp.num_nodes if self.cp is not None
                 else int(telem.traffic.shape[-1]))
            # Tenant width follows the measurement: a store created with a
            # wider max_tenants must not trip the aggregator's width check.
            self.telemetry = TelemetryAggregator(
                n, max_tenants=telem.max_tenants)
        self.telemetry.update(telem)

    def rate_limits(self, static_budget: int):
        """Per-node bridge budgets: straggler throttling + measured spill
        feedback (one measure -> recompile iteration zeroes the spills)."""
        if self.cp is None:
            return None
        return self.cp.rate_limits(static_budget, telemetry=self.telemetry)

    def route_program(self):
        """The circuit schedule for the next step: load-balanced and pruned
        from measured traffic once telemetry has been recorded, placement-
        derived before that."""
        if self.cp is None:
            return None
        return self.cp.route_program(telemetry=self.telemetry)

    def handle_link_failure(self, step: int, direction: int):
        """Ring-link failure path: no data is lost (pages stay homed), the
        circuit schedule just reroutes around the dead direction.  Returns
        the re-compiled RouteProgram to feed the next bridge step."""
        if self.cp is None:
            return None
        self.events.append(FailureEvent(-1, step, kind="link_lost",
                                        direction=direction))
        self.cp.report_link_failure(direction)
        return self.cp.route_program(telemetry=self.telemetry)
