"""Continuous batching: request-level serving over the pooled datapath (the
port's copy of ``repro.serve.batcher``).

The decode step is a fixed-width function — ``batch`` slots, one token per
slot per step — but real demand is thousands of concurrent
*requests* arriving over time with wildly different lengths.  This module
closes that gap the way production LLM servers do, specialized to this
repo's disaggregated-memory stack:

* **slot map with admit-on-free** — each batch slot serves one sequence
  at a time; when a sequence retires (its output length is reached) the
  slot returns to the free list and the next queued request takes it on
  the following control tick, so the step keeps its shapes and the
  batch never drains to refill (continuous, not static, batching);
* **prefill/decode separation without a second engine** — a newly
  admitted sequence *prefills in place*: its prompt tokens feed one per
  step into its own slot while every other slot keeps decoding.  Slots
  are numerically independent (the step is elementwise per slot), so
  in-flight decodes are bit-identical to a solo run regardless of what
  their neighbours prefill;
* **pooled KV as leases** — each admitted sequence takes an orchestrator
  lease for its KV pages (``auto_renew=True``: renewal rides the
  orchestrator's background control period); retirement releases the
  lease, returning the pages to the control plane's free list for the
  next admission.  Requests that can *never* fit (quota, whole-pool
  capacity) are shed at submit via ``Orchestrator.can_ever_admit`` —
  they must not livelock the admission loop;
* **QoS-aware slot admission** — the same
  :class:`~repro_torch.orchestrator.scheduler.WeightedFairScheduler` that
  splits the bridge round budget splits the *decode slots*: per-tenant
  slot windows from shares + live queue depths, interactive tenants
  admitted first, unused windows spilling to whoever has backlog (work
  conserving).  ``policy="naive"`` is the ablation: one global FIFO, the
  noisy-neighbour baseline the bench contrasts against.

Fidelity contract: with the :class:`ModelDecodeEngine` (the real serve
step), every retired sequence's tokens are **bit-identical** to
:func:`solo_reference` running the same request alone in a fixed batch —
admitting a slot resets its ``lengths`` to 0, which makes stale KV
invisible (attention masks to ``lengths + 1`` visible positions, and the
cache is overwritten progressively from position 0), so slot reuse
cannot leak state.  The :class:`SimulatedDecodeEngine` keeps the same
step protocol with per-slot host arithmetic for fleet-scale runs.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.steering import to_device
from repro_torch.obs.clock import Clock, ManualClock
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import (CAT_CONTROL, CAT_REQUEST, CAT_ROUND,
                                   TraceRecorder)
from repro_torch.orchestrator.orchestrator import Orchestrator
from repro_torch.orchestrator.scheduler import WeightedFairScheduler
from repro_torch.serve.step import (build_serve_step, init_serve_state,
                                    make_cache_ops)
from repro_torch.serve.traffic import Request, TrafficGenerator


@dataclass
class SeqState:
    """One in-flight sequence bound to a decode slot."""

    req: Request
    slot: int
    lease_id: int
    admit_step: int
    arrive_us: float
    admit_us: float
    fed: int = 0                           # tokens fed so far
    out: List[int] = field(default_factory=list)
    first_token_us: Optional[float] = None
    started: bool = False                  # slot reset issued

    def next_feed(self) -> int:
        """The token to feed this step: prompt first, then own output."""
        if self.fed < self.req.prompt_len:
            return self.req.prompt[self.fed]
        return self.out[self.fed - self.req.prompt_len]

    @property
    def done(self) -> bool:
        return len(self.out) >= self.req.output_len


@dataclass
class _Queued:
    req: Request
    arrive_us: float
    attempts: int = 0


class SimulatedDecodeEngine:
    """Per-slot host arithmetic with the real engine's step protocol.

    Each slot carries a rolling hash ``acc``; one step maps the fed token
    to ``(31 * acc + tok + 1) % vocab`` and emits it.  The emission
    depends on the slot's *own* history only — exactly the independence
    property of the real model — so continuous-batched output matches
    :func:`solo_reference` iff the batcher feeds the right token at the
    right step AND resets the slot on admit (a forgotten reset leaks the
    previous occupant's ``acc`` into the hash and the tokens diverge).
    """

    def __init__(self, num_slots: int, vocab: int = 32000):
        self.num_slots = num_slots
        self.vocab = vocab
        self.acc = np.zeros((num_slots,), np.int64)

    def step(self, tokens: np.ndarray,
             reset: Sequence[int] = ()) -> np.ndarray:
        if len(reset):
            self.acc[np.asarray(list(reset), np.int64)] = 0
        self.acc = (31 * self.acc + np.asarray(tokens, np.int64) + 1) \
            % self.vocab
        return self.acc.astype(np.int32)


class ModelDecodeEngine:
    """The real serve step behind the batcher's slot protocol.

    ``reset`` slots get ``state["lengths"][slot] = 0`` *before* the step
    consumes their first prompt token: visibility masks to
    ``lengths + 1`` positions and the KV cache is rewritten progressively
    from position 0, so the retiring occupant's state is unreachable —
    the mechanism behind the bit-exactness contract, for the local dense
    cache and the bridge paged placements alike.

    The engine runs on ``device`` (the card unless the caller asks for the
    CPU); ``num_nodes`` stripes a bridge placement's pool over that many
    memory nodes.  A step uploads the fed tokens and the reset slots
    without waiting and copies one thing back to the host: the emitted
    tokens, which the batcher reads to retire sequences.
    """

    def __init__(self, run, params, *, batch: int, max_len: int,
                 page_tokens: int = 512, num_nodes: int = 1,
                 dtype=torch.bfloat16, device="cuda"):
        self.num_slots = batch
        self.max_len = max_len
        self.device = torch.device(device)
        self.cache_ops = make_cache_ops(run, max_len, page_tokens,
                                        num_nodes=num_nodes, dtype=dtype,
                                        device=self.device)
        self.params = params
        self.state = init_serve_state(run, batch, self.cache_ops)
        self._step = build_serve_step(run, self.cache_ops)
        self.steps = 0

    def step(self, tokens: np.ndarray,
             reset: Sequence[int] = ()) -> np.ndarray:
        if len(reset):
            idx = to_device(np.asarray(list(reset), np.int64), self.device)
            # index_fill_ takes the 0 as a scalar: an assignment of 0 would
            # copy a host tensor to the card and wait for it
            self.state["lengths"].index_fill_(0, idx, 0)
        feed = to_device(np.asarray(tokens, np.int32), self.device)
        out, self.state = self._step(self.params, self.state, feed)
        self.steps += 1
        return out.cpu().numpy()


SHED_TERMINAL = "terminal"     # can never fit: quota / whole-pool capacity
SHED_ATTEMPTS = "attempts"     # exhausted max_admit_attempts retries


class ContinuousBatcher:
    """Per-tenant request queues feeding a fixed-width decode batch.

    The serve loop drives one cycle per decode step::

        submit(arrivals) -> control() -> step_inputs() -> engine.step()
                                      -> observe(next_tokens)

    ``control()`` advances the orchestrator clock (lease aging /
    auto-renewal / classic admission-queue drain ride
    ``Orchestrator.step``), re-fits the bridge windows from live queue
    depths each control period, and admits queued requests into free
    slots — taking one KV-page lease per sequence.  ``observe()``
    retires finished sequences: lease released, slot freed, per-QoS
    latency/TTFT histograms recorded (and a ``CAT_REQUEST`` trace span,
    when a recorder is attached).
    """

    def __init__(self, orc: Orchestrator, *, num_slots: int,
                 page_tokens: int = 512, policy: str = "qos",
                 max_admit_attempts: int = 0, lease_term: int = 8,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Optional[Clock] = None,
                 recorder: Optional[TraceRecorder] = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if policy not in ("qos", "naive"):
            raise ValueError(f"policy must be 'qos' or 'naive': {policy}")
        self.orc = orc
        self.num_slots = num_slots
        self.page_tokens = page_tokens
        self.policy = policy
        self.max_admit_attempts = max_admit_attempts
        self.lease_term = lease_term
        self.registry = registry if registry is not None else orc.metrics
        self.clock = clock if clock is not None else ManualClock(tick_us=0.0)
        self.recorder = recorder
        self.slot_sched = WeightedFairScheduler(num_slots)
        self.queues: Dict[int, deque] = {}
        self.slots: List[Optional[SeqState]] = [None] * num_slots
        self.free: deque = deque(range(num_slots))
        self._pending_reset: List[int] = []
        self.step_count = 0
        # request accounting (per tenant)
        self.submitted: Dict[int, int] = {}
        self.completed: Dict[int, int] = {}
        self.shed: Dict[int, Dict[str, int]] = {}
        self.tokens_out = 0
        self.peak_in_flight = 0
        self.retired: List[SeqState] = []    # every retired sequence, order

    # -- intake ----------------------------------------------------------------
    def submit(self, req: Request) -> str:
        """Queue one request; returns ``"queued"`` or ``"shed"``.

        Requests no future pool state can admit (tenant quota, whole-pool
        capacity) shed immediately — parking them would retry forever.
        """
        self.submitted[req.tenant_id] = \
            self.submitted.get(req.tenant_id, 0) + 1
        pages = req.num_pages(self.page_tokens)
        if not self.orc.can_ever_admit(req.tenant_id, max(pages, 1)):
            self._shed(req.tenant_id, SHED_TERMINAL)
            return "shed"
        self.queues.setdefault(req.tenant_id, deque()).append(
            _Queued(req=req, arrive_us=self.clock.now_us()))
        return "queued"

    def _shed(self, tenant_id: int, why: str) -> None:
        self.shed.setdefault(tenant_id, {})[why] = \
            self.shed.get(tenant_id, {}).get(why, 0) + 1
        self.registry.counter("serve_requests_shed_total",
                              tenant=str(tenant_id), reason=why).inc()

    # -- views -----------------------------------------------------------------
    def queue_depth(self, tenant_id: Optional[int] = None) -> int:
        if tenant_id is not None:
            return len(self.queues.get(tenant_id, ()))
        return sum(len(q) for q in self.queues.values())

    def active_count(self, tenant_id: Optional[int] = None) -> int:
        return sum(1 for s in self.slots if s is not None
                   and (tenant_id is None or s.req.tenant_id == tenant_id))

    def in_flight(self) -> int:
        """Concurrent sequences the server is responsible for now."""
        return self.queue_depth() + self.active_count()

    def accounting(self) -> Dict[str, Dict[int, int]]:
        """Conservation view: submitted == completed + shed + in flight."""
        return {
            "submitted": dict(self.submitted),
            "completed": dict(self.completed),
            "shed": {t: sum(v.values()) for t, v in self.shed.items()},
            "queued": {t: len(q) for t, q in self.queues.items() if q},
            "active": {t: self.active_count(t)
                       for t in self.submitted if self.active_count(t)},
        }

    # -- the control tick ------------------------------------------------------
    def control(self, telemetry=None,
                measured_round_us: Optional[float] = None
                ) -> List[SeqState]:
        """One background control tick; returns newly admitted sequences.

        Rides :meth:`Orchestrator.step` (lease aging — each sequence's
        KV lease auto-renews here — plus the classic admission-queue
        drain and the periodic telemetry re-fit), then re-fits the bridge
        request windows from the *serving* queue depths, then admits
        queued requests into free decode slots under the slot policy.
        """
        self.step_count += 1
        self.orc.step(telemetry=telemetry,
                      measured_round_us=measured_round_us)
        if self.orc.specs and \
                self.orc.step_count % self.orc.control_period == 0:
            self.orc.refit_windows(self._slot_demand())
        admitted = self._admit()
        self.peak_in_flight = max(self.peak_in_flight, self.in_flight())
        g = self.registry.gauge
        g("serve_slots_active").set(self.active_count())
        g("serve_queue_depth").set(self.queue_depth())
        g("serve_in_flight").set(self.in_flight())
        return admitted

    def _slot_demand(self) -> Dict[int, float]:
        return {tid: float(self.active_count(tid) + self.queue_depth(tid))
                for tid in self.orc.specs}

    def _admission_order(self) -> List[Tuple[int, int]]:
        """(tenant, allowance) pairs for this tick's windowed pass."""
        specs = list(self.orc.specs.values())
        if self.policy == "naive" or not specs:
            # One global FIFO: every tenant may bid for every slot; ties
            # broken by request id (arrival order) in _admit.
            return [(tid, self.num_slots) for tid in self.queues]
        schedule = self.slot_sched.compile(specs, self._slot_demand())
        return [(tid, max(schedule.windows.get(tid, 0)
                          - self.active_count(tid), 0))
                for tid in schedule.order]

    def _admit(self) -> List[SeqState]:
        admitted: List[SeqState] = []
        if not self.free:
            return admitted
        if self.policy == "naive":
            # Strict arrival order across all tenants — the ablation.
            while self.free:
                heads = [q[0] for q in self.queues.values() if q]
                if not heads:
                    break
                req = min(heads, key=lambda c: c.req.req_id)
                if not self._admit_one(self.queues[req.req.tenant_id],
                                       admitted):
                    break   # head of line blocked on capacity: stop
            return admitted
        order = self._admission_order()
        blocked: set = set()   # capacity-blocked this tick: probe once
        for tid, allow in order:            # windowed pass, QoS order
            q = self.queues.get(tid)
            for _ in range(allow):
                if not self.free or not q:
                    break
                if not self._admit_one(q, admitted):
                    blocked.add(tid)        # tenant blocked: next tenant
                    break
        progress = True
        while self.free and progress:       # work-conserving overflow
            progress = False
            for tid, _ in order:
                if tid in blocked:
                    continue
                q = self.queues.get(tid)
                if self.free and q:
                    if self._admit_one(q, admitted):
                        progress = True
                    else:
                        blocked.add(tid)
        return admitted

    def _admit_one(self, q: deque, admitted: List[SeqState]) -> bool:
        """Try the queue's head request; True iff a slot was filled."""
        cand = q.popleft()
        req = cand.req
        pages = max(req.num_pages(self.page_tokens), 1)
        decision, lease = self.orc.request_lease(
            req.tenant_id, pages, term=self.lease_term, auto_renew=True,
            queue=False, request_id=req.req_id)
        if not decision.admitted:
            cand.attempts += 1
            if not self.orc.can_ever_admit(req.tenant_id, pages):
                # Became terminal after submit (e.g. quota shrank by a
                # sibling lease the tenant will never drop): shed now.
                self._shed(req.tenant_id, SHED_TERMINAL)
            elif 0 < self.max_admit_attempts <= cand.attempts:
                self._shed(req.tenant_id, SHED_ATTEMPTS)
            else:
                q.appendleft(cand)          # keep head-of-line order
                return False
            return False
        slot = self.free.popleft()
        seq = SeqState(req=req, slot=slot, lease_id=lease.lease_id,
                       admit_step=self.step_count,
                       arrive_us=cand.arrive_us,
                       admit_us=self.clock.now_us())
        self.slots[slot] = seq
        self._pending_reset.append(slot)
        admitted.append(seq)
        return True

    # -- the decode-step halves ------------------------------------------------
    def step_inputs(self) -> Tuple[np.ndarray, List[int]]:
        """(tokens [num_slots], reset slots) for the engine step.

        Reset slots are the admissions since the last call — the engine
        must zero their ``lengths`` before consuming these tokens.  Free
        slots feed token 0; their output is discarded.
        """
        tokens = np.zeros((self.num_slots,), np.int32)
        for seq in self.slots:
            if seq is not None:
                tokens[seq.slot] = seq.next_feed()
                seq.started = True
        resets, self._pending_reset = self._pending_reset, []
        return tokens, resets

    def observe(self, next_tokens: np.ndarray) -> List[SeqState]:
        """Fold one engine step's emissions; returns retired sequences."""
        out = np.asarray(next_tokens)
        finished: List[SeqState] = []
        for seq in self.slots:
            if seq is None or not seq.started:
                continue
            fed_idx = seq.fed
            seq.fed += 1
            if fed_idx >= seq.req.prompt_len - 1:
                # Feeding the last prompt token (or any later feed) emits
                # a generated token.
                seq.out.append(int(out[seq.slot]))
                if seq.first_token_us is None:
                    seq.first_token_us = self.clock.now_us()
            if seq.done:
                finished.append(seq)
        for seq in finished:
            self._retire(seq)
        return finished

    def _retire(self, seq: SeqState) -> None:
        lease = self.orc.leases.get(seq.lease_id)
        if lease is not None:       # pages back to the pool's free list
            self.orc.release_lease(lease)
        self.slots[seq.slot] = None
        self.free.append(seq.slot)
        tid = seq.req.tenant_id
        self.completed[tid] = self.completed.get(tid, 0) + 1
        self.tokens_out += len(seq.out)
        self.retired.append(seq)
        qos = self.orc.specs[tid].qos if tid in self.orc.specs else "unknown"
        now = self.clock.now_us()
        h = self.registry.histogram
        h("serve_request_latency_us", lo=1.0, qos=qos).record(
            now - seq.arrive_us)
        h("serve_ttft_us", lo=1.0, qos=qos).record(
            (seq.first_token_us if seq.first_token_us is not None else now)
            - seq.arrive_us)
        h("serve_request_steps", lo=1.0, qos=qos).record(
            self.step_count - (seq.req.arrive_step + 1))
        self.registry.counter("serve_tokens_total", qos=qos).inc(
            len(seq.out))
        self.registry.counter("serve_requests_completed_total",
                              tenant=str(tid), qos=qos).inc()
        if self.recorder is not None:
            self.recorder.record_span(
                f"req{seq.req.req_id}", CAT_REQUEST,
                start_us=seq.arrive_us, end_us=now, tenant=tid, qos=qos,
                prompt_len=seq.req.prompt_len, output_len=len(seq.out),
                admit_us=seq.admit_us, req_id=seq.req.req_id,
                lease_id=seq.lease_id)

    def why(self, request_id: int) -> Dict[str, object]:
        """Causal chain behind one request: admission verdicts, lease
        grant/release, the route program it ran under (from the flight
        journal) plus its ``req{id}`` span and the bridge-round spans that
        overlap its in-flight window (from the trace recorder)."""
        out: Dict[str, object] = {
            "request_id": int(request_id),
            "decisions": [r.to_json() for r in
                          self.orc.flight.why(request_id)],
            "spans": [],
        }
        if self.recorder is not None:
            req_span = None
            for s in self.recorder.spans:
                if s.name == f"req{request_id}":
                    req_span = s
                    break
            if req_span is not None:
                lo, hi = req_span.start_us, (req_span.end_us
                                             if req_span.end_us is not None
                                             else float("inf"))
                for s in self.recorder.spans:
                    if s is req_span or (
                            s.end_us is not None and s.end_us >= lo
                            and s.start_us <= hi
                            and s.cat in ("round", "control", CAT_REQUEST)):
                        out["spans"].append({
                            "name": s.name, "cat": s.cat,
                            "start_us": s.start_us, "end_us": s.end_us,
                            "args": dict(s.args)})
        return out

    def describe(self) -> str:
        acc = self.accounting()
        done = sum(acc["completed"].values())
        subd = sum(acc["submitted"].values())
        return (f"batcher[{self.policy}]: step {self.step_count}, "
                f"{self.active_count()}/{self.num_slots} slots, "
                f"{self.queue_depth()} queued, {done}/{subd} completed, "
                f"{self.tokens_out} tokens, "
                f"peak in-flight {self.peak_in_flight}")


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def serve_loop(batcher: ContinuousBatcher, engine,
               traffic: Optional[TrafficGenerator] = None, *,
               steps: int = 0, step_us: float = 0.0, drain: bool = True,
               max_steps: int = 200_000) -> Dict[str, object]:
    """Closed-loop serve simulation: arrivals -> admit -> decode -> retire.

    Runs ``steps`` arrival steps (then stops offering load) and, with
    ``drain=True``, keeps stepping until every queued/active sequence
    retires.  ``step_us`` advances the batcher's clock per decode step
    (the modeled step latency), making the latency histograms
    wall-clock-denominated and deterministic.

    With a trace recorder on the batcher, each ``control()`` tick is a
    ``control`` span and each engine step a ``decode_step`` span (category
    ``round``) that closes after the emitted tokens reached the host, so it
    holds the step's device work.
    """
    rec = batcher.recorder
    step = 0
    while True:
        if traffic is not None and step < steps:
            for req in traffic.arrivals(step):
                batcher.submit(req)
        if rec is None:
            batcher.control()
        else:
            with rec.span("control", CAT_CONTROL, step=step):
                batcher.control()
        if batcher.active_count() > 0:
            tokens, resets = batcher.step_inputs()
            if rec is None:
                emitted = engine.step(tokens, resets)
            else:
                with rec.span("decode_step", CAT_ROUND, step=step,
                              resets=len(resets)):
                    emitted = engine.step(tokens, resets)
            batcher.observe(emitted)
        if step_us:
            batcher.clock.advance(step_us)
        step += 1
        live = batcher.in_flight() if drain else 0
        if step >= steps and live == 0:
            break
        if step >= max_steps:
            raise RuntimeError(
                f"serve_loop did not drain in {max_steps} steps: "
                f"{batcher.describe()}")
    done = sum(batcher.completed.values())
    sim_s = step * step_us / 1e6 if step_us else 0.0
    return {
        "steps": step,
        "completed": done,
        "submitted": sum(batcher.submitted.values()),
        "shed": sum(sum(v.values()) for v in batcher.shed.values()),
        "tokens": batcher.tokens_out,
        "peak_in_flight": batcher.peak_in_flight,
        "goodput_tokens_per_s": (batcher.tokens_out / sim_s
                                 if sim_s else 0.0),
        "latency_us": batcher.registry.family_quantiles(
            "serve_request_latency_us"),
        "ttft_us": batcher.registry.family_quantiles("serve_ttft_us"),
    }


def solo_reference(engine, req: Request, *, slot: int = 0) -> List[int]:
    """Decode one request alone in a fixed batch — the fidelity oracle.

    Same engine protocol, same batch width, same slot, nothing else
    resident: the continuous batcher's tokens for the request must match
    this bit-for-bit.
    """
    tokens = np.zeros((engine.num_slots,), np.int32)
    out: List[int] = []
    fed = 0
    reset = [slot]
    while len(out) < req.output_len:
        tokens[slot] = (req.prompt[fed] if fed < req.prompt_len
                        else out[fed - req.prompt_len])
        emitted = engine.step(tokens, reset)
        reset = []
        if fed >= req.prompt_len - 1:
            out.append(int(emitted[slot]))
        fed += 1
    return out
