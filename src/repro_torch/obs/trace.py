"""Transaction tracing for the bridge datapath (the port's copy of
``repro.obs.trace``).

A :class:`TraceRecorder` wraps host-side calls into the datapath in
wall-clock spans.  Spans nest — the recorder keeps an open stack, so a
transaction span contains its round spans, which contain channel-chunk and
phase spans — and each span can be decorated with the ``BridgeTelemetry``
counters of the work it fenced, making the trace a join of *when* (wall
clock) and *what* (bit-exact page counts).

Fencing matters because CUDA launches are asynchronous: a call returns
once its kernels are queued, so the recorder only closes a span after
waiting on the card for the tensors it was given (``fence=``): a span that
names a fence includes the device work that produced them.  CPU tensors
need no wait.  The clock is injectable (:mod:`repro_torch.obs.clock`); with
a ``ManualClock`` the whole trace is deterministic and reproducible
byte-for-byte.

Export is Chrome-trace JSON (``{"traceEvents": [...]}`` with ``ph="X"``
complete events) — load it at https://ui.perfetto.dev or
``chrome://tracing``.
"""

from __future__ import annotations

import dataclasses
import json
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.obs.clock import Clock, MonotonicClock
from repro_torch.telemetry.aggregate import to_host

#: Span categories used by the shipped instrumentation.  Free-form —
#: these are conventions, not an enum the recorder enforces.
CAT_TRANSFER = "transfer"   # one pull/push transaction (all rounds)
CAT_ROUND = "round"         # one bridge round
CAT_CHUNK = "chunk"         # one channel chunk within a round
CAT_PHASE = "phase"         # wire_req / gather / wire_data / commit
CAT_COMPILE = "compile"     # a kernel build
CAT_CONTROL = "control"     # orchestrator control period / refit
CAT_REQUEST = "request"     # one serving request (queue -> retire)


@dataclass
class Span:
    """One closed-interval trace span (microsecond timestamps)."""

    span_id: int
    parent_id: Optional[int]
    name: str
    cat: str
    start_us: float
    end_us: Optional[float] = None
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_us(self) -> float:
        return 0.0 if self.end_us is None else self.end_us - self.start_us


def _tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor in a tree of dicts, lists, tuples and dataclasses."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _jsonable(v):
    if torch.is_tensor(v):
        return v.tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


class TraceRecorder:
    """Collects a span tree and exports Chrome-trace/Perfetto JSON."""

    def __init__(self, clock: Optional[Clock] = None, *, pid: int = 0,
                 process_name: str = "repro-bridge"):
        self.clock = clock if clock is not None else MonotonicClock()
        self.pid = pid
        self.process_name = process_name
        self.spans: List[Span] = []
        self._stack: List[Span] = []
        self._next_id = 0

    # ---------------------------------------------------------------- spans
    @contextmanager
    def span(self, name: str, cat: str = CAT_TRANSFER, *, fence=None,
             **attrs) -> Iterator[Span]:
        """Open a span around a block; the card's work behind the tensors
        in ``fence=`` is waited on before the span closes, so it lies
        inside the span."""
        s = Span(span_id=self._next_id,
                 parent_id=self._stack[-1].span_id if self._stack else None,
                 name=name, cat=cat, start_us=self.clock.now_us(),
                 args={k: _jsonable(v) for k, v in attrs.items()})
        self._next_id += 1
        self.spans.append(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            if fence is not None:
                self.fence(fence)
            self._stack.pop()
            s.end_us = self.clock.now_us()

    def record_span(self, name: str, cat: str = CAT_REQUEST, *,
                    start_us: float, end_us: float, **attrs) -> Span:
        """Append a closed span with explicit timestamps.

        For lifecycle spans whose start predates the call — e.g. a serving
        request recorded at retirement, whose arrival timestamp was taken
        steps ago — where the context-manager protocol cannot apply.  The
        span is top-level (no parent inferred from the open stack).
        """
        s = Span(span_id=self._next_id, parent_id=None, name=name, cat=cat,
                 start_us=float(start_us), end_us=float(end_us),
                 args={k: _jsonable(v) for k, v in attrs.items()})
        self._next_id += 1
        self.spans.append(s)
        return s

    @staticmethod
    def fence(tree) -> None:
        """Wait until the card has finished the work behind every CUDA
        tensor in ``tree`` (nested dicts, lists, tuples and dataclasses
        such as ``BridgeTelemetry``); CPU tensors need no wait."""
        devices = {t.device for t in _tensors(tree) if t.is_cuda}
        for device in devices:
            torch.cuda.synchronize(device)

    def annotate(self, span: Span, **attrs) -> None:
        span.args.update({k: _jsonable(v) for k, v in attrs.items()})

    def annotate_telemetry(self, span: Span, telem, *, page_bytes: int = 0,
                           tenant_names: Optional[Dict[int, str]] = None
                           ) -> None:
        """Decorate ``span`` with the BridgeTelemetry counters it fenced.

        ``telem`` leaves may carry a leading requester axis (the N-device
        path returns [N, ...]); counts are summed over it so the span
        describes the whole transaction.  All values are exact integers —
        tests reconcile them bit-exactly against the oracle.  Counters on
        the card come off in one copy.
        """
        telem = to_host(telem)
        a = lambda x: np.asarray(x)  # noqa: E731
        served = int(a(telem.served_total()).sum())
        loop = int(a(telem.loopback_served).sum())
        cw, ccw = telem.wire_pages()
        cw, ccw = int(a(cw).sum()), int(a(ccw).sum())
        intra, inter = telem.tier_pages()
        tier_hops = a(telem.tier_hops).reshape(-1, 2).sum(0)
        args: Dict[str, Any] = {
            "pages_served": served,
            "pages_loopback": loop,
            "pages_spilled": int(a(telem.spilled).sum()),
            "pages_pruned": int(a(telem.pruned).sum()),
            "wire_pages_cw": cw,
            "wire_pages_ccw": ccw,
            "pages_intra_board": int(a(intra).sum()),
            "pages_inter_board": int(a(inter).sum()),
            "board_hop_pages": int(tier_hops[0]),
            "rack_hop_pages": int(tier_hops[1]),
        }
        if page_bytes:
            args["bytes_served"] = served * page_bytes
            args["wire_bytes"] = (cw + ccw) * page_bytes
        tser = a(telem.tenant_served).reshape(-1, telem.max_tenants).sum(0)
        tspill = a(telem.tenant_spilled).reshape(-1, telem.max_tenants).sum(0)
        names = tenant_names or {}
        args["tenant_pages"] = {
            str(names.get(t, t)): int(tser[t])
            for t in range(telem.max_tenants) if tser[t] or tspill[t]}
        span.args.update(args)

    # -------------------------------------------------------------- queries
    def find(self, name: str) -> Optional[Span]:
        """Most recent span with this name (None if absent)."""
        for s in reversed(self.spans):
            if s.name == name:
                return s
        return None

    def find_all(self, name: Optional[str] = None,
                 cat: Optional[str] = None) -> List[Span]:
        return [s for s in self.spans
                if (name is None or s.name == name)
                and (cat is None or s.cat == cat)]

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span.span_id]

    def clear(self) -> None:
        self.spans = []
        self._stack = []
        self._next_id = 0

    # --------------------------------------------------------------- export
    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace dict: ``M`` metadata + one ``X`` event per span."""
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": self.process_name},
        }]
        for s in self.spans:
            args = dict(s.args, span_id=s.span_id, parent_id=s.parent_id)
            if s.end_us is None:
                # Auto-close still-open spans at export time so they show
                # up in the trace (flagged, not silently dropped).  The
                # span itself stays open — export must not mutate it.
                dur = max(self.clock.now_us() - s.start_us, 0.0)
                args["unclosed"] = True
            else:
                dur = s.duration_us
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "ts": round(s.start_us, 3),
                "dur": round(dur, 3),
                "pid": self.pid, "tid": 0,
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"recorder": self.process_name}}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_chrome_trace(), sort_keys=True,
                          indent=indent)

    def write(self, path: str, indent: Optional[int] = 1) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=indent))
            f.write("\n")

