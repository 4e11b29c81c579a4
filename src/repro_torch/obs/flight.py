"""Control-plane flight recorder: journal every decision, replay it later
(the port's copy of ``repro.obs.flight``).

A :class:`FlightRecorder` is an append-only bounded journal of typed
:class:`DecisionRecord`\\ s — one per control-plane action: route-program
installs (with variant + verifier digest), ``select_channels`` picks (with
the calibrator inputs that priced them), allocate/release/migration plans,
admission admit/queue/reject/evict verdicts, scheduler window refits,
lease grant/renew/expiry, node fail/revive, and sentinel alerts
(:mod:`repro_torch.obs.detect`).  Each record is stamped with a monotonic
sequence number, an :class:`~repro_torch.obs.clock.Clock` timestamp, and causal
refs: the trace span open when the decision was taken and the telemetry
epoch (aggregator fold count) that motivated it.

Two things fall out of journaling *inputs*, not just outputs:

* :func:`replay` re-executes a journal against a fresh
  :class:`~repro_torch.core.control_plane.ControlPlane` / scheduler and asserts
  the resulting :class:`~repro_torch.core.steering.RouteProgram` digests,
  placements and window schedules are **bit-identical** — a postmortem
  journal is a reproducible test.  Divergence raises
  :class:`ReplayDivergenceError`; a cut-off or corrupted journal raises
  :class:`JournalTruncatedError` at load time instead of silently
  replaying a prefix.
* :meth:`FlightRecorder.why` walks the causal refs backwards from a
  serving request id to the admission verdict, lease grant, page
  placement and the route program governing its traffic.

The JSONL export ends in a ``journal_seal`` line (record count + seq
range) so truncation is detectable; decision payloads are plain JSON
(numpy arrays listed, route programs via :func:`program_to_dict`).

The journal is host data: a route program on the card is copied off it to
be listed or hashed, and :func:`program_digest` hashes the same
dtype-normalised bytes in the same field order as the reference, so both
packages give one program one digest.  :func:`replay` rebuilds programs on
the replayed plane's device.
"""

from __future__ import annotations

import hashlib
import json
from collections import deque
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.steering import RouteProgram, to_numpy
from repro_torch.obs.clock import Clock, MonotonicClock
from repro_torch.telemetry.aggregate import to_host
from repro_torch.telemetry.counters import BridgeTelemetry


class JournalError(RuntimeError):
    """Base class for flight-journal failures."""


class JournalTruncatedError(JournalError):
    """The journal is cut off, corrupted, or missing its seal/genesis."""


class ReplayDivergenceError(JournalError):
    """Re-execution produced a different program/placement/schedule."""


# --------------------------------------------------------------------- records
@dataclass
class DecisionRecord:
    """One journaled control-plane decision."""

    seq: int                      # monotonic per-recorder sequence number
    t_us: float                   # obs.Clock timestamp
    kind: str                     # "allocate" / "route_program" / ...
    detail: Dict[str, Any] = field(default_factory=dict)
    span_id: Optional[int] = None    # trace span open when decided
    epoch: int = 0                   # telemetry epoch (aggregator folds)
    request_id: Optional[int] = None  # serving request this decision served

    def to_json(self) -> Dict[str, Any]:
        return {"seq": self.seq, "t_us": self.t_us, "kind": self.kind,
                "span_id": self.span_id, "epoch": self.epoch,
                "request_id": self.request_id, "detail": self.detail}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "DecisionRecord":
        return DecisionRecord(
            seq=int(d["seq"]), t_us=float(d["t_us"]), kind=str(d["kind"]),
            detail=dict(d.get("detail") or {}), span_id=d.get("span_id"),
            epoch=int(d.get("epoch", 0)), request_id=d.get("request_id"))


def _jsonable(v):
    """Deep-convert numpy scalars/arrays so the journal is plain JSON."""
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


# ----------------------------------------------------------- program serde
#: (field, numpy dtype) normalization used by both the digest and the
#: JSON round-trip — matches steering._program's construction dtypes.
_PROGRAM_FIELDS = (("offsets", np.int32), ("epoch", np.int32),
                   ("live", np.bool_), ("rank_epoch", np.int32))


def program_to_dict(program) -> Dict[str, Any]:
    """Serialize a RouteProgram's arrays to plain JSON lists."""
    return {name: np.asarray(to_numpy(getattr(program, name)),
                             dtype).tolist()
            for name, dtype in _PROGRAM_FIELDS}


def program_from_dict(d: Dict[str, Any], device) -> RouteProgram:
    """Rebuild a RouteProgram on ``device`` with the canonical dtypes."""
    def field(name, dtype):
        return torch.tensor(np.asarray(d[name], dtype), device=device)

    return RouteProgram(
        offsets=field("offsets", np.int32), epoch=field("epoch", np.int32),
        live=field("live", np.bool_),
        rank_epoch=field("rank_epoch", np.int32))


def program_digest(program) -> str:
    """sha256 over the program's dtype-normalized array bytes.

    Bit-identical programs — and only those — share a digest; this is the
    verifier-install fingerprint the journal records and replay asserts.
    """
    h = hashlib.sha256()
    for name, dtype in _PROGRAM_FIELDS:
        a = np.ascontiguousarray(
            np.asarray(to_numpy(getattr(program, name)), dtype))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def route_variant(*, compiled: bool, hierarchical: bool, failed_link: bool,
                  bidirectional: bool, measured: bool) -> str:
    """Human label for which compile branch produced a route program."""
    if not compiled:
        return "installed"
    if hierarchical and bidirectional and not failed_link:
        return "hierarchical"
    if failed_link:
        return "link_avoiding"
    if measured and bidirectional:
        return "load_balanced"
    return "bidirectional" if bidirectional else "unidirectional"


# --------------------------------------------- telemetry/calibrator snapshots
# The control plane journals the *exact read-set* of each decision — the
# few aggregator views it consumed — so replay can rebuild an equivalent
# shim without re-running the datapath.

def route_telemetry_snapshot(telemetry) -> Optional[Dict[str, Any]]:
    """The read-set of ``ControlPlane._compile_route_program``."""
    if telemetry is None:
        return None
    if isinstance(telemetry, BridgeTelemetry):
        telemetry = to_host(telemetry)
    dist = to_numpy(telemetry.distance_pages()
                    if hasattr(telemetry, "distance_pages")
                    else telemetry).astype(float).reshape(-1)
    drops = 0.0
    for names in (("last_spilled", "last_pruned"), ("spilled", "pruned")):
        if any(hasattr(telemetry, f) for f in names):
            drops = sum(float(to_numpy(getattr(telemetry, f)).sum())
                        for f in names if hasattr(telemetry, f))
            break
    intra = (np.asarray(telemetry.distance_intra_pages(),
                        float).reshape(-1).tolist()
             if hasattr(telemetry, "distance_intra_pages") else None)
    return {"dist": dist.tolist(), "drops": drops, "dist_intra": intra}


def route_telemetry_shim(snap: Optional[Dict[str, Any]]):
    """An aggregator stand-in reproducing a journaled compile read-set."""
    if snap is None:
        return None
    dist = np.asarray(snap["dist"], float)
    shim = SimpleNamespace(
        distance_pages=lambda: dist,
        last_spilled=np.asarray([float(snap.get("drops", 0.0))]),
        last_pruned=np.zeros((1,)))
    if snap.get("dist_intra") is not None:
        intra = np.asarray(snap["dist_intra"], float)
        shim.distance_intra_pages = lambda: intra
    return shim


def wire_telemetry_snapshot(telemetry) -> Optional[Dict[str, Any]]:
    """The read-set of ``ControlPlane.select_channels``."""
    if telemetry is None:
        return None
    if isinstance(telemetry, BridgeTelemetry):
        telemetry = to_host(telemetry)
    if hasattr(telemetry, "link_pages"):          # TelemetryAggregator
        lp = telemetry.link_pages()
        cw, ccw = float(lp["cw"]), float(lp["ccw"])
        dist = np.asarray(telemetry.distance_pages(), float)
        served = np.asarray(telemetry.served, float)
    else:                                         # raw BridgeTelemetry
        cw = float(np.asarray(telemetry.epoch_cw).sum())
        ccw = float(np.asarray(telemetry.epoch_ccw).sum())
        s = np.asarray(telemetry.slot_served)
        dist = s.reshape((-1, s.shape[-1])).sum(0).astype(float)
        served = np.asarray(telemetry.served_total(), float).reshape(-1)
    return {"cw": cw, "ccw": ccw, "dist": dist.tolist(),
            "served": served.tolist()}


def wire_telemetry_shim(snap: Optional[Dict[str, Any]]):
    if snap is None:
        return None
    dist = np.asarray(snap["dist"], float)
    return SimpleNamespace(
        link_pages=lambda: {"cw": float(snap["cw"]),
                            "ccw": float(snap["ccw"])},
        distance_pages=lambda: dist,
        served=np.asarray(snap["served"], float))


def calibrator_snapshot(calibrator) -> Optional[Dict[str, Any]]:
    """The read-set of ``select_channels``'s calibrator pricing."""
    if calibrator is None:
        return None
    if not calibrator.fitted:
        return {"fitted": False}
    hw = calibrator.hw()
    return {"fitted": True,
            "hop_us": float(hw.hop_latency_us),
            "link_gbps": float(hw.link_gbps),
            "chunk_us": float(calibrator.chunk_overhead_us)}


def calibrator_shim(snap: Optional[Dict[str, Any]]):
    if snap is None:
        return None
    if not snap.get("fitted"):
        return SimpleNamespace(fitted=False)
    return SimpleNamespace(
        fitted=True,
        hw=lambda: SimpleNamespace(
            hop_latency_us=float(snap["hop_us"]),
            link_gbps=float(snap["link_gbps"])),
        chunk_overhead_us=float(snap["chunk_us"]))


# ------------------------------------------------------------------ recorder
class FlightRecorder:
    """Append-only bounded journal of control-plane decisions.

    ``capacity`` bounds memory: the oldest records fall off (counted in
    :attr:`dropped_total`) — a journal whose genesis ``cp_init`` record was
    dropped refuses to replay.  ``trace=`` links each record to the trace
    span open at decision time; :attr:`epoch` is stamped by the owner
    (the orchestrator sets it to the aggregator's fold count).
    """

    def __init__(self, clock: Optional[Clock] = None, *,
                 capacity: int = 65536, trace=None):
        self.clock = clock if clock is not None else MonotonicClock()
        self.capacity = int(capacity)
        self.trace = trace
        self.epoch = 0
        self.dropped_total = 0
        self._records: deque = deque()
        self._next_seq = 0

    def __len__(self) -> int:
        return len(self._records)

    # ---------------------------------------------------------------- append
    def record(self, kind: str, *, request_id: Optional[int] = None,
               **detail) -> DecisionRecord:
        span_id = None
        if self.trace is not None and getattr(self.trace, "_stack", None):
            span_id = self.trace._stack[-1].span_id
        rec = DecisionRecord(
            seq=self._next_seq, t_us=float(self.clock.now_us()), kind=kind,
            detail={k: _jsonable(v) for k, v in detail.items()},
            span_id=span_id, epoch=self.epoch, request_id=request_id)
        self._next_seq += 1
        self._records.append(rec)
        if len(self._records) > self.capacity:
            self._records.popleft()
            self.dropped_total += 1
        return rec

    # --------------------------------------------------------------- queries
    def records(self, kind: Optional[str] = None) -> List[DecisionRecord]:
        if kind is None:
            return list(self._records)
        return [r for r in self._records if r.kind == kind]

    def for_request(self, request_id: int) -> List[DecisionRecord]:
        return [r for r in self._records if r.request_id == request_id]

    def why(self, request_id: int) -> List[DecisionRecord]:
        """The causal chain behind one serving request, in seq order.

        Directly-stamped records (admission verdict, lease grant/release)
        plus the decisions they reference: the allocate/release of the
        lease's region and the route-program install governing the bridge
        when the request was admitted.
        """
        own = [r for r in self._records if r.request_id == request_id]
        if not own:
            return []
        out = {r.seq: r for r in own}
        region_ids = {r.detail["region_id"] for r in own
                      if "region_id" in r.detail}
        first_seq = min(out)
        governing = None
        for r in self._records:
            if (r.kind in ("allocate", "release")
                    and r.detail.get("region_id") in region_ids):
                out[r.seq] = r
            if r.kind == "route_program" and r.seq < first_seq:
                governing = r
        if governing is not None:
            out[governing.seq] = governing
        return [out[s] for s in sorted(out)]

    # ----------------------------------------------------------------- JSONL
    def to_jsonl(self) -> str:
        lines = [json.dumps(r.to_json(), sort_keys=True)
                 for r in self._records]
        first = self._records[0].seq if self._records else 0
        last = self._records[-1].seq if self._records else -1
        lines.append(json.dumps(
            {"kind": "journal_seal", "count": len(self._records),
             "first_seq": first, "last_seq": last,
             "dropped": self.dropped_total}, sort_keys=True))
        return "\n".join(lines) + "\n"

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    @classmethod
    def from_jsonl(cls, text: str, *, clock: Optional[Clock] = None
                   ) -> "FlightRecorder":
        """Parse a JSONL journal; raises :class:`JournalTruncatedError`
        on a missing/wrong seal, a seq gap, or undecodable lines."""
        recs: List[DecisionRecord] = []
        seal = None
        for i, line in enumerate(text.splitlines()):
            if not line.strip():
                continue
            if seal is not None:
                raise JournalTruncatedError(
                    f"line {i}: records after the journal seal")
            try:
                d = json.loads(line)
            except json.JSONDecodeError as e:
                raise JournalTruncatedError(
                    f"line {i}: undecodable journal line ({e})") from None
            if d.get("kind") == "journal_seal":
                seal = d
                continue
            try:
                recs.append(DecisionRecord.from_json(d))
            except (KeyError, TypeError, ValueError) as e:
                raise JournalTruncatedError(
                    f"line {i}: malformed record ({e})") from None
        if seal is None:
            raise JournalTruncatedError("journal has no seal (truncated?)")
        if seal.get("count") != len(recs):
            raise JournalTruncatedError(
                f"seal says {seal.get('count')} records, found {len(recs)}")
        if recs:
            if (seal.get("first_seq") != recs[0].seq
                    or seal.get("last_seq") != recs[-1].seq):
                raise JournalTruncatedError("seal seq range mismatch")
            for a, b in zip(recs, recs[1:]):
                if b.seq != a.seq + 1:
                    raise JournalTruncatedError(
                        f"seq gap: {a.seq} -> {b.seq}")
        out = cls(clock=clock, capacity=max(len(recs), 1))
        out._records.extend(recs)
        out._next_seq = (recs[-1].seq + 1) if recs else 0
        out.dropped_total = int(seal.get("dropped", 0))
        return out

    @classmethod
    def load(cls, path: str, *, clock: Optional[Clock] = None
             ) -> "FlightRecorder":
        with open(path) as f:
            return cls.from_jsonl(f.read(), clock=clock)


# -------------------------------------------------------------------- replay
@dataclass
class ReplayResult:
    """What :func:`replay` re-executed and verified."""

    ops: int = 0
    programs: int = 0
    placements: int = 0
    releases: int = 0
    channel_picks: int = 0
    migrations: int = 0
    refits: int = 0
    failures: int = 0
    placement_digest: str = ""
    plane: Any = None


def _serialize_plan(plan) -> List[List[int]]:
    return [[int(s.page_id), int(s.old_home), int(s.old_slot),
             int(s.new_home), int(s.new_slot)] for s in plan]


def _diverge(rec: DecisionRecord, what: str, want, got):
    raise ReplayDivergenceError(
        f"replay diverged at seq {rec.seq} ({rec.kind}): {what} "
        f"recorded {want!r}, replayed {got!r}")


def _build_plane(detail: Dict[str, Any], device):
    from repro_torch.core.control_plane import ControlPlane
    from repro_torch.core.topology import Topology

    hw = detail.get("topo_hw") or []
    kw = dict(zip(("board_hop_us", "rack_hop_us",
                   "board_link_gbps", "rack_link_gbps"), hw))
    topo = Topology.from_sizes(detail["group_sizes"], **kw)
    return ControlPlane(int(detail["num_nodes"]),
                        int(detail["pages_per_node"]),
                        int(detail["num_logical"]),
                        seed=int(detail.get("seed", 0)), topology=topo,
                        device=device)


def _restore_state(cp, state: Dict[str, Any]) -> Dict[int, Any]:
    """Restore a cp_init placement snapshot; returns live region handles."""
    from repro_torch.core.control_plane import Region

    cp._home = np.asarray(state["home"], np.int64)
    cp._slot = np.asarray(state["slot"], np.int64)
    cp._free = [list(map(int, f)) for f in state["free"]]
    cp._free_logical = list(map(int, state["free_logical"]))
    cp._next_logical = int(state["next_logical"])
    cp._next_region = int(state["next_region"])
    for node, alive in zip(cp.nodes, state["alive"]):
        node.alive = bool(alive)
    cp._failed_link_direction = state.get("failed_link")
    if state.get("rng_state") is not None:
        cp._rng.bit_generator.state = state["rng_state"]
    cp._regions = {}
    regions: Dict[int, Any] = {}
    for rid_s, r in (state.get("regions") or {}).items():
        reg = Region(int(rid_s), r["name"],
                     np.asarray(r["page_ids"], np.int64), r["policy"])
        cp._regions[reg.region_id] = reg
        regions[reg.region_id] = reg
    return regions


def placement_digest(cp) -> str:
    """sha256 over the placement table (logical -> home/slot)."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(cp._home, np.int64).tobytes())
    h.update(np.ascontiguousarray(cp._slot, np.int64).tobytes())
    return h.hexdigest()[:16]


def replay(journal, pool=None, topology=None, *,
           device="cuda") -> ReplayResult:
    """Re-execute a journal against a fresh control plane; assert equality.

    ``journal`` is a :class:`FlightRecorder`, an iterable of
    :class:`DecisionRecord`, or a path to a JSONL file.  The journal must
    begin with the ``cp_init`` genesis record (a bounded journal that
    dropped it cannot replay).  ``pool``/``topology`` override the
    re-executed plane (for what-if replays); by default the genesis
    snapshot rebuilds it exactly, its programs on ``device``.

    Every effectful record is re-executed and compared bit-for-bit:
    allocations (page ids, homes, slots), releases, failure remap plans,
    route-program digests, channel picks, migration plans, and scheduler
    window refits.  Verdict-only records (admission, lease lifecycle,
    alerts) are causal metadata — their placement effects replay through
    the allocate/release records they reference.
    """
    from repro_torch.orchestrator.scheduler import WeightedFairScheduler
    from repro_torch.orchestrator.tenants import TenantSpec

    if isinstance(journal, str):
        journal = FlightRecorder.load(journal)
    records = (journal.records() if isinstance(journal, FlightRecorder)
               else list(journal))
    if not records:
        raise JournalTruncatedError("empty journal")
    if records[0].kind != "cp_init":
        raise JournalTruncatedError(
            f"journal does not begin with cp_init (first record is "
            f"{records[0].kind!r} at seq {records[0].seq}; genesis dropped?)")

    res = ReplayResult()
    cp = pool
    regions: Dict[int, Any] = {}
    specs: List[TenantSpec] = []
    for rec in records:
        d = rec.detail
        res.ops += 1
        if rec.kind == "cp_init":
            if cp is None:
                cp = _build_plane(d, device) if topology is None else None
                if cp is None:
                    from repro_torch.core.control_plane import ControlPlane
                    cp = ControlPlane(
                        int(d["num_nodes"]), int(d["pages_per_node"]),
                        int(d["num_logical"]), seed=int(d.get("seed", 0)),
                        topology=topology, device=device)
            regions = _restore_state(cp, d["state"])
        elif cp is None:
            raise JournalTruncatedError(
                f"record {rec.kind!r} at seq {rec.seq} before cp_init")
        elif rec.kind == "allocate":
            reg = cp.allocate(int(d["num_pages"]), name=d.get("name", ""),
                              policy=d["policy"],
                              affinity=int(d.get("affinity", 0)))
            got = {"region_id": reg.region_id,
                   "page_ids": np.asarray(reg.page_ids).tolist(),
                   "homes": [int(cp._home[i]) for i in reg.page_ids],
                   "slots": [int(cp._slot[i]) for i in reg.page_ids]}
            for k, v in got.items():
                if v != d[k]:
                    _diverge(rec, k, d[k], v)
            regions[reg.region_id] = reg
            res.placements += 1
        elif rec.kind == "release":
            reg = regions.pop(int(d["region_id"]), None)
            if reg is None:
                _diverge(rec, "region", d["region_id"], None)
            cp.release(reg)
            res.releases += 1
        elif rec.kind == "fail_node":
            plan = _serialize_plan(cp.fail_node(int(d["node"])))
            if plan != d["plan"]:
                _diverge(rec, "remap plan", d["plan"], plan)
            res.failures += 1
        elif rec.kind == "revive_node":
            cp.revive_node(int(d["node"]))
        elif rec.kind == "link_failure":
            cp.report_link_failure(int(d["direction"]))
        elif rec.kind == "link_clear":
            cp.clear_link_failure()
        elif rec.kind == "route_program":
            if d["compiled"]:
                prog = cp.route_program(
                    requesters=d.get("requesters"),
                    bidirectional=d["bidirectional"], prune=d["prune"],
                    telemetry=route_telemetry_shim(d.get("telemetry")),
                    verify=d.get("verified", True))
            else:
                prog = cp.route_program(
                    program=program_from_dict(d["program"], cp.device),
                    verify=d.get("verified", True))
            got = program_digest(prog)
            if got != d["digest"]:
                _diverge(rec, "program digest", d["digest"], got)
            res.programs += 1
        elif rec.kind == "select_channels":
            prog = (program_from_dict(d["program"], cp.device)
                    if d.get("program") is not None else None)
            pick = cp.select_channels(
                int(d["budget"]), int(d["page_bytes"]),
                telemetry=wire_telemetry_shim(d.get("telemetry")),
                max_channels=int(d["max_channels"]), program=prog,
                calibrator=calibrator_shim(d.get("calibrator")))
            if pick != d["pick"]:
                _diverge(rec, "channel pick", d["pick"], pick)
            res.channel_picks += 1
        elif rec.kind == "migration":
            plan = _serialize_plan(cp.affinity_migration(
                np.asarray(d["traffic"], float),
                min_share=float(d["min_share"]),
                limit=None if d.get("limit") is None else int(d["limit"])))
            if plan != d["plan"]:
                _diverge(rec, "migration plan", d["plan"], plan)
            res.migrations += 1
        elif rec.kind == "register":
            specs.append(TenantSpec(
                tenant_id=int(d["tenant_id"]), name=d["name"], qos=d["qos"],
                page_quota=int(d.get("page_quota", 0)),
                share=float(d.get("share", 1.0)),
                priority=int(d.get("priority", 0)),
                slo_round_us=float(d.get("slo_round_us", 0.0))))
        elif rec.kind == "refit":
            sched = WeightedFairScheduler(int(d["budget"]))
            mode = d.get("mode", "compile")
            if mode == "telemetry":
                shim = SimpleNamespace(
                    tenant_demand=lambda: np.asarray(d["demand"], float),
                    last_tenant_spilled=np.asarray(d["spilled"], float))
                got = sched.refit(specs, shim, int(d["num_nodes"]),
                                  saturated=list(d.get("saturated", [])))
            elif mode == "windows":
                got = sched.compile(specs, {int(k): float(v) for k, v
                                            in d["demand"].items()})
            else:
                got = sched.compile(specs)
            want = {int(k): int(v) for k, v in d["windows"].items()}
            if dict(got.windows) != want:
                _diverge(rec, "windows", want, dict(got.windows))
            res.refits += 1
        # admission / lease_* / alert / step_report / calibrator_refit:
        # causal metadata — effects replay via the records they reference.
    res.placement_digest = placement_digest(cp)
    res.plane = cp
    return res


__all__ = [
    "DecisionRecord",
    "FlightRecorder",
    "JournalError",
    "JournalTruncatedError",
    "ReplayDivergenceError",
    "ReplayResult",
    "calibrator_shim",
    "calibrator_snapshot",
    "placement_digest",
    "program_digest",
    "program_from_dict",
    "program_to_dict",
    "replay",
    "route_telemetry_shim",
    "route_telemetry_snapshot",
    "route_variant",
    "wire_telemetry_shim",
    "wire_telemetry_snapshot",
]
