"""Port parity of the observability plane: metrics, SLOs, the sentinel,
traces and the flight journal's serde.

The same feeds go through the JAX package's ``repro.obs`` and the port's
``repro_torch.obs``:

* the registry: counters, gauges and log-bucketed histograms under the
  same series (hostile label values too): identical text exposition,
  snapshot and per-QoS quantiles; ``observe_telemetry`` /
  ``observe_aggregator`` of measured counters (the port's bridge pulls on
  CPU tensors, the reference given the same counts);
* ``SLOMonitor`` burn rates and the ``Sentinel``'s alerts (latency shift,
  calibration drift with its calibrator reset, SLO burn, telemetry
  conservation on tampered aggregates), counted and journaled alike;
* traces under a ``ManualClock``: nested spans, explicit request spans,
  telemetry annotations; the Chrome-trace JSON byte for byte; a span's
  fence walks nested tensors (CPU tensors need no wait);
* the flight journal: JSONL round trips, the reference's journal read by
  the port and the port's by the reference, truncation refused;
* ``program_digest`` / ``program_to_dict`` of every route-program
  constructor equal to the reference's, and ``program_from_dict`` round
  trips on an explicit device.
"""
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import perfmodel as jperf
from repro.core import steering as js
from repro.core.topology import Topology as JTopo
from repro.obs import detect as jdetect
from repro.obs import flight as jflight
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.obs.clock import ManualClock as JClock
from repro.telemetry.aggregate import TelemetryAggregator as JAgg
from repro.telemetry.counters import BridgeTelemetry as JTelemetry

from repro_torch.core import bridge as tbridge
from repro_torch.core import perfmodel as tperf
from repro_torch.core import steering as ts
from repro_torch.core.memport import MemPortTable
from repro_torch.core.topology import Topology as TTopo
from repro_torch.obs import (FlightRecorder, Histogram, JournalTruncatedError,
                             ManualClock, MetricsRegistry, SLOMonitor,
                             Sentinel, TraceRecorder, flight, program_digest)
from repro_torch.obs import trace as ttrace
from repro_torch.telemetry.aggregate import TelemetryAggregator as TAgg
from repro_torch.telemetry.aggregate import to_host

from test_torch_control_plane import jax_device_hw

NODES = 8


def measured_telemetry(seed, topo=None):
    """One 8-node pull's counters (port, CPU tensors) and the same counts
    as the reference's BridgeTelemetry."""
    rng = np.random.default_rng(seed)
    table = MemPortTable.striped(96, NODES, 12, device="cpu")
    want = rng.integers(0, 96, size=(NODES, 10)).astype(np.int32)
    want[rng.random(want.shape) < 0.2] = -1
    _, telem = tbridge.pull_pages(
        torch.zeros((96, 1)), torch.from_numpy(want), table,
        num_nodes=NODES, budget=4,
        active_budget=torch.from_numpy(rng.integers(1, 5, NODES).astype(
            np.int32)),
        collect_telemetry=True, topology=topo,
        tenant_ids=torch.from_numpy(want % 3), max_tenants=4)
    h = to_host(telem)
    return telem, JTelemetry(**{f.name: getattr(h, f.name)
                                for f in dataclasses.fields(h)})


# ---------------------------------------------------------------- metrics

def test_registry_text_and_quantiles_match_reference():
    rng = np.random.default_rng(0)
    regs = (MetricsRegistry(), jmetrics.MetricsRegistry())
    for reg in regs:
        reg.counter("pages_total", tenant="a\\b", qos='x"y\nz').inc(3)
    for i in range(400):
        name = str(rng.choice(["lat_us", "ttft_us"]))
        qos = str(rng.choice(["interactive", "batch", "best_effort"]))
        v = float(rng.lognormal(4.0, 1.5))
        c, g = float(rng.integers(0, 9)), float(rng.normal())
        for reg in regs:
            reg.histogram(name, lo=1.0, qos=qos).record(v)
            reg.counter("events_total", kind=str(i % 3)).inc(c)
            reg.gauge("level", node=str(i % 4)).set(g)
    mine, ref = regs
    assert mine.to_text() == ref.to_text()
    assert mine.snapshot() == ref.snapshot()
    for name in ("lat_us", "ttft_us"):
        assert mine.family_quantiles(name) == ref.family_quantiles(name)
    with pytest.raises(TypeError):
        mine.gauge("events_total", kind="0")
    h, jh = Histogram(), jmetrics.Histogram()
    for v in rng.exponential(50.0, size=1000).tolist() + [0.0, 1e12]:
        h.record(v)
        jh.record(v)
    assert np.array_equal(h.counts, jh.counts)
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    assert np.isnan(Histogram().quantile(0.5))


@pytest.mark.parametrize("sizes", [[NODES], [4, 4]])
def test_observe_telemetry_matches_reference(sizes):
    """Counters of measured pulls folded into both registries (the
    telemetry families) and both aggregators (the gauges)."""
    regs = (MetricsRegistry(), jmetrics.MetricsRegistry())
    aggs = (TAgg(NODES, page_bytes=4096, max_tenants=4),
            JAgg(NODES, page_bytes=4096, max_tenants=4))
    specs = {0: SimpleNamespace(qos="interactive")}     # others: unknown
    for seed in range(4):
        telem, jtelem = measured_telemetry(
            seed, TTopo.from_sizes(sizes) if len(sizes) > 1 else None)
        regs[0].observe_telemetry(telem, page_bytes=4096, specs=specs)
        regs[1].observe_telemetry(jtelem, page_bytes=4096, specs=specs)
        aggs[0].update(telem)
        aggs[1].update(jtelem)
        regs[0].observe_aggregator(aggs[0])
        regs[1].observe_aggregator(aggs[1])
    assert regs[0].to_text() == regs[1].to_text()
    assert 'bridge_tenant_pages_total{qos="unknown",tenant="1"}' in (
        regs[0].to_text())


def test_slo_monitor_matches_reference():
    rng = np.random.default_rng(1)
    mons = (SLOMonitor(window=32, registry=MetricsRegistry()),
            jmetrics.SLOMonitor(window=32,
                                registry=jmetrics.MetricsRegistry()))
    for _ in range(300):
        tid, lat = int(rng.integers(0, 3)), float(rng.uniform(0, 200))
        slo = float(rng.choice([0.0, 100.0, 150.0]))
        for m in mons:
            m.record(tid, lat, slo)
    assert mons[0].describe() == mons[1].describe()
    assert mons[0].registry.to_text() == mons[1].registry.to_text()
    assert SLOMonitor().burn_rate(7) == 0.0


# ---------------------------------------------------------------- sentinel

def test_sentinel_alerts_match_reference():
    """The same latency, residual, SLO and telemetry feeds: the same
    alerts, counters, calibrator resets and journal records."""
    hw = jax_device_hw()
    cals = (tperf.Calibrator(), jperf.Calibrator(hw))
    rng = np.random.default_rng(2)
    for i in range(12):
        x = np.array([1.0 + i % 3, 0.0, 0.5 * i, 2.0, 1.0])
        assert cals[0].observe(x, 300.0 + i) == cals[1].observe(x, 300.0 + i)
    slos = (SLOMonitor(window=16), jmetrics.SLOMonitor(window=16))
    regs = (MetricsRegistry(), jmetrics.MetricsRegistry())
    recs = (FlightRecorder(ManualClock()), jflight.FlightRecorder(JClock()))
    sents = [cls(registry=reg, flight=rec, calibrator=cal, slo=slo,
                 window=8)
             for cls, reg, rec, cal, slo in zip(
                 (Sentinel, jdetect.Sentinel), regs, recs, cals, slos)]
    for i in range(120):
        shift = 2.5 if 40 <= i < 70 else 1.0
        measured = float(rng.uniform(90, 110)) * shift
        resid = float(rng.uniform(1, 5)) * (200.0 if 80 <= i < 100 else 1.0)
        lat = float(rng.uniform(0, 300))
        for s, slo in zip(sents, slos):
            slo.record(1, lat, 120.0 if i < 60 else 400.0)
            s.observe_latency(measured, predicted_us=100.0,
                              residual_us=resid)
            s.check_slo()
    telem, jtelem = measured_telemetry(5)
    aggs = (TAgg(NODES, max_tenants=4), JAgg(NODES, max_tenants=4))
    aggs[0].update(telem)
    aggs[1].update(jtelem)
    for agg in aggs:
        agg.served[3] += 5.0                  # breaks served == parts
    for s, agg in zip(sents, aggs):
        s.check_telemetry(agg)
    for agg in aggs:
        agg.loopback[:] = -1.0                # negative counter
    for s, agg in zip(sents, aggs):
        s.check_telemetry(agg)
    mine, ref = sents
    assert [dataclasses.asdict(a) for a in mine.alerts] == [
        dataclasses.asdict(a) for a in ref.alerts]
    assert {a.kind for a in mine.alerts} == {
        "latency_shift", "calibration_drift", "slo_burn", "conservation"}
    assert mine.describe() == ref.describe()
    assert regs[0].to_text() == regs[1].to_text()
    assert recs[0].to_jsonl() == recs[1].to_jsonl()
    assert recs[0].records("calibrator_refit")


# ---------------------------------------------------------------- traces

def sample_trace(rec, telem):
    with rec.span("transfer:demo", scenario="demo", pages=16,
                  arr=np.arange(3)) as t:
        for r in range(2):
            with rec.span(f"round:{r}", "round", index=np.int64(r)):
                with rec.span("phase:gather", "phase"):
                    pass
        rec.annotate(t, rounds=2, mean=np.float32(0.5))
    rec.annotate_telemetry(t, telem, page_bytes=64,
                           tenant_names={1: "chat"})
    rec.record_span("req7", start_us=1.5, end_us=40.25, tenant=1)
    with rec.span("open"):
        return rec.to_json(indent=1)


def test_chrome_trace_matches_reference():
    telem, jtelem = measured_telemetry(3)
    mine = sample_trace(TraceRecorder(ManualClock()), telem)
    ref = sample_trace(jtrace.TraceRecorder(JClock()), jtelem)
    assert mine == ref
    doc = json.loads(mine)
    events = doc["traceEvents"]
    assert events[0]["ph"] == "M"
    spans = {e["name"]: e for e in events[1:]}
    assert all(e["ph"] == "X" for e in events[1:])
    assert spans["round:1"]["args"]["parent_id"] == (
        spans["transfer:demo"]["args"]["span_id"])
    assert spans["open"]["args"]["unclosed"] is True
    assert spans["transfer:demo"]["args"]["tenant_pages"]
    rec = TraceRecorder(ManualClock())
    sample_trace(rec, telem)
    assert rec.find("round:1").parent_id == rec.find("transfer:demo").span_id
    assert [s.name for s in rec.children(rec.find("round:0"))] == [
        "phase:gather"]


def test_fence_walks_nested_tensors():
    """A fence names trees of dicts, lists and dataclasses: every tensor
    in them is found (on the CPU nothing waits)."""
    telem, _ = measured_telemetry(4)
    prog = ts.bidirectional_program(NODES, device="cpu")
    tree = {"a": [torch.ones(2), (telem, prog)], "b": 3}
    found = list(ttrace._tensors(tree))
    assert len(found) == 1 + 12 + 4
    rec = TraceRecorder(ManualClock())
    with rec.span("step", fence=tree) as sp:
        pass
    assert sp.end_us is not None and sp.duration_us > 0


# ---------------------------------------------------------------- journal

def journal_pair():
    recs = (FlightRecorder(ManualClock()), jflight.FlightRecorder(JClock()))
    for rec in recs:
        rec.record("cp_init", num_nodes=4, state={"home": np.arange(3)})
        rec.epoch = 2
        rec.record("admission", request_id=5, tenant_id=np.int64(1),
                   status="admitted", share=np.float64(0.25),
                   flags=[np.bool_(True)])
        rec.record("alert", alert_kind="slo_burn", value=2.5)
    return recs


def test_journal_jsonl_round_trips_between_packages():
    mine, ref = journal_pair()
    text = mine.to_jsonl()
    assert text == ref.to_jsonl()
    back = FlightRecorder.from_jsonl(ref.to_jsonl())
    assert back.to_jsonl() == text
    assert jflight.FlightRecorder.from_jsonl(text).to_jsonl() == text
    assert [r.to_json() for r in back.for_request(5)] == [
        r.to_json() for r in ref.for_request(5)]
    lines = text.splitlines()
    for broken in ("\n".join(lines[:-1]), "\n".join(lines[1:]),
                   "\n".join(lines + ['{"kind": "x"}']),
                   "\n".join([lines[0], "{not json", lines[-1]])):
        with pytest.raises(JournalTruncatedError):
            FlightRecorder.from_jsonl(broken)
    bounded = FlightRecorder(ManualClock(), capacity=2)
    for i in range(5):
        bounded.record("refit", i=i)
    assert len(bounded) == 2 and bounded.dropped_total == 3
    with pytest.raises(JournalTruncatedError):
        flight.replay(bounded, device="cpu")


def programs(topo_sizes=(4, 4)):
    """(name, port program, reference program) of every constructor."""
    w = np.array([5.0, 0.0, 2.0, 9.0, 0.0, 1.0, 3.0])
    ttopo, jtopo = (TTopo.from_sizes(list(topo_sizes)),
                    JTopo.from_sizes(list(topo_sizes)))
    dev = dict(device="cpu")
    yield ("uni", ts.unidirectional_program(NODES, **dev),
           js.unidirectional_program(NODES))
    yield ("uni-ccw", ts.unidirectional_program(NODES, -1, **dev),
           js.unidirectional_program(NODES, -1))
    bi, jbi = ts.bidirectional_program(NODES, **dev), js.bidirectional_program(
        NODES)
    yield "bi", bi, jbi
    yield ("pruned", ts.pruned_program(bi, [1, 3, 6]),
           js.pruned_program(jbi, [1, 3, 6]))
    yield ("balanced", ts.load_balanced_program(NODES, w, **dev),
           js.load_balanced_program(NODES, w))
    yield ("link", ts.link_avoiding_program(NODES, 1, **dev),
           js.link_avoiding_program(NODES, 1))
    yield ("hier", ts.hierarchical_program(ttopo, **dev),
           js.hierarchical_program(jtopo))


def test_program_digest_matches_reference():
    digests = set()
    for name, prog, jprog in programs():
        assert flight.program_digest(prog) == jflight.program_digest(jprog), \
            name
        assert program_digest(prog) == program_digest(prog.to("cpu"))
        d = flight.program_to_dict(prog)
        assert d == jflight.program_to_dict(jprog), name
        back = flight.program_from_dict(d, "cpu")
        assert back.device.type == "cpu" and back.offsets.dtype == torch.int32
        assert flight.program_digest(back) == flight.program_digest(prog)
        digests.add(flight.program_digest(prog))
    # the program avoiding a failed clockwise link is the counter-clockwise
    # one: six distinct programs
    assert len(digests) == 6
