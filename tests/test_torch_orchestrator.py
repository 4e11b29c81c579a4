"""Port parity of the orchestrator and the control plane's flight journal.

One seeded sequence of operations drives the JAX package's
``Orchestrator`` and the port's side by side, on a flat 8-node pool and on
two boards of four: tenant registrations (interactive, batch and
best-effort classes, quotas, SLOs), lease requests (queued and not, with
request ids), releases, ``refit_windows`` from queue depths and control
steps.  Each step's telemetry is measured: the port's bridge pulls (CPU
tensors) of the requests its orchestrator composed, under its table,
route program and ``active_budget``, the counters handed to both
orchestrators with the step's span latency.  Admissions, leases, windows,
composed requests, budgets, programs, reports, ``describe()``, the metrics
text and the **flight journals** (``to_jsonl()`` under a ``ManualClock``)
must be identical after every operation; the port's ``replay`` then
re-executes its own journal.  The reference's perfmodel prices with the
port's ``DEVICE_HW`` (its ``TPU_HW`` replaced, as in
``test_torch_control_plane``).  The control plane's seeded sequence of
that test is journaled on both packages too and the journals compared.
"""
import dataclasses
import functools
import io
import json
import zipfile

import numpy as np
import pytest
import torch

from repro.core import control_plane as jcp_mod
from repro.core import perfmodel as jperf
from repro.core.topology import Topology as JTopo
from repro.obs.clock import ManualClock as JClock
from repro.obs.flight import FlightRecorder as JFlight
from repro.orchestrator import Orchestrator as JOrc
from repro.orchestrator import TenantSpec as JSpec
from repro.telemetry.counters import BridgeTelemetry as JTelemetry

from repro_torch.core import bridge as tbridge
from repro_torch.core import control_plane as tcp_mod
from repro_torch.core.topology import Topology as TTopo
from repro_torch.obs import ManualClock, replay
from repro_torch.obs.flight import FlightRecorder, placement_digest
from repro_torch.orchestrator import Orchestrator, TenantSpec
from repro_torch.telemetry.aggregate import to_host

from test_torch_control_plane import Loop, assert_same, assert_state, \
    jax_device_hw

NODES, PPN, LOGICAL = 8, 24, 160
OPS = 120
PAGE_BYTES = 1 << 16
TENANTS = [dict(tenant_id=0, name="chat", qos="interactive", share=3.0,
                slo_round_us=900.0),
           dict(tenant_id=1, name="crawl", qos="batch", share=1.0,
                page_quota=60),
           dict(tenant_id=2, name="scan", qos="best_effort", share=0.5,
                priority=2),
           dict(tenant_id=3, name="batch2", qos="batch", share=2.0,
                priority=1, page_quota=40)]


@pytest.fixture
def device_hw(monkeypatch):
    """The reference prices with the port's DEVICE_HW."""
    hw = jax_device_hw()
    monkeypatch.setattr(jperf, "TPU_HW", hw)
    monkeypatch.setattr(jperf, "predict_transfer_latency_us",
                        functools.partial(jperf.predict_transfer_latency_us,
                                          hw=hw))
    return hw


def jax_telem(telem):
    h = to_host(telem)
    return JTelemetry(**{f.name: getattr(h, f.name)
                         for f in dataclasses.fields(h)})


def same_schedule(got, want):
    return (got.windows, got.order, got.budget) == (
        want.windows, want.order, want.budget)


class Pair:
    """The two orchestrators over planes of one size and fabric."""

    def __init__(self, sizes, seed, hw):
        self.rng = np.random.default_rng(seed)
        self.ttopo = TTopo.from_sizes(sizes)
        jcp = jcp_mod.ControlPlane(NODES, PPN, LOGICAL, seed=seed,
                                   topology=JTopo.from_sizes(sizes))
        tcp = tcp_mod.ControlPlane(NODES, PPN, LOGICAL, seed=seed,
                                   topology=self.ttopo, device="cpu")
        kw = dict(budget=4, page_bytes=PAGE_BYTES, control_period=3,
                  default_term=6, queue_limit=6, queue_max_attempts=4,
                  queue_ttl_steps=5, migration_limit=4)
        self.j = JOrc(jcp, flight=JFlight(JClock()), **kw)
        self.t = Orchestrator(tcp, flight=FlightRecorder(ManualClock()),
                              **kw)
        cal = jperf.Calibrator(hw)
        self.j.calibrator = self.j.sentinel.calibrator = cal
        self.requests = 0

    def both(self, method, *args, port_args=None, **kw):
        """Call ``method`` on both orchestrators (the port with
        ``port_args`` where its operands differ): both results, or the
        same error from both."""
        targs = args if port_args is None else port_args
        try:
            want = getattr(self.j, method)(*args, **kw)
        except (KeyError, RuntimeError, ValueError) as err:
            with pytest.raises(type(err)) as got:
                getattr(self.t, method)(*targs, **kw)
            assert str(got.value) == str(err), method
            return None, None
        return getattr(self.t, method)(*targs, **kw), want

    def register(self, **spec):
        got, want = self.both("register", JSpec(**spec),
                              port_args=(TenantSpec(**spec),))
        if want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)

    def backlogs(self):
        """Per-tenant, per-node queues of each tenant's leased page ids."""
        out = {}
        for tid in self.j.specs:
            ids = [int(p) for l in self.j.tenant_leases(tid)
                   for p in l.region.page_ids]
            rows = [[] for _ in range(NODES)]
            for i, p in enumerate(ids):
                rows[i % NODES].append(p)
            out[tid] = rows
        return out

    def measure(self):
        """Compose this step's requests on both; pull them (port, CPU) and
        return (reference, port) counters and a span latency."""
        backlogs = self.backlogs()
        want, lane, taken = self.t.compose_requests(backlogs)
        jwant, jlane, jtaken = self.j.compose_requests(backlogs)
        assert taken == jtaken
        assert np.array_equal(want.numpy(), jwant)
        assert np.array_equal(lane.numpy(), jlane)
        budget = self.t.active_budget()
        assert budget.dtype == torch.int32
        assert np.array_equal(budget.numpy(), self.j.active_budget())
        program = self.t.route_program()
        assert_same(program, self.j.route_program(), "route_program")
        _, telem = tbridge.pull_pages(
            torch.zeros((NODES * PPN, 1)), want, self.t.table(),
            num_nodes=NODES, budget=4, active_budget=budget,
            program=program, collect_telemetry=True, topology=self.ttopo,
            tenant_ids=lane, max_tenants=self.t.max_tenants)
        return jax_telem(telem), telem

    def op(self, i):
        rng, j, t = self.rng, self.j, self.t
        op = str(rng.choice(["lease", "lease", "lease", "release", "step",
                             "step", "refit"]))
        what = f"op {i}: {op}"
        if op == "lease":
            tid = int(rng.integers(0, 5))       # 4 is never registered
            pages = int(rng.integers(0, 50))
            kw = dict(policy=str(rng.choice(["affinity", "striped",
                                             "hashed"])),
                      term=None if rng.random() < 0.5
                      else int(rng.integers(1, 8)),
                      auto_renew=bool(rng.random() < 0.3),
                      queue=bool(rng.random() < 0.7),
                      request_id=self.requests)
            self.requests += 1
            got, want = self.both("request_lease", tid, pages, **kw)
            if want is not None:
                assert (got[0].status, got[0].reason) == (
                    want[0].status, want[0].reason), what
                assert (got[1] is None) == (want[1] is None), what
                if want[1] is not None:
                    assert got[1].lease_id == want[1].lease_id, what
                    assert_same(got[1].region, want[1].region, what)
                    assert (got[1].expires_step
                            == want[1].expires_step), what
        elif op == "release" and j.leases:
            lid = int(rng.choice(sorted(j.leases)))
            t.release_lease(t.leases[lid])
            j.release_lease(j.leases[lid])
        elif op == "step":
            jtel, ttel = self.measure()
            span = float(rng.uniform(200.0, 2000.0))
            rounds = int(rng.integers(1, 4))
            got = t.step(ttel, measured_round_us=span, rounds=rounds)
            want = j.step(jtel, measured_round_us=span, rounds=rounds)
            assert_same(got.pop("migrations"), want.pop("migrations"), what)
            assert got == want, what
        elif op == "refit":
            demand = {tid: float(rng.integers(0, 20)) for tid in j.specs}
            got, want = self.both("refit_windows", demand)
            assert same_schedule(got, want), what
        assert same_schedule(t.schedule, j.schedule), what
        assert sorted(t.leases) == sorted(j.leases), what
        assert t.admission.describe() == j.admission.describe(), what
        assert t.channels == j.channels, what
        assert_state(t.cp, j.cp, what)
        return op


@pytest.mark.parametrize("sizes", [[NODES], [4, 4]])
def test_orchestrator_sequence_matches_reference(sizes, device_hw):
    pair = Pair(sizes, seed=11 + len(sizes), hw=device_hw)
    for spec in TENANTS:
        pair.register(**spec)
    pair.register(tenant_id=1, name="again")     # duplicate id: refused
    ops = [pair.op(i) for i in range(OPS)]
    for op in ("lease", "release", "step", "refit"):
        assert op in ops, op
    j, t = pair.j, pair.t
    assert j.calibrator.fitted and t.calibrator.fitted
    assert t.metrics.to_text() == j.metrics.to_text()
    assert t.describe() == j.describe()
    journal = t.flight.to_jsonl()
    assert journal == j.flight.to_jsonl()
    kinds = {r.kind for r in t.flight.records()}
    for kind in ("cp_init", "register", "admission", "lease_grant",
                 "lease_release", "allocate", "release", "route_program",
                 "select_channels", "refit", "step_report"):
        assert kind in kinds, kind
    # the port's replay re-executes its own journal, read back from JSONL
    res = replay(FlightRecorder.from_jsonl(journal), device="cpu")
    assert res.placement_digest == placement_digest(t.cp)
    assert res.programs and res.placements and res.refits
    # why(): the admission chain of a granted request, in both
    granted = next(r.request_id for r in t.flight.records("lease_grant")
                   if r.request_id is not None)
    assert [r.to_json() for r in t.flight.why(granted)] == [
        r.to_json() for r in j.flight.why(granted)]


def test_control_plane_journal_matches_reference(device_hw):
    """The control plane's seeded sequence of ``test_torch_control_plane``
    with a flight recorder on each plane: the two journals are equal line
    for line (every allocate, release, failure plan, link event, program
    install, channel pick and migration)."""
    loop = Loop([4, 4], seed=5)
    jrec, trec = JFlight(JClock()), FlightRecorder(ManualClock())
    loop.jcp.attach_flight(jrec)
    loop.tcp.attach_flight(trec)
    for i in range(150):
        loop.step(i)
    assert trec.to_jsonl() == jrec.to_jsonl()
    kinds = {r.kind for r in trec.records()}
    for kind in ("cp_init", "allocate", "route_program", "select_channels",
                 "migration", "fail_node"):
        assert kind in kinds, kind


def test_outputs_live_on_the_plane_device():
    """``table``, ``route_program``, ``active_budget`` and
    ``compose_requests`` hand the datapath int32 tensors on the plane's
    device; a debug bundle holds the reference's members."""
    cp = tcp_mod.ControlPlane(4, 16, 48, device="cpu")
    orc = Orchestrator(cp, budget=8, flight=FlightRecorder(ManualClock()))
    orc.register(TenantSpec(1, "chat", qos="interactive", share=3.0))
    orc.register(TenantSpec(2, "crawl", share=1.0))
    _, lease = orc.request_lease(1, 6, request_id=9)
    ids = lease.region.page_ids.tolist()
    want, lane, taken = orc.compose_requests({1: [ids[:3], ids[3:]]})
    for x in (want, lane, orc.active_budget(), orc.table().home,
              orc.route_program().offsets):
        assert x.device.type == "cpu" and x.dtype == torch.int32
    assert taken == {1: 3, 2: 0}
    assert want[0, :3].tolist() == ids[:3] and lane[0, :3].tolist() == [1] * 3
    buf = io.BytesIO()
    orc.dump_debug_bundle(buf)
    with zipfile.ZipFile(buf) as z:
        assert sorted(z.namelist()) == ["describe.txt", "journal.jsonl",
                                        "metrics.txt"]
        lines = z.read("journal.jsonl").decode().splitlines()
    assert json.loads(lines[-1])["kind"] == "journal_seal"
    assert orc.flight.why(9)[0].kind == "route_program"
