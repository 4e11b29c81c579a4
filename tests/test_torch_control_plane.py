"""Port parity of the software control plane.

One seeded sequence of operations drives the JAX package's
``ControlPlane`` and the port's side by side, on the flat 8-node fabric and
on two boards of four: allocation under every policy (and refused ones),
releases (stale handles too), node failures and revivals, step times, link
failures and clears, manual budget overrides, route programs compiled from
placement and from measured telemetry, ``rate_limits``,
``select_channels`` (raw counters, the aggregate, a fitted calibrator) and
``affinity_migration``.  The telemetry is measured: the port's bridge pulls
(CPU tensors) under the plane's current table and program, folded into both
packages' aggregators.  Every output (regions, plans, programs' arrays,
picks, budgets, ``describe()``) and the whole placement state (tables, free
lists, id recycling, the RNG) must be identical after every operation; an
operation that raises must raise the same error in both.  Then the program
verifier's refusal, the heartbeat and ``examples/quickstart_torch.py``.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import control_plane as jcp_mod
from repro.core import perfmodel as jperf
from repro.core import steering as js
from repro.analysis.findings import (ProgramVerificationError as
                                     JVerificationError)
from repro.core.topology import Topology as JTopo
from repro.ft.heartbeat import HeartbeatMonitor as JHeartbeat
from repro.telemetry.aggregate import TelemetryAggregator as JAgg
from repro.telemetry.counters import BridgeTelemetry as JTelemetry

from repro_torch.analysis.findings import ProgramVerificationError
from repro_torch.core import bridge as tbridge
from repro_torch.core import control_plane as tcp_mod
from repro_torch.core import perfmodel as tperf
from repro_torch.core import steering as ts
from repro_torch.core.topology import Topology as TTopo
from repro_torch.ft import HeartbeatMonitor
from repro_torch.telemetry.aggregate import TelemetryAggregator as TAgg
from repro_torch.telemetry.aggregate import to_host

NODES, PPN, LOGICAL = 8, 24, 160
OPS = 220


def jax_device_hw():
    """The reference's TpuHW record with the port's DEVICE_HW values."""
    d = tperf.DEVICE_HW
    return jperf.TpuHW(peak_bf16_tflops=d.peak_bf16_tflops,
                       hbm_gbps=d.hbm_gbps, ici_link_gbps=d.link_gbps,
                       ici_links=d.links, ici_hop_latency_us=d.hop_latency_us,
                       outstanding_pages=d.outstanding_pages)


def host(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_same(got, want, what):
    """An output of the port's plane equal to the reference's."""
    if isinstance(want, jcp_mod.Region):
        assert (got.region_id, got.name, got.policy) == (
            want.region_id, want.name, want.policy), what
        assert np.array_equal(got.page_ids, want.page_ids), what
    elif isinstance(want, list) and want and isinstance(
            want[0], jcp_mod.MigrationStep):
        assert [dataclasses.astuple(s) for s in got] == [
            dataclasses.astuple(s) for s in want], what
    elif hasattr(want, "rank_epoch"):
        for f in ("offsets", "epoch", "live", "rank_epoch"):
            g, w = host(getattr(got, f)), np.asarray(getattr(want, f))
            assert g.shape == w.shape and np.array_equal(g, w), (what, f)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        assert np.array_equal(got, want), what
    else:
        assert got == want, what


def assert_state(tcp, jcp, what):
    """The whole placement state of both planes equal."""
    assert np.array_equal(tcp._home, jcp._home), what
    assert np.array_equal(tcp._slot, jcp._slot), what
    assert tcp._free == jcp._free, what
    assert tcp._free_logical == jcp._free_logical, what
    assert (tcp._next_logical, tcp._next_region) == (
        jcp._next_logical, jcp._next_region), what
    assert tcp._failed_link_direction == jcp._failed_link_direction, what
    assert [dataclasses.astuple(n) for n in tcp.nodes] == [
        dataclasses.astuple(n) for n in jcp.nodes], what
    assert sorted(tcp._regions) == sorted(jcp._regions), what
    for rid, region in jcp._regions.items():
        assert_same(tcp._regions[rid], region, what)
    assert tcp._rng.bit_generator.state == jcp._rng.bit_generator.state, what
    assert tcp.describe() == jcp.describe(), what
    assert tcp.free_logical() == jcp.free_logical(), what
    assert np.array_equal(tcp.occupancy(), jcp.occupancy()), what
    tt, jt = tcp.table(), jcp.table()
    assert np.array_equal(tt.home.numpy(), np.asarray(jt.home)), what
    assert np.array_equal(tt.slot.numpy(), np.asarray(jt.slot)), what


def both(tcp, jcp, method, *args, port_args=None, **kw):
    """Call ``method`` on both planes (the port with ``port_args`` where its
    operands differ); equal results, or the same error from both."""
    targs, tkw = port_args if port_args is not None else (args, kw)
    try:
        want = getattr(jcp, method)(*args, **kw)
    except (RuntimeError, ValueError) as err:
        with pytest.raises(type(err)) as got:
            getattr(tcp, method)(*targs, **tkw)
        assert str(got.value) == str(err), method
        return None, None
    got = getattr(tcp, method)(*targs, **tkw)
    assert_same(got, want, method)
    return got, want


class Loop:
    """The two planes, their aggregators and what the loop measured last."""

    def __init__(self, sizes, seed):
        self.rng = np.random.default_rng(seed)
        jtopo = JTopo.from_sizes(sizes)
        self.ttopo = TTopo.from_sizes(sizes)
        self.jcp = jcp_mod.ControlPlane(NODES, PPN, LOGICAL, seed=seed,
                                        topology=jtopo)
        self.tcp = tcp_mod.ControlPlane(NODES, PPN, LOGICAL, seed=seed,
                                        topology=self.ttopo, device="cpu")
        self.jagg, self.tagg = JAgg(NODES, max_tenants=2), TAgg(
            NODES, max_tenants=2)
        self.telem = None          # the port's last raw counters
        self.programs = None       # (port, reference) last compiled
        self.regions = []          # live and released handles
        self.jcal = jperf.Calibrator(jax_device_hw())
        self.tcal = tperf.Calibrator()

    def measure(self):
        """Pull every node's requests over the plane's table and last
        program (port, CPU) and fold the counters into both aggregators."""
        placed = np.nonzero(self.tcp._home >= 0)[0]
        pool = torch.zeros((NODES * PPN, 1))
        pick = (self.rng.choice(placed, size=(NODES, 12)) if placed.size
                else np.full((NODES, 12), -1))
        pick[self.rng.random(pick.shape) < 0.2] = -1
        ab = self.rng.integers(1, 5, size=NODES).astype(np.int32)
        prog = None if self.programs is None else self.programs[0]
        _, telem = tbridge.pull_pages(
            pool, torch.tensor(pick, dtype=torch.int32), self.tcp.table(),
            num_nodes=NODES, budget=4, active_budget=torch.from_numpy(ab),
            program=prog, collect_telemetry=True, topology=self.ttopo,
            tenant_ids=torch.tensor(pick % 2, dtype=torch.int32),
            max_tenants=2)
        self.telem = telem
        self.tagg.update(telem)
        self.jagg.update(self.jax_telem())
        assert np.array_equal(self.tagg.traffic_matrix(),
                              self.jagg.traffic_matrix())
        assert np.array_equal(self.tagg.distance_pages(),
                              self.jagg.distance_pages())

    def jax_telem(self):
        h = to_host(self.telem)
        return JTelemetry(**{f.name: getattr(h, f.name)
                             for f in dataclasses.fields(h)})

    def telemetry(self, kind):
        """(reference, port) telemetry operands of one kind."""
        if kind == "agg":
            return self.jagg, self.tagg
        if kind == "raw" and self.telem is not None:
            return self.jax_telem(), self.telem
        return None, None

    def fit(self):
        """One calibrator sample, the same features and span for both."""
        if self.programs is None:
            return
        tprog, jprog = self.programs
        budget = int(self.rng.choice([2, 4, 8]))
        kw = dict(rounds=int(self.rng.integers(1, 9)),
                  channels=int(self.rng.choice([1, 2, 4])))
        x = tperf.route_features(tprog, 4096, budget, **kw,
                                 topology=self.ttopo)
        assert np.array_equal(x, jperf.route_features(
            jprog, 4096, budget, **kw, topology=self.jcp.topology))
        span = float(self.rng.uniform(5.0, 200.0))
        assert self.tcal.observe(x, span) == self.jcal.observe(x, span)
        assert np.array_equal(self.tcal.theta, self.jcal.theta)

    def step(self, i):
        rng, tcp, jcp = self.rng, self.tcp, self.jcp
        op = rng.choice(["alloc", "alloc", "release", "fail", "revive",
                         "step_time", "link", "budget", "route", "route",
                         "measure", "rate", "channels", "migrate", "fit"])
        what = f"op {i}: {op}"
        if op == "alloc":
            policy = str(rng.choice(["striped", "hashed", "affinity"]))
            affinity = int(rng.integers(-1, NODES + 1))
            region, _ = both(tcp, jcp, "allocate",
                             int(rng.integers(1, 24)), f"r{i}", policy,
                             affinity)
            if region is not None:
                self.regions.append(region.region_id)
        elif op == "release" and self.regions:
            rid = int(rng.choice(self.regions))
            jreg = jcp._regions.get(rid) or jcp_mod.Region(rid, "stale",
                                                           np.arange(3),
                                                           "striped")
            treg = tcp._regions.get(rid) or tcp_mod.Region(rid, "stale",
                                                           np.arange(3),
                                                           "striped")
            both(tcp, jcp, "release", jreg, port_args=((treg,), {}))
        elif op == "fail" and len(jcp.alive_nodes) > 2:
            both(tcp, jcp, "fail_node", int(rng.choice(jcp.alive_nodes)))
        elif op == "revive":
            dead = [n for n in range(NODES) if not jcp.nodes[n].alive]
            if dead:
                both(tcp, jcp, "revive_node", int(rng.choice(dead)))
        elif op == "step_time":
            node = int(rng.integers(NODES))
            both(tcp, jcp, "record_step_time", node,
                 float(rng.uniform(0.5, 1.0) * (3.0 if node == 5 else 1.0)))
        elif op == "link":
            if rng.random() < 0.5:
                both(tcp, jcp, "report_link_failure",
                     int(rng.choice([1, -1, 2])))
            else:
                both(tcp, jcp, "clear_link_failure")
        elif op == "budget":
            node, b = int(rng.integers(NODES)), int(rng.integers(0, 3))
            jcp.nodes[node].budget = tcp.nodes[node].budget = b
        elif op == "route":
            kind = str(rng.choice(["none", "agg", "raw_vec"]))
            jt, tt = self.telemetry(kind)
            if kind == "raw_vec" and self.telem is not None:
                vec = self.tagg.distance_pages() * rng.integers(0, 2, NODES - 1)
                jt, tt = vec, torch.from_numpy(vec)
            req = (None if rng.random() < 0.7
                   else sorted(rng.choice(NODES, 3, replace=False).tolist()))
            kw = dict(bidirectional=bool(rng.random() < 0.7),
                      prune=bool(rng.random() < 0.8))
            got, want = both(tcp, jcp, "route_program", req, telemetry=jt,
                             port_args=((req,), dict(telemetry=tt, **kw)),
                             **kw)
            if got is not None:
                self.programs = (got, want)
            assert_same(tcp.live_distances(req), jcp.live_distances(req),
                        what)
        elif op == "measure":
            self.measure()
        elif op == "rate":
            jt, tt = self.telemetry(str(rng.choice(["none", "agg", "raw"])))
            static = int(rng.integers(1, 9))
            both(tcp, jcp, "rate_limits", static, telemetry=jt,
                 port_args=((static,), dict(telemetry=tt)))
            assert_same(tcp.detect_stragglers(), jcp.detect_stragglers(),
                        what)
        elif op == "channels":
            jt, tt = self.telemetry(str(rng.choice(["none", "agg", "raw"])))
            budget = int(rng.choice([1, 4, 8, 16]))
            page_bytes = int(rng.choice([4096, 1 << 16, 1 << 20, 1 << 23]))
            tprog, jprog = ((None, None) if self.programs is None
                            or rng.random() < 0.5 else self.programs)
            fitted = self.jcal.fitted and rng.random() < 0.5
            kw = dict(max_channels=int(rng.choice([2, 8])))
            both(tcp, jcp, "select_channels", budget, page_bytes,
                 telemetry=jt, program=jprog,
                 calibrator=self.jcal if fitted else None,
                 port_args=((budget, page_bytes), dict(
                     telemetry=tt, program=tprog,
                     calibrator=self.tcal if fitted else None, **kw)),
                 **kw)
        elif op == "migrate" and self.telem is not None:
            raw = rng.random() < 0.5
            jt, tt = ((self.jagg.traffic_matrix(),
                       torch.from_numpy(self.tagg.traffic_matrix()))
                      if raw else (self.jagg, self.tagg))
            kw = dict(min_share=float(rng.choice([0.2, 0.5])),
                      limit=None if rng.random() < 0.5
                      else int(rng.integers(1, 6)))
            both(tcp, jcp, "affinity_migration", jt,
                 port_args=((tt,), kw), **kw)
        elif op == "fit":
            self.fit()
        assert_state(tcp, jcp, what)
        return op


@pytest.mark.parametrize("sizes", [[NODES], [4, 4]])
def test_control_plane_sequence_matches_reference(sizes, monkeypatch):
    """At least 200 seeded operations on both planes, every output and the
    whole state identical after each; the unfitted ``select_channels``
    prices with the port's DEVICE_HW, given to the reference as its
    TPU_HW."""
    monkeypatch.setattr(jperf, "TPU_HW", jax_device_hw())
    loop = Loop(sizes, seed=len(sizes))
    ops = [loop.step(i) for i in range(OPS)]
    for op in ("alloc", "release", "fail", "revive", "route", "measure",
               "rate", "channels", "migrate", "fit", "link"):
        assert op in ops, op
    assert loop.jcal.fitted and loop.tcal.fitted
    assert np.array_equal(loop.tcal.theta, loop.jcal.theta)
    assert loop.tcal.constants() == loop.jcal.constants()


def test_fitted_channel_pick_matches_reference():
    """A fitted calibrator's pick with the busy wire of a measured pull,
    for both packages: the fitted path needs no patched constants."""
    loop = Loop([NODES], seed=7)
    for _ in range(3):
        loop.jcp.allocate(40, policy="hashed")
        loop.tcp.allocate(40, policy="hashed")
    loop.programs = (loop.tcp.route_program(), loop.jcp.route_program())
    loop.measure()
    for _ in range(6):
        loop.fit()
    assert loop.tcal.fitted
    for budget in (4, 8, 16):
        for page_bytes in (1 << 12, 1 << 20, 1 << 24):
            got = loop.tcp.select_channels(budget, page_bytes, loop.tagg,
                                           calibrator=loop.tcal)
            assert got == loop.jcp.select_channels(
                budget, page_bytes, loop.jagg, calibrator=loop.jcal)


def test_route_program_refuses_a_broken_program():
    """A hand-broken program is refused with the reference's findings, and
    ``verify=False`` installs it as given."""
    jcp = jcp_mod.ControlPlane(NODES, PPN, LOGICAL)
    tcp = tcp_mod.ControlPlane(NODES, PPN, LOGICAL, device="cpu")
    base = ts.bidirectional_program(NODES, device="cpu")
    off = base.offsets.clone()
    off[2] = 5                              # slot 2 serves distance 3
    broken = ts.RouteProgram(off, base.epoch, base.live, base.rank_epoch)
    jbase = js.bidirectional_program(NODES)
    jbroken = js.RouteProgram(offsets=jbase.offsets.at[2].set(5),
                              epoch=jbase.epoch, live=jbase.live,
                              rank_epoch=jbase.rank_epoch)
    with pytest.raises(JVerificationError) as want:
        jcp.route_program(program=jbroken)
    with pytest.raises(ProgramVerificationError) as got:
        tcp.route_program(program=broken)
    assert str(got.value) == str(want.value)
    assert [f.as_dict() for f in got.value.findings] == [
        f.as_dict() for f in want.value.findings]
    assert tcp.route_program(program=broken, verify=False) is broken


def test_heartbeat_matches_reference():
    """The same beats and ticks declare the same nodes dead."""
    rng = np.random.default_rng(3)
    mine, ref = HeartbeatMonitor(6, timeout=5.0), JHeartbeat(6, timeout=5.0)
    for t in np.cumsum(rng.uniform(0.5, 3.0, size=60)):
        for node in rng.choice(6, size=int(rng.integers(0, 4)),
                               replace=False):
            mine.beat(int(node), float(t))
            ref.beat(int(node), float(t))
        assert mine.tick(float(t)) == ref.tick(float(t))
        assert mine.last_seen == ref.last_seen


def test_quickstart_runs_on_the_cpu():
    """``examples/quickstart_torch.py`` step by step on the CPU: the pull
    held to ``pull_pages_ref`` before and after node 2 fails."""
    path = Path(__file__).resolve().parents[1] / "examples" / (
        "quickstart_torch.py")
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(device="cpu") == dict(pages=5, moved=3)


def test_execute_plan_matches_a_step_by_step_copy():
    """A failure plan and a migration plan carried out by one gather and
    one scatter each equal the reference's step-by-step copy of their
    rows; a plan that moves a page it wrote is refused."""
    tcp = tcp_mod.ControlPlane(4, 16, 48, seed=2, device="cpu")
    tcp.allocate(40, policy="hashed")
    pool = torch.randn((64, 3, 2))
    want = pool.clone()
    traffic = np.zeros((4, 4))
    traffic[3, 0] = 9.0                    # node 3 dominates home 0
    for plan in (tcp.affinity_migration(traffic, limit=5), tcp.fail_node(1)):
        assert plan
        for s in plan:
            want[s.new_home * 16 + s.new_slot] = want[
                s.old_home * 16 + s.old_slot]
        tcp_mod.execute_plan(pool, tcp_mod.plan_rows(plan, 16, "cpu"))
        assert torch.equal(pool, want)
    twice = [jcp_mod.MigrationStep(0, 0, 1, 1, 2),
             jcp_mod.MigrationStep(0, 1, 2, 2, 3)]
    with pytest.raises(ValueError, match="moves pool row 18"):
        tcp_mod.plan_rows(twice, 16, "cpu")
    assert tcp_mod.execute_plan(pool, tcp_mod.plan_rows([], 16, "cpu")) is pool
