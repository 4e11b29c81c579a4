"""Port parity of the request-level serving front end: traffic, the
continuous batcher and its decode engines, and the launcher's traffic mode.

* traffic: for several seeds and mixes the port's ``TrafficGenerator``
  (and ``make_request``) yields the reference's requests, the same
  per-(seed, tenant, step) numpy streams;
* the batcher over ``SimulatedDecodeEngine``: the same arrival streams
  (with whale requests, a quota-bound tenant and attempt-bounded shedding)
  through both packages' batchers and orchestrators, QoS and naive
  policies: the same admissions, retirements (slot, tokens, steps), sheds,
  accounting, latency histograms, request spans and flight journal;
* reduced granite-3-8b in float32 through ``ModelDecodeEngine`` on CPU
  tensors: continuous batching equals the port's ``solo_reference`` bit
  for bit under ``local``, ``bridge_pull`` and ``bridge_push`` (1 and 4
  memory nodes), and the port's engine emits the reference engine's tokens
  when both are fed the reference batcher's step inputs, every placement
  (``ring`` too) over a run whose free slots feed token 0 and run their
  lengths past ``max_len``: their writes are dropped as the reference
  drops them.  A token that differs is reported with the port's logits of
  both tokens (a near-tie shows as two close logits);
* the launcher's ``--traffic --metrics --trace-out --debug-bundle`` on the
  CPU, the trace and the bundle read back, and
  ``examples/serve_decode_torch.py`` on the CPU.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import RunConfig as JRunConfig, ShapeConfig as JShape
from repro.core.control_plane import ControlPlane as JCP
from repro.models import transformer as jtransformer
from repro.obs.clock import ManualClock as JClock
from repro.obs.flight import FlightRecorder as JFlight
from repro.obs.trace import TraceRecorder as JTrace
from repro.orchestrator import Orchestrator as JOrc, TenantSpec as JSpec
from repro.serve import batcher as jbatcher
from repro.serve import traffic as jtraffic

from repro_torch import configs as tconfigs, weights
from repro_torch.config import BridgeConfig as TBridge
from repro_torch.config import RunConfig as TRunConfig, ShapeConfig as TShape
from repro_torch.core.control_plane import ControlPlane
from repro_torch.models import transformer as ttransformer
from repro_torch.obs import FlightRecorder, ManualClock, TraceRecorder
from repro_torch.orchestrator import Orchestrator, TenantSpec
from repro_torch.serve import batcher as tbatcher
from repro_torch.serve import traffic as ttraffic

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: on a host whose cores the suite's other workers
    keep busy, these tiny float32 ops run several times faster on one
    thread than on many."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mixes():
    """(seed, [tenant traffic kwargs]) of the parity runs."""
    return [
        (3, [dict(tenant_id=1, rate=1.0, prompt_mean=6, output_mean=5,
                  prompt_max=20, output_max=16),
             dict(tenant_id=2, rate=1.5, prompt_mean=10, output_mean=8,
                  prompt_max=32, output_max=24)]),
        (11, [dict(tenant_id=1, rate=2.0, prompt_max=32, output_max=16,
                   tail=1.3),
              dict(tenant_id=2, rate=5.0, start_step=4, stop_step=9),
              dict(tenant_id=3, rate=0.3, prompt_mean=200, prompt_max=900,
                   vocab=77)]),
        (0, [dict(tenant_id=2, rate=0.5, prompt_mean=32, output_mean=32,
                  prompt_max=64, output_max=64, vocab=49155)]),
    ]


def requests_of(gen, steps):
    return [dataclasses.astuple(r) for s in range(steps)
            for r in gen.arrivals(s)]


@pytest.mark.parametrize("seed,mix", mixes())
def test_traffic_arrivals_match_reference(seed, mix):
    mine = ttraffic.TrafficGenerator(
        [ttraffic.TenantTraffic(**t) for t in mix], seed=seed)
    ref = jtraffic.TrafficGenerator(
        [jtraffic.TenantTraffic(**t) for t in mix], seed=seed)
    got, want = requests_of(mine, 16), requests_of(ref, 16)
    assert got == want and len(got) > 5
    assert mine.generated == ref.generated
    assert mine.total_generated() == ref.total_generated()
    for rid in range(4):
        kw = dict(prompt_len=3 * rid, output_len=rid, arrive_step=rid,
                  seed=seed, vocab=500)
        assert dataclasses.astuple(ttraffic.make_request(rid, 1, **kw)) == \
            dataclasses.astuple(jtraffic.make_request(rid, 1, **kw))
    with pytest.raises(ValueError):
        ttraffic.TenantTraffic(1, rate=1.0, tail=1.0)
    with pytest.raises(ValueError):
        ttraffic.TrafficGenerator([ttraffic.TenantTraffic(1, rate=1.0)] * 2)


# ---------------------------------------------------------------------------
# the batcher over the simulated engine
# ---------------------------------------------------------------------------

SPECS = [dict(tenant_id=1, name="chat", qos="interactive", share=4.0),
         dict(tenant_id=2, name="crawl", qos="batch", share=1.0,
              page_quota=24),
         dict(tenant_id=3, name="scan", qos="best_effort", share=0.5)]


def side(port: bool, policy, num_slots, *, max_attempts=0, recorder=True):
    """(batcher, engine) of one package over a 4-node pool of 16 slots a
    node, on a manual clock."""
    CP, Orc, Spec, Flight, Clock, Trace, mod = (
        (ControlPlane, Orchestrator, TenantSpec, FlightRecorder,
         ManualClock, TraceRecorder, tbatcher) if port else
        (JCP, JOrc, JSpec, JFlight, JClock, JTrace, jbatcher))
    kw = dict(device="cpu") if port else {}
    orc = Orc(CP(4, 16, num_logical=64, **kw), budget=8, control_period=2,
              migrate=False, flight=Flight(Clock()))
    for spec in SPECS:
        orc.register(Spec(**spec))
    clock = Clock(tick_us=0.0)
    bat = mod.ContinuousBatcher(
        orc, num_slots=num_slots, page_tokens=8, policy=policy,
        max_admit_attempts=max_attempts, clock=clock,
        recorder=Trace(clock) if recorder else None)
    return bat, mod.SimulatedDecodeEngine(num_slots, vocab=997)


def retired(bat):
    return [(s.req.req_id, s.slot, s.lease_id, s.admit_step, s.arrive_us,
             s.admit_us, s.first_token_us, tuple(s.out)) for s in bat.retired]


@pytest.mark.parametrize("policy,max_attempts", [("qos", 0), ("naive", 0),
                                                 ("qos", 3)])
@pytest.mark.parametrize("seed,mix", mixes()[:2])
def test_simulated_serving_matches_reference(seed, mix, policy,
                                             max_attempts):
    runs = []
    for port, tr in ((True, ttraffic), (False, jtraffic)):
        bat, eng = side(port, policy, 6, max_attempts=max_attempts)
        gen = tr.TrafficGenerator([tr.TenantTraffic(**t) for t in mix],
                                  seed=seed)
        loop = tbatcher.serve_loop if port else jbatcher.serve_loop
        # whales: never admissible (whole pool) and beyond a quota
        bat.submit(tr.make_request(10_000, 1, prompt_len=600, output_len=8))
        bat.submit(tr.make_request(10_001, 2, prompt_len=150, output_len=50))
        res = loop(bat, eng, gen, steps=12, step_us=25.0)
        runs.append((res, bat))
    (res, bat), (jres, jbat) = runs
    # the port's loop adds control and decode-step spans to its trace
    spans = [s for s in bat.recorder.spans if s.cat == "request"]
    assert [(s.name, s.start_us, s.end_us, s.args) for s in spans] == [
        (s.name, s.start_us, s.end_us, s.args) for s in jbat.recorder.spans]
    assert res == jres and res["completed"] > 6
    assert retired(bat) == retired(jbat)
    assert bat.accounting() == jbat.accounting()
    assert bat.shed == jbat.shed and bat.shed
    assert bat.describe() == jbat.describe()
    assert bat.registry.to_text() == jbat.registry.to_text()
    assert bat.orc.flight.to_jsonl() == jbat.orc.flight.to_jsonl()
    assert not bat.orc.leases and bat.orc.held_pages(1) == 0
    rid = retired(bat)[0][0]
    why, jwhy = bat.why(rid), jbat.why(rid)
    assert why["decisions"] == jwhy["decisions"]
    assert {s["cat"] for s in why["spans"]} >= {"request", "round",
                                                 "control"}
    for seq in bat.retired:
        assert seq.out == tbatcher.solo_reference(
            tbatcher.SimulatedDecodeEngine(6, vocab=997), seq.req,
            slot=seq.slot)


# ---------------------------------------------------------------------------
# the model engine: reduced granite-3-8b, float32, CPU tensors
# ---------------------------------------------------------------------------

BATCH, MAX_LEN, PAGE_TOKENS = 4, 24, 8


@pytest.fixture(scope="module")
def granite():
    jcfg = dataclasses.replace(jconfigs.get_reduced("granite-3-8b"),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_reduced("granite-3-8b"),
                               dtype="float32")
    params = jtransformer.init_params(jcfg, jax.random.key(0))
    t_params = weights.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    # (id, tenant, prompt, output); the last arrives late and runs long
    reqs = [(i, 1 + i % 2, 2 + i, 3 + i) for i in range(6)] + [
        (6, 1, 10, 12)]
    return jcfg, tcfg, params, t_params, reqs


class LogitEngine(tbatcher.ModelDecodeEngine):
    """The port's engine, keeping each step's logits for the report of a
    token that differs."""

    def __init__(self, run, *args, **kw):
        super().__init__(run, *args, **kw)
        cfg, ops = run.model, self.cache_ops

        def step(params, state, tokens):
            self.logits, state = ttransformer.decode_step(cfg, params, state,
                                                          tokens, ops)
            return torch.argmax(self.logits, -1).to(torch.int32), state

        self._step = step


def port_engine(tcfg, t_params, kv, num_nodes=1):
    run = TRunConfig(model=tcfg, shape=TShape("t", MAX_LEN, BATCH, "decode"),
                     kv_placement=kv, bridge=TBridge())
    return LogitEngine(run, t_params, batch=BATCH, max_len=MAX_LEN,
                       page_tokens=PAGE_TOKENS, num_nodes=num_nodes,
                       dtype=torch.float32, device="cpu")


def drive(bat, eng, reqs):
    """Submit ``reqs`` (the last one after 12 steps, so the run outlasts
    ``max_len`` and the slots freed early run their lengths past it) and
    step until every request retires; returns every step's (tokens,
    resets, emitted)."""
    for r in reqs[:-1]:
        bat.submit(r)
    steps = []
    while bat.in_flight() or len(steps) < 12:
        if len(steps) == 12:
            bat.submit(reqs[-1])
        bat.control()
        if bat.active_count():
            tokens, resets = bat.step_inputs()
            emitted = eng.step(tokens, resets)
            steps.append((tokens.copy(), list(resets), emitted))
            bat.observe(emitted)
        assert len(steps) < 200
    return steps


def make_requests(mod, vocab, reqs):
    return [mod.make_request(i, t, prompt_len=p, output_len=o, seed=7,
                             vocab=vocab) for i, t, p, o in reqs]


@pytest.mark.parametrize("kv,num_nodes", [
    ("local", 1), ("bridge_pull", 1), ("bridge_pull", 4), ("bridge_push", 1),
    ("bridge_push", 4)])
def test_continuous_matches_solo_on_the_model(granite, kv, num_nodes):
    """Continuous batching is a pure scheduling change: every retired
    sequence equals its solo decode on a fresh engine, bit for bit."""
    _, tcfg, _, t_params, reqs = granite
    bat, _ = side(True, "qos", BATCH, recorder=False)
    eng = port_engine(tcfg, t_params, kv, num_nodes)
    steps = drive(bat, eng, make_requests(ttraffic, tcfg.vocab_size, reqs))
    assert sum(bat.completed.values()) == len(reqs)
    assert any(s.req.req_id >= BATCH for s in bat.retired), "no slot reuse"
    assert len(steps) > MAX_LEN, "free slots must run past max_len"
    assert eng.steps == len(steps)
    ref_eng = port_engine(tcfg, t_params, kv, num_nodes)
    for seq in bat.retired:
        assert seq.out == tbatcher.solo_reference(ref_eng, seq.req,
                                                  slot=seq.slot), \
            f"{kv}: req {seq.req.req_id} diverged from its solo decode"


@pytest.mark.parametrize("kv", ["local", "ring", "bridge_pull",
                                "bridge_push"])
def test_engine_matches_reference_engine(granite, kv):
    """The reference batcher's step inputs (admissions resetting slots,
    free slots fed token 0 with lengths past max_len) into both packages'
    engines: the same tokens every step, every slot."""
    jcfg, tcfg, params, t_params, reqs = granite
    run = JRunConfig(model=jcfg, shape=JShape("t", MAX_LEN, BATCH, "decode"),
                     kv_placement=kv)
    jeng = jbatcher.ModelDecodeEngine(run, params, batch=BATCH,
                                      max_len=MAX_LEN,
                                      page_tokens=PAGE_TOKENS,
                                      dtype=jnp.float32)
    bat, _ = side(False, "qos", BATCH, recorder=False)
    steps = drive(bat, jeng, make_requests(jtraffic, jcfg.vocab_size, reqs))
    assert len(steps) > MAX_LEN
    eng = port_engine(tcfg, t_params, kv)
    for i, (tokens, resets, want) in enumerate(steps):
        got = eng.step(tokens, resets)
        for slot in np.nonzero(got != want)[0]:
            row = eng.logits[slot]
            pytest.fail(
                f"{kv} step {i} slot {slot}: port token {got[slot]} "
                f"(logit {float(row[got[slot]]):.7g}), reference token "
                f"{want[slot]} (port's logit {float(row[want[slot]]):.7g})")
    assert int(eng.state["lengths"].max()) > MAX_LEN


# ---------------------------------------------------------------------------
# the launcher's traffic mode on the CPU
# ---------------------------------------------------------------------------

def test_launcher_traffic_mode_on_cpu(tmp_path):
    trace, bundle = tmp_path / "trace.json", tmp_path / "bundle.zip"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-3-8b", "--reduced", "--device", "cpu", "--traffic",
         "--kv", "bridge_pull", "--num-nodes", "2", "--batch", "4",
         "--max-len", "48", "--traffic-steps", "6", "--traffic-rate", "0.7",
         "--metrics", "--trace-out", str(trace), "--debug-bundle",
         str(bundle)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert "policy=qos device=cpu" in out and "tokens/s)" in out
    assert "interactive:" in out and "batch:" in out
    assert "host us of batcher.control()" in out
    assert "serve_request_latency_us_p99" in out
    events = json.loads(trace.read_text())["traceEvents"]
    cats = {e.get("cat") for e in events}
    assert {"control", "round", "request"} <= cats
    with zipfile.ZipFile(bundle) as z:
        assert sorted(z.namelist()) == ["describe.txt", "journal.jsonl",
                                        "metrics.txt", "trace.json"]
        journal = z.read("journal.jsonl").decode()
    recs = FlightRecorder.from_jsonl(journal)
    assert recs.records("lease_grant") and recs.records("cp_init")
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-3-8b", "--reduced", "--traffic", "--device", "cuda"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    if not torch.cuda.is_available():
        assert bad.returncode != 0 and "no CUDA device" in bad.stderr


def test_serve_decode_example_runs_on_the_cpu():
    """``examples/serve_decode_torch.py`` on the CPU: the three placements
    decode the same tokens, the two-tenant pull equals them and its
    counters attribute pages to both tenants."""
    path = REPO / "examples" / "serve_decode_torch.py"
    spec = importlib.util.spec_from_file_location("serve_decode_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(device="cpu")
    assert out["tokens"].shape == (mod.BATCH, mod.STEPS)
    assert out["served"][0] > 0 and out["served"][1] > 0
    assert set(out["windows"]) == {0, 1}
