"""Port parity: the training step, reduced granite-3-8b in float32.

The JAX package's ``make_train_state`` gives the state (parameters, AdamW
m, v and count, step); ``weights.train_state_from_reference`` carries it
across, so both packages start from the same state.  The same
``SyntheticLM`` batches (B 4 x S 32) go through the JAX ``build_train_step``
(jitted) and the port's: after one and after three steps the loss, grad
norm, lr, parameters, m, v, count and step agree within 1e-4, also with
``microbatch=2``.  The port's step under ``remat="block"`` (per-layer
activation checkpointing) and ``"none"`` gives bit-identical moments after
a step, so bit-identical gradients.  The launcher and the example run to
their end on the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import OptimConfig as JOptim, RunConfig as JRun
from repro.config import ShapeConfig as JShape
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.train import step as jstep

from repro_torch import configs as tconfigs, tree as ttree, weights
from repro_torch.config import OptimConfig, RunConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.train import step as tstep

ARCH = "granite-3-8b"
BATCH, SEQ = 4, 32
TOL = dict(rtol=1e-4, atol=1e-4)
OPTIM = dict(lr=3e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's other workers keep the cores busy."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def runs(microbatch=1, remat="block"):
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_reduced(ARCH), dtype="float32")
    jrun = JRun(model=jcfg, shape=JShape("t", SEQ, BATCH, "train"),
                optim=JOptim(**OPTIM), microbatch=microbatch)
    trun = RunConfig(model=tcfg, shape=ShapeConfig("t", SEQ, BATCH, "train"),
                     optim=OptimConfig(**OPTIM), microbatch=microbatch,
                     remat=remat)
    return jrun, trun


@pytest.fixture(scope="module")
def start():
    jrun, trun = runs()
    jstate = jstep.make_train_state(jrun, jax.random.key(0))
    return jstate, jax.tree.map(np.asarray, jstate)


def port_state(state_np, trun):
    return weights.train_state_from_reference(state_np, trun.model,
                                              device="cpu")


def run_jax(jrun, jstate, steps):
    fn = jax.jit(jstep.build_train_step(jrun))
    data = JSyntheticLM(jrun.model, BATCH, SEQ, seed=0)
    metrics = []
    for i in range(steps):
        jstate, m = fn(jstate, {k: jax.numpy.asarray(v)
                                for k, v in data.batch_at(i).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, jstate), metrics


def run_port(trun, state, steps):
    fn = tstep.build_train_step(trun)
    data = SyntheticLM(trun.model, BATCH, SEQ, seed=0)
    metrics = []
    for i in range(steps):
        state, m = fn(state, to_device(data.batch_at(i), "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def assert_states_close(got, want_np, trun):
    want = port_state(want_np, trun)
    assert int(got.step) == int(want.step)
    assert int(got.opt.count) == int(want.opt.count)
    for name in ("params", "opt"):
        a = ttree.leaves_with_path(getattr(got, name))
        b = ttree.leaves_with_path(getattr(want, name))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                       err_msg=f"{name}{path}", **TOL)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_reference(start, steps):
    jstate, state_np = start
    jrun, trun = runs()
    want_state, want = run_jax(jrun, jstate, steps)
    got_state, got = run_port(trun, port_state(state_np, trun), steps)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["grad_norm", "loss", "lr", "tokens"]
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)
    assert_states_close(got_state, want_state, trun)
    assert got[-1]["tokens"] == BATCH * SEQ


def test_microbatch_matches_reference(start):
    jstate, state_np = start
    jrun, trun = runs(microbatch=2)
    want_state, want = run_jax(jrun, jstate, 2)
    got_state, got = run_port(trun, port_state(state_np, trun), 2)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)
    assert_states_close(got_state, want_state, trun)


def test_remat_block_and_none_give_identical_gradients(start):
    _, state_np = start
    states = {}
    for remat in ("block", "none"):
        _, trun = runs(remat=remat)
        states[remat], _ = run_port(trun, port_state(state_np, trun), 1)
    for name in ("m", "v"):
        for a, b in zip(ttree.leaves(getattr(states["block"].opt, name)),
                        ttree.leaves(getattr(states["none"].opt, name))):
            assert torch.equal(a, b)


def test_train_launcher_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launcher
    logged = launcher.main(["--arch", ARCH, "--reduced", "--steps", "6",
                            "--batch", "2", "--seq", "16", "--log-every",
                            "3", "--device", "cpu", "--ckpt-dir",
                            str(tmp_path), "--ckpt-every", "3"])
    assert [x["step"] for x in logged] == [3, 6]
    assert all(np.isfinite(x["loss"]) for x in logged)
    out = capsys.readouterr().out
    assert "loss=" in out and "gnorm=" in out and "ms/step" in out
    resumed = launcher.main(["--arch", ARCH, "--reduced", "--steps", "8",
                             "--batch", "2", "--seq", "16", "--device",
                             "cpu", "--ckpt-dir", str(tmp_path),
                             "--resume"])
    assert "resumed from step 6" in capsys.readouterr().out
    assert [x["step"] for x in resumed] == [8]
