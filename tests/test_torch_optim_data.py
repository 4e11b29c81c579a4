"""Port parity: AdamW, its schedule and clipping, the data pipeline.

The same numpy inputs go through the JAX package's ``optim.adamw`` and the
port's: ``adamw_update`` (parameters in float32 and bf16, nonzero moments,
clipping on and off), ``lr_schedule`` over warmup, cosine and past the end,
``global_norm``; float32 within 1e-6 relative, a bf16 parameter within one
bf16 ulp.  The port's ``SyntheticLM.batch_at`` gives the reference's numpy
arrays bit for bit for several steps and seeds, and its prefetcher keeps
the order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import OptimConfig as JOptimConfig
from repro.config import RunConfig as JRunConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as jadamw

from repro_torch import configs as tconfigs, tree as ttree
from repro_torch.config import OptimConfig, RunConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, to_device
from repro_torch.optim import adamw


def arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(7, 5)) * scale).astype(np.float32),
            "b": (rng.normal(size=(5,)) * scale).astype(np.float32),
            "layers": [(rng.normal(size=(3, 4)) * scale).astype(np.float32),
                       (rng.normal(size=(6,)) * scale).astype(np.float32)]}


def to_jax(tree, bf16=()):
    return {k: ([jnp.asarray(x) for x in v] if isinstance(v, list)
                else jnp.asarray(v, jnp.bfloat16 if k in bf16 else
                                 jnp.float32))
            for k, v in tree.items()}


def to_torch(tree, bf16=()):
    return {k: ([torch.from_numpy(x.copy()) for x in v]
                if isinstance(v, list)
                else torch.from_numpy(v.copy()).to(
                    torch.bfloat16 if k in bf16 else torch.float32))
            for k, v in tree.items()}


def close(got, want, bf16=False):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if bf16:
        # one bf16 ulp of the value
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip", [1.0, 0.0, 50.0])
def test_adamw_update_matches_reference(clip):
    kw = dict(lr=3e-3, warmup_steps=3, total_steps=20, grad_clip=clip,
              weight_decay=0.1)
    jcfg, tcfg = JOptimConfig(**kw), OptimConfig(**kw)
    p, g = arrays(0), arrays(1, scale=4.0)
    m, v = arrays(2), arrays(3)
    v = jax.tree.map(np.abs, v)
    bf16 = ("w",)
    jstate = jadamw.AdamWState(m=to_jax(m), v=to_jax(v),
                               count=jnp.asarray(4, jnp.int32))
    tstate = adamw.AdamWState(m=to_torch(m), v=to_torch(v),
                              count=torch.tensor(4, dtype=torch.int32))
    jp, js, jm = jadamw.adamw_update(jcfg, to_jax(g), jstate, to_jax(p, bf16))
    tp, ts, tm = adamw.adamw_update(tcfg, to_torch(g), tstate,
                                    to_torch(p, bf16))
    assert int(ts.count) == int(js.count) == 5
    for name in ("grad_norm", "lr"):
        close(tm[name], jm[name])
    for tree_t, tree_j in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for (path, a), b in zip(ttree.leaves_with_path(tree_t),
                                jax.tree.leaves(tree_j)):
            close(a, b, bf16=(tree_t is tp and path == "['w']"))
    assert tp["w"].dtype == torch.bfloat16


def test_adamw_init_and_in_place_update():
    params = to_torch(arrays(4))
    state = adamw.adamw_init(params)
    assert all(x.dtype == torch.float32 and not x.any()
               for x in ttree.leaves(state.m) + ttree.leaves(state.v))
    assert state.count.dtype == torch.int32 and int(state.count) == 0
    w = params["w"]
    new_p, new_s, _ = adamw.adamw_update(OptimConfig(), to_torch(arrays(5)),
                                         state, params)
    # the reference donates; the port updates the same tensors
    assert new_p["w"] is w and new_s.m["w"] is state.m["w"]
    assert int(new_s.count) == 1


def test_lr_schedule_matches_reference():
    for kw in (dict(lr=1e-3, warmup_steps=10, total_steps=100),
               dict(lr=3e-4, warmup_steps=0, total_steps=1),
               dict(lr=2.0, warmup_steps=7, total_steps=7)):
        jcfg, tcfg = JOptimConfig(**kw), OptimConfig(**kw)
        for s in (0, 1, 5, 6, 7, 10, 11, 50, 99, 100, 150):
            got = adamw.lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32))
            want = jadamw.lr_schedule(jcfg, jnp.asarray(s, jnp.int32))
            assert got.dtype == torch.float32
            close(got, want)


def test_global_norm_and_clip_bound():
    g = arrays(6, scale=30.0)
    close(adamw.global_norm(to_torch(g)), jadamw.global_norm(to_jax(g)))
    cfg = OptimConfig(lr=1.0, warmup_steps=0, total_steps=10, grad_clip=1.0,
                      weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    state = adamw.adamw_init(params)
    _, _, metrics = adamw.adamw_update(
        cfg, {"w": torch.tensor([100.0, 0.0, 0.0])}, state, params)
    assert float(metrics["grad_norm"]) == pytest.approx(100.0)


def test_adamw_reduces_quadratic_loss():
    cfg = OptimConfig(lr=0.1, warmup_steps=1, total_steps=100,
                      weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.adamw_init(params)
    for _ in range(60):
        params, state, _ = adamw.adamw_update(cfg, {"w": 2 * params["w"]},
                                               state, params)
    assert float(params["w"].abs().max()) < 0.5
    assert int(state.count) == 60


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma3-12b"])
def test_synthetic_batches_bit_identical_to_reference(arch):
    for seed in (0, 7, 123):
        for full in (False, True):
            jcfg = (jconfigs.get_config(arch) if full
                    else jconfigs.get_reduced(arch))
            tcfg = (tconfigs.get_config(arch) if full
                    else tconfigs.get_reduced(arch))
            assert tcfg.vocab_size == jcfg.vocab_size
            want = JSyntheticLM(jcfg, batch=3, seq_len=33, seed=seed)
            got = SyntheticLM(tcfg, batch=3, seq_len=33, seed=seed)
            for step in (0, 1, 5, 1000):
                a, b = got.batch_at(step), want.batch_at(step)
                assert sorted(a) == sorted(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
    it = got.iterate(start_step=5)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  want.batch_at(5)["tokens"])


def test_prefetcher_preserves_order_and_batches_reach_the_device():
    cfg = tconfigs.get_reduced("granite-3-8b")
    data = SyntheticLM(cfg, batch=1, seq_len=8)
    direct = [data.batch_at(i)["tokens"] for i in range(5)]
    pre = Prefetcher(data.iterate(), depth=3)
    got = [next(pre) for _ in range(5)]
    pre.close()
    for d, g in zip(direct, got):
        np.testing.assert_array_equal(d, g["tokens"])
    batch = to_device(got[0], "cpu")
    assert batch["tokens"].dtype == torch.int32
    assert np.array_equal(batch["labels"].numpy(), got[0]["labels"])


def test_optim_and_run_configs_match_reference():
    """``OptimConfig`` field for field; ``RunConfig``'s fields in order,
    ``remat`` and ``microbatch`` with the reference's defaults."""
    assert [(f.name, f.default) for f in dataclasses.fields(OptimConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JOptimConfig)]
    got = {f.name: f.default for f in dataclasses.fields(RunConfig)}
    want = {f.name: f.default for f in dataclasses.fields(JRunConfig)}
    assert list(got) == list(want)
    assert (got["remat"], got["microbatch"]) == (want["remat"],
                                                 want["microbatch"]) == \
        ("block", 1)
