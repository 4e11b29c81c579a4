"""Port parity of the sequence forward: reduced granite-3-8b in float32.

The JAX package's parameters for ``reduced("granite-3-8b")`` (2 layers,
d_model 128, 4/2 heads of 32) are carried across with
``weights.from_reference``, the same way the decode slice carries them.
The port's ``transformer.forward`` over numpy-seeded token ids is held to
the reference's ``forward`` with ``attn_impl="pallas"`` (its flash kernel in
interpret mode) and with ``attn_impl="xla"`` at 1e-4, and to the port's own
``local`` decode fed the same tokens one at a time at 1e-4: float32
throughout, so the paths differ only in the order of their sums.  S = 48
leaves a ragged key tile; S = 130 a ragged query tile of the port's kernel
(64 rows) and of the reference's Pallas grid (bq 128) too.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer

from repro_torch import configs as tconfigs, weights
from repro_torch.config import RunConfig as TRunConfig, ShapeConfig as TShape
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattention
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import step as tstep

BATCH = 2
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_reduced("granite-3-8b"),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_reduced("granite-3-8b"),
                               dtype="float32")
    params = jtransformer.init_params(jcfg, jax.random.key(0))
    t_params = weights.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    return jcfg, tcfg, params, t_params


def tokens(s, seed):
    return np.random.default_rng(seed).integers(
        0, 512, (BATCH, s)).astype(np.int32)


def port_forward(tcfg, t_params, toks):
    logits, aux = ttransformer.forward(tcfg, t_params,
                                       {"tokens": torch.from_numpy(toks)})
    assert aux == {}
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == toks.shape + (tcfg.vocab_size,)
    return logits.numpy()


@pytest.mark.parametrize("s", [48, 130])
@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_forward_matches_reference(setup, s, attn_impl):
    jcfg, tcfg, params, t_params = setup
    toks = tokens(s, seed=s)
    want, _ = jtransformer.forward(jcfg, params, {"tokens": toks},
                                   attn_impl=attn_impl)
    np.testing.assert_allclose(port_forward(tcfg, t_params, toks),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("s", [48, 130])
def test_forward_matches_local_decode(setup, s):
    """Teacher-forced ``local`` decode over the same tokens gives the
    forward's logits at every position."""
    _, tcfg, _, t_params = setup
    toks = tokens(s, seed=100 + s)
    run = TRunConfig(model=tcfg, shape=TShape("t", s, BATCH, "decode"),
                     kv_placement="local")
    ops = tstep.make_cache_ops(run, s, dtype=torch.float32, device="cpu")
    state = tstep.init_serve_state(run, BATCH, ops)
    steps = []
    for i in range(s):
        logits, state = ttransformer.decode_step(
            tcfg, t_params, state, torch.from_numpy(toks[:, i]), ops)
        steps.append(logits.numpy())
    np.testing.assert_allclose(port_forward(tcfg, t_params, toks),
                               np.stack(steps, 1), **TOL)


def test_forward_embeds_input_and_qkv_positions(setup):
    """``embeds`` replace the token embedding (the reference's stub
    frontends), and ``qkv`` takes explicit positions as the reference does."""
    jcfg, tcfg, params, t_params = setup
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(BATCH, 20, tcfg.d_model)).astype(np.float32)
    want, _ = jtransformer.forward(jcfg, params, {"embeds": emb},
                                   attn_impl="xla")
    got, _ = ttransformer.forward(tcfg, t_params,
                                  {"embeds": torch.from_numpy(emb)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    from repro.models import attention as jattention
    x = rng.normal(size=(BATCH, 9, tcfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 300, (BATCH, 9)).astype(np.int32)
    p_np = jax.tree.map(lambda a: np.asarray(a[0]),
                        params["periods"]["pos0"]["attn"])
    p_t = t_params["layers"][0]["attn"]
    for positions in (None, pos):
        want = jattention.qkv(jcfg, p_np, x, positions)
        got = tattention.qkv(tcfg, p_t, torch.from_numpy(x),
                             None if positions is None
                             else torch.from_numpy(positions))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_forward_runs_flash_and_rejects_unported_blocks(setup, monkeypatch):
    """Every layer's attention goes through the kernel API's flash wrapper
    (the CPU path runs its plain version, so nothing launches), and MoE
    configs name the later slice."""
    _, tcfg, _, t_params = setup
    calls = []
    real = tattention.flash_attention

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(tattention, "flash_attention", spy)
    port_forward(tcfg, t_params, tokens(16, seed=5))
    assert calls == [dict(causal=True, window=0)] * tcfg.num_layers
    assert tfa.flash_attention.launches == 0
    moe = dataclasses.replace(tcfg, num_experts=4, experts_per_token=2)
    with pytest.raises(NotImplementedError, match="later slice"):
        ttransformer.forward(
            moe, t_params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def test_attend_train_windows_swa_layers(setup):
    _, tcfg, _, _ = setup
    cfg = dataclasses.replace(tcfg, window_size=5)
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.normal(size=(1, 12, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 12, 2, 32)).astype(np.float32))
    for kind, window in (("swa", 5), ("full", 0), ("global", 0)):
        got = tattention.attend_train(cfg, kind, q, k, k)
        assert torch.equal(got, tfa.flash_attention(q, k, k, window=window))
