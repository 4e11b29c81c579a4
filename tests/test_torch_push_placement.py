"""Port parity of the bridge_push and ring placements, and the launcher.

``kvbridge.decode_attention_push`` (compute at the memory nodes) against the
JAX one at ``mesh=None`` and both packages' dense ``decode_attention_ref``
(float32 2e-5), on one node and with the pool striped over N nodes (the
reference's ``pmax`` / ``psum`` combine becomes a max and a sum over the
node axis); its pieces ``_page_partial`` / ``_segment_combine``,
``init_cache`` and ``RingCacheOps`` against the JAX ones.  Then reduced
granite-3-8b in float32 through ``make_cache_ops``: ``local``, ``ring``,
``bridge_pull`` with and without telemetry and ``bridge_push`` on 1 and 8
nodes emit identical tokens, with logits within 1e-4 of the JAX
``bridge_push``'s, and ``collect_state_telemetry`` equals the JAX one.
Last, the launcher on the CPU with the new placements and options.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import RunConfig as JRunConfig, ShapeConfig as JShape
from repro.core import kvbridge as jkv
from repro.core.memport import MemPortTable as JTable
from repro.models import transformer as jtransformer
from repro.serve import cache_ops as jcache
from repro.serve import step as jstep

from repro_torch import configs as tconfigs, weights
from repro_torch.config import BridgeConfig as TBridge
from repro_torch.config import RunConfig as TRunConfig, ShapeConfig as TShape
from repro_torch.core import kvbridge as tkv
from repro_torch.core.memport import FREE, MemPortTable as TTable
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import cache_ops as tcache
from repro_torch.serve import step as tstep

from test_torch_telemetry import assert_counters_equal

REPO = Path(__file__).resolve().parents[1]
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def paged_case(rng, b, t, kv, hd, max_pages, num_nodes, lengths):
    """A pool striped over ``num_nodes`` nodes filled with the flushed pages
    of dense k, v [B, S, kv, hd], the tails holding each sequence's partial
    page; returns (dense k, v, port layer, port table, JAX layer, JAX
    table), the JAX ones for one node."""
    s = max_pages * t
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    spn = -(-b * max_pages // num_nodes)

    def layer_for(n, spn):
        table = TTable.striped(b * max_pages, n, spn, device="cpu")
        pool_k = np.zeros((n * spn, t, kv, hd), np.float32)
        pool_v = np.zeros_like(pool_k)
        home, slot = (x.numpy() for x in table.translate(
            torch.arange(b * max_pages, dtype=torch.int32)))
        for seq in range(b):
            for p in range(lengths[seq] // t):
                row = home[seq * max_pages + p] * spn + slot[seq * max_pages
                                                             + p]
                pool_k[row] = k[seq, p * t:(p + 1) * t]
                pool_v[row] = v[seq, p * t:(p + 1) * t]
        tail_k = np.zeros((b, t, kv, hd), np.float32)
        tail_v = np.zeros_like(tail_k)
        for seq in range(b):
            start = lengths[seq] // t * t
            n_tail = lengths[seq] - start
            tail_k[seq, :n_tail] = k[seq, start:lengths[seq]]
            tail_v[seq, :n_tail] = v[seq, start:lengths[seq]]
        return table, (pool_k, pool_v, tail_k, tail_v)

    ttable, arrays = layer_for(num_nodes, spn)
    tlayer = tkv.PagedKVLayer(*(torch.from_numpy(a) for a in arrays))
    jtable1, arrays1 = layer_for(1, b * max_pages)
    jlayer = jkv.PagedKVLayer(*(jnp.asarray(a) for a in arrays1))
    jtable = JTable(home=jnp.asarray(jtable1.home.numpy()),
                    slot=jnp.asarray(jtable1.slot.numpy()))
    return k, v, tlayer, ttable, jlayer, jtable


@pytest.mark.parametrize("num_nodes", [1, 2, 3, 8])
def test_decode_attention_push_matches_reference(num_nodes):
    rng = np.random.default_rng(num_nodes)
    b, t, kv, hd, h, max_pages = 5, 4, 2, 8, 4, 6
    lengths = np.array([0, 3, 4, 13, 24], np.int32)
    k, v, tlayer, ttable, jlayer, jtable = paged_case(
        rng, b, t, kv, hd, max_pages, num_nodes, lengths)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    got = tkv.decode_attention_push(
        torch.from_numpy(q), tlayer, ttable, torch.from_numpy(lengths),
        page_tokens=t, max_pages=max_pages, num_nodes=num_nodes).numpy()
    dense_j = np.asarray(jkv.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)))
    dense_t = tkv.decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, dense_j, **ATTN_TOL)
    np.testing.assert_allclose(got, dense_t, **ATTN_TOL)
    j_push = np.asarray(jkv.decode_attention_push(
        jnp.asarray(q), jlayer, jtable, jnp.asarray(lengths), page_tokens=t,
        max_pages=max_pages, mesh=None))
    np.testing.assert_allclose(got, j_push, **ATTN_TOL)
    if num_nodes == 1:
        np.testing.assert_allclose(got, j_push, rtol=1e-6, atol=1e-6)


def test_push_attention_pieces_match_reference():
    """``_page_partial``, ``_segment_combine`` (segments out of range and
    empty ones included) and the inverse memport map of a table with
    unmapped pages."""
    rng = np.random.default_rng(5)
    r, t, kv, hd, h, segs = 9, 4, 2, 8, 4, 4
    q = rng.standard_normal((r, h, hd)).astype(np.float32)
    k = rng.standard_normal((r, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((r, t, kv, hd)).astype(np.float32)
    valid = rng.random((r, t)) < 0.7
    valid[2] = False
    got = tkv._page_partial(*(torch.from_numpy(x) for x in (q, k, v, valid)))
    want = jkv._page_partial(*(jnp.asarray(x) for x in (q, k, v, valid)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    seg = np.array([0, 2, -1, 0, 2, 2, 7, -1, 0], np.int32)   # 1, 3 empty
    got = tkv._segment_combine(*got, torch.from_numpy(seg), segs)
    want = jkv._segment_combine(*want, jnp.asarray(seg), segs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    home = np.array([1, 0, FREE, 1, 0, 1], np.int32)
    slot = np.array([0, 2, FREE, 2, 1, 1], np.int32)
    inv = tkv._inverse_map(TTable(torch.from_numpy(home),
                                  torch.from_numpy(slot)), 3, 6)
    assert inv.tolist() == [FREE, 4, 1, 0, 5, 3]


def test_init_cache_matches_reference():
    for nodes in (1, 4):
        got = tkv.init_cache(3, 5, 40, 8, 2, 16, num_nodes=nodes,
                             dtype=torch.float32, device="cpu")
        if nodes == 1:
            want = jkv.init_cache(3, 5, 40, 8, 2, 16, mesh=None,
                                  dtype=jnp.float32)
            assert np.array_equal(got.table.home.numpy(),
                                  np.asarray(want.table.home))
            assert np.array_equal(got.table.slot.numpy(),
                                  np.asarray(want.table.slot))
            for f in ("k_pool", "v_pool", "tail_k", "tail_v"):
                assert (tuple(getattr(got.layers, f).shape)
                        == getattr(want.layers, f).shape)
        assert got.max_pages == 5 and got.page_tokens == 8 and got.batch == 5
        assert tuple(got.layers.k_pool.shape) == (3, 28 if nodes == 4 else 25,
                                                  8, 2, 16)
        assert got.layers.k_pool.data_ptr() != got.layers.v_pool.data_ptr()
        assert int(got.table.home.max()) == nodes - 1


@pytest.mark.parametrize("window", [0, 5])
def test_ring_cache_ops_matches_reference(window):
    """The ring buffer across a wrap of its slots: the JAX RingCacheOps on
    the same tokens, attention at 1e-6."""
    rng = np.random.default_rng(window)
    b, kv, hd, h, max_len = 3, 2, 8, 4, 12
    cfg = dataclasses.replace(tconfigs.get_reduced("granite-3-8b"),
                              num_kv_heads=kv, head_dim=hd, num_heads=h)
    j_ops = jcache.RingCacheOps(max_len, jnp.float32)
    t_ops = tcache.RingCacheOps(max_len, torch.float32, device="cpu")
    j_st = j_ops.init_layer(cfg, b, window)
    t_st = t_ops.init_layer(cfg, b, window)
    lengths = np.array([0, 2, 6], np.int32)
    for step in range(2 * max_len):
        q, k_new, v_new = (rng.standard_normal(s).astype(np.float32) for s in
                           ((b, h, hd), (b, kv, hd), (b, kv, hd)))
        ln = lengths + step
        j_att, j_st = j_ops.append_and_attend(
            cfg, j_st, None, jnp.asarray(ln), jnp.asarray(q),
            jnp.asarray(k_new), jnp.asarray(v_new), window=window)
        t_att, t_st = t_ops.append_and_attend(
            cfg, t_st, None, torch.from_numpy(ln), torch.from_numpy(q),
            torch.from_numpy(k_new), torch.from_numpy(v_new), window=window)
        np.testing.assert_allclose(t_att.numpy(), np.asarray(j_att),
                                   rtol=1e-6, atol=1e-6, err_msg=str(step))
    for key in ("k", "v", "pos"):
        assert np.array_equal(t_st[key].numpy(), np.asarray(j_st[key]))


# ---------------------------------------------------------------------------
# Reduced granite-3-8b, float32, through make_cache_ops
# ---------------------------------------------------------------------------

# 8 prompt steps, then greedy; pages flush at steps 8 and 16
BATCH, MAX_LEN, STEPS, PAGE_TOKENS = 4, 64, 16, 8
TENANTS = np.arange(BATCH) % 2


@pytest.fixture(scope="module")
def granite():
    jcfg = dataclasses.replace(jconfigs.get_reduced("granite-3-8b"),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_reduced("granite-3-8b"),
                               dtype="float32")
    params = jtransformer.init_params(jcfg, jax.random.key(0))
    t_params = weights.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (8, BATCH)).astype(np.int32)
    return jcfg, tcfg, params, t_params, prompt


def jax_decode(cfg, params, kv, prompt, collect=False):
    run = JRunConfig(model=cfg, shape=JShape("t", MAX_LEN, BATCH, "decode"),
                     kv_placement=kv)
    ops = jstep.make_cache_ops(run, mesh=None, max_len=MAX_LEN,
                               page_tokens=PAGE_TOKENS,
                               collect_telemetry=collect,
                               tenant_of_seq=TENANTS if collect else None,
                               max_tenants=2 if collect else 0,
                               dtype=jnp.float32)
    state = jstep.init_serve_state(run, BATCH, ops)
    step = jax.jit(lambda p, s, t: jtransformer.decode_step(cfg, p, s, t, ops))
    tokens, logits_all, out = None, [], []
    for i in range(STEPS):
        tokens = jnp.asarray(prompt[i]) if i < len(prompt) else tokens
        logits, state = step(params, state, tokens)
        tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits_all.append(np.asarray(logits))
        out.append(np.asarray(tokens))
    return np.stack(logits_all), np.stack(out, 1), state


def port_decode(cfg, params, kv, prompt, num_nodes=1, collect=False):
    run = TRunConfig(model=cfg, shape=TShape("t", MAX_LEN, BATCH, "decode"),
                     kv_placement=kv, bridge=TBridge())
    ops = tstep.make_cache_ops(run, MAX_LEN, PAGE_TOKENS, num_nodes=num_nodes,
                               collect_telemetry=collect,
                               tenant_of_seq=TENANTS if collect else None,
                               max_tenants=2 if collect else 0,
                               dtype=torch.float32, device="cpu")
    state = tstep.init_serve_state(run, BATCH, ops)
    tokens, logits_all, out = None, [], []
    for i in range(STEPS):
        tokens = torch.from_numpy(prompt[i]) if i < len(prompt) else tokens
        logits, state = ttransformer.decode_step(cfg, params, state, tokens,
                                                 ops)
        tokens = torch.argmax(logits, -1).to(torch.int32)
        logits_all.append(logits.numpy())
        out.append(tokens.numpy())
    return np.stack(logits_all), np.stack(out, 1), state, ops


@pytest.fixture(scope="module")
def jax_push(granite):
    jcfg, _, params, _, prompt = granite
    return jax_decode(jcfg, params, "bridge_push", prompt)


@pytest.mark.parametrize("kv,num_nodes,collect", [
    ("local", 1, False), ("ring", 1, False), ("bridge_pull", 8, True),
    ("bridge_push", 1, False), ("bridge_push", 8, False),
    ("bridge_push", 3, True)])
def test_placements_match_reference_bridge_push(granite, jax_push, kv,
                                                num_nodes, collect):
    """Every placement emits the JAX bridge_push's tokens, logits within
    1e-4 per step (the 1-node bridge_pull, counters on and off: below)."""
    _, tcfg, _, t_params, prompt = granite
    j_logits, j_tokens, _ = jax_push
    logits, tokens, state, ops = port_decode(tcfg, t_params, kv, prompt,
                                             num_nodes, collect)
    for step in range(STEPS):
        np.testing.assert_allclose(logits[step], j_logits[step],
                                   err_msg=f"{kv} step {step}", **LOGIT_TOL)
    assert np.array_equal(tokens, j_tokens)
    telem = tstep.collect_state_telemetry(state)
    assert (telem is not None) == collect
    if collect:
        assert tuple(telem.traffic.shape) == (num_nodes, num_nodes)
        assert int(telem.served_total().sum()) > 0


@pytest.mark.parametrize("kv", ["bridge_pull", "bridge_push"])
def test_state_telemetry_matches_reference(granite, jax_push, kv):
    """One node, tenants b % 2: the summed layer counters of the decode
    equal the JAX ones, and the telemetry-on logits equal the
    telemetry-off ones bit for bit (the counters only observe), which hold
    the JAX bridge_push's tokens and logits (1e-4)."""
    jcfg, tcfg, params, t_params, prompt = granite
    _, _, j_state = jax_decode(jcfg, params, kv, prompt, collect=True)
    on_logits, _, state, _ = port_decode(tcfg, t_params, kv, prompt,
                                         collect=True)
    off_logits, off_tokens, _, _ = port_decode(tcfg, t_params, kv, prompt)
    assert np.array_equal(on_logits, off_logits)
    np.testing.assert_allclose(off_logits, jax_push[0], **LOGIT_TOL)
    assert np.array_equal(off_tokens, jax_push[1])
    got = tstep.collect_state_telemetry(state)
    want = jstep.collect_state_telemetry(j_state)
    assert_counters_equal(got, want, kv)
    assert int(got.tenant_served[0, 1]) > 0


def test_sliding_window_layers_keep_a_local_ring():
    """A model of sliding-window layers: ``local`` picks the ring buffer,
    and BridgeCacheOps keeps its SWA layers in a local ring too (no pool,
    no counters), as the reference's do."""
    cfg = dataclasses.replace(tconfigs.get_reduced("granite-3-8b"),
                              layer_pattern=("swa",), window_size=8,
                              dtype="float32")
    run = TRunConfig(model=cfg, shape=TShape("t", MAX_LEN, 2, "decode"),
                     kv_placement="local")
    assert isinstance(tstep.make_cache_ops(run, MAX_LEN, device="cpu"),
                      tcache.RingCacheOps)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    params = ttransformer.init_params(cfg, gen, device="cpu")
    outs = []
    for kv in ("local", "bridge_push", "bridge_pull"):
        r = dataclasses.replace(run, kv_placement=kv)
        ops = tstep.make_cache_ops(r, MAX_LEN, PAGE_TOKENS,
                                   collect_telemetry=True,
                                   dtype=torch.float32, device="cpu")
        state = tstep.init_serve_state(r, 2, ops)
        assert all("ring" in st or "k" in st for st in state["layers"])
        assert tstep.collect_state_telemetry(state) is None
        tokens = torch.ones((2,), dtype=torch.int32)
        for _ in range(12):
            logits, state = ttransformer.decode_step(cfg, params, state,
                                                     tokens, ops)
            tokens = torch.argmax(logits, -1).to(torch.int32)
        outs.append(logits)
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    torch.testing.assert_close(outs[2], outs[0], rtol=0, atol=0)
    with pytest.raises(ValueError):
        tcache.BridgeCacheOps(mode="pool", max_len=8, page_tokens=4,
                              device="cpu")


# ---------------------------------------------------------------------------
# The launcher on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,described", [
    (["--kv", "bridge_push", "--num-nodes", "8"], False),
    (["--kv", "bridge_pull", "--telemetry", "--tenants", "2"], True)])
def test_launcher_runs_new_placements_on_cpu(args, described):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-3-8b", "--reduced", "--device", "cpu", "--steps", "20",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "tokens/s=" in res.stdout
    assert ("telemetry: 1 steps folded" in res.stdout) == described
    if described:
        assert "tenant 0: served=" in res.stdout
        assert "tenant 1: served=" in res.stdout
