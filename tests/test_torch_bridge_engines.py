"""Port parity: the unfused bridge engine.

The port's ``pull_pages`` / ``push_pages`` with ``fused=False`` run one
serial engine whatever ``channels`` says (on one stream the reference's
pipelined schedule would only reorder independent tensor ops).  It is
held to the reference's oracles (``repro.core.ref``: ``pull_pages_ref`` /
``push_pages_ref`` and the pipelined ones at the same ``channels``) and bit
for bit to the port's fused engine, counters included, for N in {2, 3, 5,
8}, channels {1, 2, 3, 4}, every route-program constructor, throttled
per-node and scalar rate limiters, ``overprovision`` 2, zero rounds and
f32 / bf16 pages with -0.0 elements.  Against the JAX oracles pages compare
by value: the engines add lanes into zeros, as the reference's do, so a
-0.0 element comes back +0.0.  The loopback path with ``fused=False`` is
held to the reference's, ``decode_attention_pull(fused=False)`` to the JAX
one on one device (pools and tails bit for bit, the output within 1e-5 in
float32), and the KV cache's bufferless bridge (``edge_buffer=False``) to
the fused one.  In a subprocess with 8 virtual CPU devices the engine meets
the JAX serial, pipelined and bufferless engines themselves
(``tests/torch_engines_8dev.py``).
"""
import collections
import itertools
import os
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bridge as jbridge
from repro.core import kvbridge as jkv
from repro.core import ref
from repro.core import steering as js
from repro.core.memport import MemPortTable as JTable
from repro.core.topology import Topology as JTopo

from repro_torch.core import bridge as tbridge
from repro_torch.core import kvbridge as tkv
from repro_torch.core import steering as ts
from repro_torch.core.memport import FREE, MemPortTable as TTable
from repro_torch.core.topology import Topology as TTopo
from repro_torch.kernels import bridge_gather as tbg

REPO = Path(__file__).resolve().parents[1]
PAGE = (2, 3)
DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
NODES = [2, 3, 5, 8]
CHANNELS = [1, 2, 3, 4]
# (pages per node, budget, requests per node) of the N-node cases: one
# shape for the pull and the push, so the JAX oracles' ops compile once
SHAPE = (11, 5, 9)
BRIDGE_KERNELS = ("gather_pages", "pull_commit", "push_commit",
                  "scatter_pages")

torch.set_num_threads(1)


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor (a copy: the port updates pools in place)."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    int_of = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.dtype == b.dtype and torch.equal(a.view(int_of[a.dtype]),
                                              b.view(int_of[b.dtype]))


def same_counters(got, want) -> bool:
    return all(torch.equal(getattr(got, f.name), getattr(want, f.name))
               for f in fields(want))


def random_pages(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < 0.05] = -0.0
    return x.astype(dtype)


def program_variants(n):
    """(name, JAX program, port program) for every constructor."""
    sizes = [n // 2, n - n // 2] if n > 2 else [1, 1]
    w = [1.0 + (d % 3) for d in range(1, n)]
    mask = np.tile(np.arange(n) % 3 != 1, (n - 1, 1))
    live = [1, n - 1] if n > 2 else [1]
    jbi, tbi = js.bidirectional_program(n), ts.bidirectional_program(
        n, device="cpu")
    cpu = dict(device="cpu")
    return [
        ("uni", js.unidirectional_program(n),
         ts.unidirectional_program(n, **cpu)),
        ("bi", jbi, tbi),
        ("pruned", js.pruned_program(jbi, live), ts.pruned_program(tbi, live)),
        ("lb", js.load_balanced_program(n, w),
         ts.load_balanced_program(n, w, **cpu)),
        ("link", js.link_avoiding_program(n, 1),
         ts.link_avoiding_program(n, 1, **cpu)),
        ("hier", js.hierarchical_program(JTopo.from_sizes(sizes)),
         ts.hierarchical_program(TTopo.from_sizes(sizes), **cpu)),
        ("masked", js.masked_ranks_program(jbi, mask),
         ts.masked_ranks_program(tbi, mask)),
    ]


def random_table(rng, num_logical, n, ppn, unmapped=0.1):
    """A permuted placement over n nodes, some logical pages unmapped."""
    flat = rng.permutation(n * ppn)[:num_logical]
    home, slot = (flat // ppn).astype(np.int32), (flat % ppn).astype(np.int32)
    off = rng.random(num_logical) < unmapped
    home[off] = FREE
    slot[off] = FREE
    return (JTable(home=jnp.asarray(home), slot=jnp.asarray(slot)),
            TTable(home=torch.from_numpy(home), slot=torch.from_numpy(slot)))


def rate_limits(rng, n, budget):
    """(name, the oracles' per-node array or None, the port's argument):
    unthrottled, throttled per node, and one int shared by every node."""
    vec = rng.integers(0, budget, size=n).astype(np.int32)
    return [("full", None, None), ("per-node", vec, torch.from_numpy(vec)),
            ("scalar", np.full(n, 2, np.int32), 2)]


# ---------------------------------------------------------------------------
# The N-node engines against the oracles and the fused engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("n", NODES)
def test_pull_engines_match_oracles_and_fused(n, channels):
    rng = np.random.default_rng(n * 10 + channels)
    ppn, budget, r = SHAPE
    jtable, ttable = random_table(rng, n * ppn - 3, n, ppn)
    want = rng.integers(-1, n * ppn - 3, size=(n, r)).astype(np.int32)
    tenants = torch.from_numpy(rng.integers(-1, 3, size=(n, r))
                               .astype(np.int32))
    for dname, (np_dt, _) in DTYPES.items():
        pool = random_pages(rng, (n * ppn,) + PAGE, np_dt)
        pool_t, want_t = to_torch(pool), to_torch(want)
        for (pname, jprog, tprog), (bname, ab, tab) in itertools.product(
                program_variants(n), rate_limits(rng, n, budget)):
            label = (dname, pname, bname)
            exp = np.asarray(ref.pull_pages_pipelined_ref(
                jnp.asarray(pool), jnp.asarray(want), jtable, ppn, jprog,
                budget=budget, channels=channels, active_budget=ab))
            if ab is None:
                np.testing.assert_array_equal(exp, np.asarray(
                    ref.pull_pages_ref(jnp.asarray(pool), jnp.asarray(want),
                                       jtable, ppn, jprog)))
            kw = dict(num_nodes=n, budget=budget, channels=channels,
                      program=tprog, active_budget=tab,
                      collect_telemetry=True, tenant_ids=tenants,
                      max_tenants=3)
            fused, fused_t = tbridge.pull_pages(pool_t, want_t, ttable, **kw)
            got, got_t = tbridge.pull_pages(pool_t, want_t, ttable, **kw,
                                            fused=False)
            assert np.array_equal(to_numpy(got), exp), label
            assert same_bits(got, fused), label
            assert same_counters(got_t, fused_t), label


@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("n", NODES)
def test_push_engines_match_oracles_and_fused(n, channels):
    rng = np.random.default_rng(n * 10 + channels + 500)
    ppn, budget, r = SHAPE
    jtable, ttable = random_table(rng, n * ppn - 3, n, ppn)
    # single-writer pages across nodes; one node writes a page twice (the
    # later write wins)
    dest = rng.permutation(n * ppn - 3)[:n * r].reshape(n, r).astype(np.int32)
    dest[rng.random(dest.shape) < 0.15] = FREE
    dest[n - 1, r - 1] = dest[n - 1, 0]
    for dname, (np_dt, _) in DTYPES.items():
        pool = random_pages(rng, (n * ppn,) + PAGE, np_dt)
        payload = random_pages(rng, (n, r) + PAGE, np_dt)
        for (pname, jprog, tprog), (bname, ab, tab) in itertools.product(
                program_variants(n), rate_limits(rng, n, budget)):
            label = (dname, pname, bname)
            exp = np.asarray(ref.push_pages_pipelined_ref(
                jnp.asarray(pool), jnp.asarray(dest), jnp.asarray(payload),
                jtable, ppn, jprog, budget=budget, channels=channels,
                active_budget=ab))
            if ab is None:
                np.testing.assert_array_equal(exp, np.asarray(
                    ref.push_pages_ref(jnp.asarray(pool), jnp.asarray(dest),
                                       jnp.asarray(payload), jtable, ppn,
                                       jprog)))
            kw = dict(num_nodes=n, budget=budget, channels=channels,
                      program=tprog, active_budget=tab,
                      collect_telemetry=True)
            fused, fused_t = tbridge.push_pages(
                to_torch(pool), to_torch(dest), to_torch(payload), ttable,
                **kw)
            pool_t = to_torch(pool)
            got, got_t = tbridge.push_pages(
                pool_t, to_torch(dest), to_torch(payload), ttable, **kw,
                fused=False)
            assert got is pool_t                      # updated in place
            assert np.array_equal(to_numpy(got), exp), label
            assert same_bits(got, fused), label
            assert same_counters(got_t, fused_t), label


@pytest.mark.parametrize("channels", [1, 3])
def test_overprovision_and_zero_rounds(channels):
    """A throttled limiter over ``overprovision`` 2 still serves the tail;
    zero rounds pull zeros and push nothing, on N nodes and on the
    loopback path."""
    rng = np.random.default_rng(40 + channels)
    n, ppn, budget, r = 5, 12, 4, 10
    jtable, ttable = random_table(rng, n * ppn, n, ppn, unmapped=0.0)
    pool = random_pages(rng, (n * ppn,) + PAGE, np.float32)
    want = rng.integers(-1, n * ppn, size=(n, r)).astype(np.int32)
    dest = rng.permutation(n * ppn)[:n * r].reshape(n, r).astype(np.int32)
    payload = random_pages(rng, (n, r) + PAGE, np.float32)
    ab = np.array([2, 4, 1, 3, 2], np.int32)
    kw = dict(num_nodes=n, budget=budget, channels=channels, overprovision=2,
              active_budget=torch.from_numpy(ab))
    exp_pull = np.asarray(ref.pull_pages_pipelined_ref(
        jnp.asarray(pool), jnp.asarray(want), jtable, ppn, None,
        budget=budget, channels=channels, active_budget=ab, overprovision=2))
    exp_push = np.asarray(ref.push_pages_pipelined_ref(
        jnp.asarray(pool), jnp.asarray(dest), jnp.asarray(payload), jtable,
        ppn, None, budget=budget, channels=channels, active_budget=ab,
        overprovision=2))
    got = tbridge.pull_pages(to_torch(pool), to_torch(want), ttable, **kw,
                             fused=False)
    assert np.array_equal(got.numpy(), exp_pull)
    pool_t = to_torch(pool)
    tbridge.push_pages(pool_t, to_torch(dest), to_torch(payload), ttable,
                       **kw, fused=False)
    assert np.array_equal(pool_t.numpy(), exp_push)
    empty = torch.zeros((n, 0), dtype=torch.int32)
    for nodes in (n, 1):
        for fused in (True, False):
            got = tbridge.pull_pages(to_torch(pool), empty, ttable,
                                     num_nodes=nodes, table_nodes=n,
                                     fused=fused)
            assert tuple(got.shape) == (n, 0) + PAGE, (nodes, fused)
            pool_t = to_torch(pool)
            tbridge.push_pages(pool_t, empty, torch.zeros((n, 0) + PAGE),
                               ttable, num_nodes=nodes, table_nodes=n,
                               fused=fused)
            assert np.array_equal(pool_t.numpy(), pool), (nodes, fused)


def test_slots_past_the_node_drop_and_clamp():
    """A slot past its home's pages: the pull reads the home's last row (as
    the reference's clamped shard-local gather does) and the push drops the
    write instead of landing in the next node's rows."""
    n, ppn = 3, 4
    home = np.array([0, 1, 2, 1], np.int32)
    slot = np.array([1, ppn, ppn + 2, 0], np.int32)
    table = TTable(home=torch.from_numpy(home), slot=torch.from_numpy(slot))
    pool = torch.arange(n * ppn * 2, dtype=torch.float32).view(n * ppn, 2)
    want = torch.tensor([[1, 2, 3], [0, 1, 2], [3, 0, FREE]],
                        dtype=torch.int32)
    dest = torch.tensor([[1], [2], [FREE]], dtype=torch.int32)
    payload = -torch.ones((n, 1, 2))
    for fused in (False, True):
        got = tbridge.pull_pages(pool, want, table, num_nodes=n, fused=fused)
        assert torch.equal(got[0, 0], pool[ppn * 2 - 1])     # page 1 -> 1:3
        assert torch.equal(got[0, 1], pool[ppn * 3 - 1])     # page 2 -> 2:3
        assert torch.equal(got[0, 2], pool[ppn + 0])
        pool_t = pool.clone()
        tbridge.push_pages(pool_t, dest, payload, table, num_nodes=n,
                           fused=fused)
        assert torch.equal(pool_t, pool)


def refuse_bridge_kernels(monkeypatch):
    """Make every wrapper of ``kernels/bridge_gather.py`` and its plain
    version raise."""
    def refuse(*_args, **_kw):
        raise AssertionError("an unfused engine called bridge_gather")

    for name in BRIDGE_KERNELS:
        monkeypatch.setattr(tbg, name, refuse)
        monkeypatch.setattr(tbg, name + "_plain", refuse)


@pytest.mark.parametrize("n", [3, 5])
def test_unfused_engines_call_no_bridge_kernel(n, monkeypatch):
    """``fused=False`` runs none of ``kernels/bridge_gather.py``: neither
    its wrappers nor their plain versions."""
    refuse_bridge_kernels(monkeypatch)
    rng = np.random.default_rng(n)
    ppn = 4
    _, ttable = random_table(rng, n * ppn, n, ppn, unmapped=0.0)
    pool = torch.randn((n * ppn,) + PAGE)
    want = torch.from_numpy(rng.integers(-1, n * ppn, size=(n, 6))
                            .astype(np.int32))
    for channels in (1, 2):
        tbridge.pull_pages(pool, want, ttable, num_nodes=n, budget=3,
                           channels=channels, fused=False)
        tbridge.push_pages(pool, want, torch.randn((n, 6) + PAGE), ttable,
                           num_nodes=n, budget=3, channels=channels,
                           fused=False)
    tbridge.pull_pages(pool, want, ttable, fused=False)        # loopback
    tbridge.push_pages(pool, want, torch.randn((n, 6) + PAGE), ttable,
                       fused=False)
    with pytest.raises(AssertionError, match="bridge_gather"):
        tbridge.pull_pages(pool, want, ttable, num_nodes=n)


# ---------------------------------------------------------------------------
# The loopback path and the KV cache with fused=False
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tn", [1, 4])
def test_loopback_unfused_matches_reference(tn):
    """One device: the port's ``fused=False`` gather and scatter against
    the reference's (``_gather_local`` / ``_scatter_local``), rows of
    requests, a program over ``tn`` logical nodes and a throttled limiter."""
    rng = np.random.default_rng(90 + tn)
    ppn, budget, rows, r = 6, 4, 4, 9
    jtable, ttable = random_table(rng, tn * ppn - 1, tn, ppn)
    pool = random_pages(rng, (tn * ppn,) + PAGE, np.float32)
    want = rng.integers(-1, tn * ppn - 1, size=(rows, r)).astype(np.int32)
    dest = rng.permutation(tn * ppn - 1)[:rows * 5].reshape(rows, 5).astype(
        np.int32) if tn > 1 else rng.integers(-1, ppn - 1, size=(rows, 5))\
        .astype(np.int32)
    payload = random_pages(rng, dest.shape + PAGE, np.float32)
    progs = [(None, None)]
    if tn > 1:
        progs.append((js.unidirectional_program(tn),
                      ts.unidirectional_program(tn, device="cpu")))
    for (jprog, tprog), ab in itertools.product(progs, [None, 2]):
        kw = dict(budget=budget, active_budget=ab, table_nodes=tn,
                  fused=False)
        exp = jbridge.pull_pages(jnp.asarray(pool), jnp.asarray(want), jtable,
                                 mesh=None, program=jprog, **kw)
        got = tbridge.pull_pages(to_torch(pool), to_torch(want), ttable,
                                 program=tprog, **kw)
        assert np.array_equal(got.numpy(), np.asarray(exp))
        assert same_bits(got, tbridge.pull_pages(
            to_torch(pool), to_torch(want), ttable, program=tprog,
            **dict(kw, fused=True)))
        exp = jbridge.push_pages(jnp.asarray(pool), jnp.asarray(dest),
                                 jnp.asarray(payload), jtable, mesh=None,
                                 program=jprog, **kw)
        got = tbridge.push_pages(to_torch(pool), to_torch(dest),
                                 to_torch(payload), ttable, program=tprog,
                                 **kw)
        assert np.array_equal(got.numpy(), np.asarray(exp))


def test_decode_attention_pull_unfused_matches_reference():
    """Token after token through both packages' one-device caches with
    ``fused=False``: pools and tails bit for bit, the attention within 1e-5
    (float32) of the JAX one, of the port's fused one, and of the port's
    unfused one on 2 and 3 memory nodes; the pulled pages bit-exact against
    the fused engine's."""
    rng = np.random.default_rng(5)
    b, h, kv, hd, t, max_len, budget, steps = 3, 4, 2, 8, 4, 20, 3, 13
    max_pages = -(-max_len // t)
    pool_shape = (b * max_pages, t, kv, hd)
    tail_shape = (b, t, kv, hd)
    j_layer = jkv.PagedKVLayer(*(jnp.zeros(s) for s in (
        pool_shape, pool_shape, tail_shape, tail_shape)))
    j_table = JTable.striped(b * max_pages, 1, b * max_pages)
    kw = dict(page_tokens=t, max_pages=max_pages, budget=budget)

    @jax.jit
    def j_step(layer, lengths, k_new, v_new, q):
        layer = jkv.append(layer, j_table, lengths, k_new, v_new, mesh=None,
                           fused=False, **kw)
        out = jkv.decode_attention_pull(q, layer, j_table, lengths + 1,
                                        mesh=None, fused=False, **kw)
        return layer, out

    caches = {}
    for n in (1, 2, 3):
        spn = -(-b * max_pages // n)
        caches[n] = (tkv.PagedKVLayer(*(torch.zeros(s) for s in (
            (n * spn,) + pool_shape[1:], (n * spn,) + pool_shape[1:],
            tail_shape, tail_shape))),
            TTable.striped(b * max_pages, n, spn, device="cpu"))
    for step in range(steps):
        lengths = np.full((b,), step, np.int32)
        k_new, v_new = (rng.standard_normal((b, kv, hd)).astype(np.float32)
                        for _ in range(2))
        q = rng.standard_normal((b, h, hd)).astype(np.float32)
        j_layer, j_out = j_step(j_layer, *(jnp.asarray(x) for x in (
            lengths, k_new, v_new, q)))
        t_len = torch.from_numpy(lengths)
        outs = {}
        for n, (layer, table) in caches.items():
            tkv.append(layer, table, t_len, torch.from_numpy(k_new),
                       torch.from_numpy(v_new), num_nodes=n, fused=False,
                       **kw)
            outs[n] = tkv.decode_attention_pull(
                torch.from_numpy(q), layer, table, t_len + 1, num_nodes=n,
                fused=False, **kw)
        layer, table = caches[1]
        for name in ("k_pool", "v_pool", "tail_k", "tail_v"):
            assert np.array_equal(getattr(layer, name).numpy(),
                                  np.asarray(getattr(j_layer, name))), name
        fused = tkv.decode_attention_pull(torch.from_numpy(q), layer, table,
                                          t_len + 1, **kw)
        for got in list(outs.values()) + [fused]:
            np.testing.assert_allclose(got.numpy(), np.asarray(j_out),
                                       rtol=1e-5, atol=1e-5)
    for n, (layer, table) in caches.items():
        want = tkv.logical_page_ids(b, max_pages, device="cpu")
        want = tkv._by_node(want, n, fill=FREE).reshape(n, -1)
        pages = {f: tbridge.pull_pages(layer.k_pool, want, table,
                                       num_nodes=n, budget=budget, fused=f)
                 for f in (True, False)}
        assert same_bits(pages[False], pages[True]), n


@pytest.mark.parametrize("n", [1, 3])
def test_bufferless_kv_cache_matches_fused(n, monkeypatch):
    """``edge_buffer=False`` in the KV cache: on N nodes its flushes and
    pulls run the unfused engine (no call into ``bridge_gather``) under the
    fused fold; on the loopback path it keeps the kernels.  Pools, tails
    and the attention bit for bit against the edge-buffered cache."""
    rng = np.random.default_rng(11 + n)
    b, h, kv, hd, t, max_len, budget, steps = 4, 4, 2, 8, 4, 16, 3, 11
    max_pages = -(-max_len // t)
    spn = -(-b * max_pages // n)
    shapes = ((n * spn, t, kv, hd),) * 2 + ((b, t, kv, hd),) * 2
    layers = {eb: tkv.PagedKVLayer(*(torch.zeros(s) for s in shapes))
              for eb in (True, False)}
    table = TTable.striped(b * max_pages, n, spn, device="cpu")
    kw = dict(page_tokens=t, max_pages=max_pages, budget=budget, num_nodes=n)
    calls = collections.Counter()
    for name in BRIDGE_KERNELS:
        def counted(*args, _f=getattr(tbg, name), _name=name, **kwargs):
            calls[_name] += 1
            return _f(*args, **kwargs)
        monkeypatch.setattr(tbg, name, counted)
    launched = {True: 0, False: 0}
    for step in range(steps):
        lengths = torch.full((b,), step, dtype=torch.int32)
        k_new, v_new, q = (torch.from_numpy(
            rng.standard_normal(s).astype(np.float32))
            for s in ((b, kv, hd), (b, kv, hd), (b, h, hd)))
        outs = {}
        for eb, layer in layers.items():
            before = sum(calls.values())
            tkv.append(layer, table, lengths, k_new, v_new, edge_buffer=eb,
                       **kw)
            outs[eb] = tkv.decode_attention_pull(
                q, layer, table, lengths + 1, edge_buffer=eb, **kw)
            launched[eb] += sum(calls.values()) - before
        assert same_bits(outs[False], outs[True]), step
    for name in ("k_pool", "v_pool", "tail_k", "tail_v"):
        assert same_bits(getattr(layers[False], name),
                         getattr(layers[True], name)), name
    assert launched[True] > 0
    assert (launched[False] > 0) == (n == 1), launched


# ---------------------------------------------------------------------------
# Against the JAX unfused engines on 8 devices
# ---------------------------------------------------------------------------

def test_engines_match_jax_unfused_engines_on_8_devices():
    """The JAX serial, pipelined (channels 2) and bufferless engines on 8
    virtual CPU devices, unidirectional and hierarchical programs,
    throttled and not: the port's pages and counters bit for bit."""
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", str(REPO)),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_engines_8dev.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "ALL OK" in proc.stdout
    assert proc.stdout.count("ok: ") == 12
