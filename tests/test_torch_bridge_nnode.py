"""Port parity: the N-node bridge on a node axis of one device, bit for bit.

The port's plain ``pull_commit`` / ``push_commit`` against the JAX kernels'
CPU path, run node by node on each node's shard; the port's N-node
``pull_pages`` / ``push_pages`` against the ``repro.core.ref`` oracles for
N in {2, 3, 5, 8}, every route-program constructor, channels {1, 2, 4},
throttled per-node ``active_budget`` and f32 / bf16 pages; and, in a
subprocess with 8 virtual CPU devices, against the JAX fused engine itself
(``tests/torch_fused_a2a_8dev.py``).  Pages compare by value
(``np.array_equal``): the engine adds lanes into zeros, as the reference's
does, so a -0.0 element comes back +0.0.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ref
from repro.core import steering as js
from repro.core.memport import MemPortTable as JTable
from repro.core.topology import Topology as JTopo
from repro.kernels import bridge_gather as jbg

from repro_torch.core import bridge as tbridge
from repro_torch.core import steering as ts
from repro_torch.core.memport import FREE, MemPortTable as TTable
from repro_torch.core.topology import Topology as TTopo
from repro_torch.kernels import bridge_gather as tbg

REPO = Path(__file__).resolve().parents[1]
PAGE = (2, 3, 4)
DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor (a copy: the port updates pools in place)."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def random_pages(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < 0.05] = -0.0
    return x.astype(dtype)


# ---------------------------------------------------------------------------
# The commit kernels' plain versions against the JAX kernels, node by node
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,lanes,dtype", [
    (0, 2, 4, "f32"), (1, 3, 5, "f32"), (2, 5, 8, "bf16"), (3, 8, 8, "f32"),
    (4, 8, 12, "bf16"),
])
def test_pull_commit_matches_reference(seed, n, lanes, dtype):
    rng = np.random.default_rng(seed)
    np_dt, _ = DTYPES[dtype]
    ppn = 6
    pool = random_pages(rng, (n * ppn,) + PAGE, np_dt)
    send = random_pages(rng, (n, n, lanes) + PAGE, np_dt)
    choice = rng.integers(-1, n + 1, size=(n, lanes)).astype(np.int32)
    # loopback slots: FREE, in the node's pool, and past it (clamped)
    loop = rng.integers(-1, ppn + 2, size=(n, lanes)).astype(np.int32)
    got = to_numpy(tbg.pull_commit(to_torch(pool), to_torch(send),
                                   to_torch(choice), to_torch(loop)))
    assert got.shape == (n, lanes) + PAGE
    for j in range(n):
        want = jbg.pull_commit(jnp.asarray(pool[j * ppn:(j + 1) * ppn]),
                               jnp.asarray(send[:, j]), jnp.asarray(choice[j]),
                               jnp.asarray(loop[j]), interpret=True)
        assert np.array_equal(got[j], np.asarray(want)), f"requester {j}"


def landed_window(data, base, j, lanes):
    """Requester j's data window [lanes, E] of the reference's engine."""
    rows = base[j] + np.arange(lanes)
    win = np.zeros((lanes,) + data.shape[2:], data.dtype)
    ok = rows < data.shape[1]
    win[ok] = data[j, rows[ok]]
    return win.reshape(lanes, -1)


@pytest.mark.parametrize("channels", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_push_commit_matches_reference(channels, dtype):
    rng = np.random.default_rng(channels * 7 + len(dtype))
    np_dt, _ = DTYPES[dtype]
    n, ppn, budget, d_rows = 5, 6, 7, 9
    cb = -(-budget // channels)
    lanes = channels * cb
    pool = random_pages(rng, (n * ppn,) + PAGE, np_dt)
    # FREE lanes, slots past the node's pool and many duplicates
    slots = rng.integers(-1, ppn + 1, size=(n, n, lanes)).astype(np.int32)
    data = random_pages(rng, (n, d_rows) + PAGE, np_dt)
    base = rng.integers(0, d_rows, size=n).astype(np.int32)  # runs past D
    got = to_numpy(tbg.push_commit(to_torch(pool), to_torch(slots),
                                   to_torch(data), to_torch(base),
                                   channels=channels, cb=cb))
    e = int(np.prod(PAGE))
    for h in range(n):
        shard = jnp.asarray(pool[h * ppn:(h + 1) * ppn].reshape(ppn, e))
        landed = np.stack([landed_window(data, base, (h - k) % n, lanes)
                           for k in range(1, n)])
        want = jbg.push_commit(
            jbg.pad_pool(shard), jnp.asarray(slots[h]),
            jnp.asarray(landed_window(data, base, h, lanes)),
            jnp.asarray(landed), channels=channels, cb=cb, interpret=True)
        assert np.array_equal(got[h * ppn:(h + 1) * ppn].reshape(ppn, e),
                              np.asarray(want)[:ppn]), f"home {h}"


# ---------------------------------------------------------------------------
# The N-node engine against the oracles
# ---------------------------------------------------------------------------

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


def budgets(rng, n, budget):
    """Unthrottled, and a per-node active_budget below ``budget``."""
    return [None, rng.integers(0, budget, size=n).astype(np.int32)]


NODES = [2, 3, 5, 8]
CHANNELS = [1, 2, 4]


@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("n", NODES)
def test_pull_pages_nnode_matches_oracle(n, channels):
    rng = np.random.default_rng(n * 10 + channels)
    ppn, budget, r = 7, 5, 11
    jtable, ttable = random_table(rng, n * ppn - 3, n, ppn)
    want = rng.integers(-1, n * ppn - 3, size=(n, r)).astype(np.int32)
    for dname, (np_dt, _) in DTYPES.items():
        pool = random_pages(rng, (n * ppn,) + PAGE, np_dt)
        for pname, jprog, tprog in program_variants(n):
            for ab in budgets(rng, n, budget):
                exp = ref.pull_pages_pipelined_ref(
                    jnp.asarray(pool), jnp.asarray(want), jtable, ppn, jprog,
                    budget=budget, channels=channels, active_budget=ab)
                if ab is None:
                    np.testing.assert_array_equal(np.asarray(exp), np.asarray(
                        ref.pull_pages_ref(jnp.asarray(pool),
                                           jnp.asarray(want), jtable, ppn,
                                           jprog)))
                got = tbridge.pull_pages(
                    to_torch(pool), to_torch(want), ttable, num_nodes=n,
                    budget=budget, channels=channels, program=tprog,
                    active_budget=None if ab is None else to_torch(ab))
                assert np.array_equal(to_numpy(got), np.asarray(exp)), (
                    dname, pname, ab)


@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("n", NODES)
def test_push_pages_nnode_matches_oracle(n, channels):
    rng = np.random.default_rng(n * 10 + channels + 500)
    ppn, budget, r = 11, 5, 9
    jtable, ttable = random_table(rng, n * ppn - 3, n, ppn)
    # single-writer pages across nodes; one node writes a page twice (the
    # later write wins)
    dest = rng.permutation(n * ppn - 3)[:n * r].reshape(n, r).astype(np.int32)
    dest[rng.random(dest.shape) < 0.15] = FREE
    dest[n - 1, r - 1] = dest[n - 1, 0]
    for dname, (np_dt, _) in DTYPES.items():
        pool = random_pages(rng, (n * ppn,) + PAGE, np_dt)
        payload = random_pages(rng, (n, r) + PAGE, np_dt)
        for pname, jprog, tprog in program_variants(n):
            for ab in budgets(rng, n, budget):
                exp = ref.push_pages_pipelined_ref(
                    jnp.asarray(pool), jnp.asarray(dest), jnp.asarray(payload),
                    jtable, ppn, jprog, budget=budget, channels=channels,
                    active_budget=ab)
                pool_t = to_torch(pool)
                got = tbridge.push_pages(
                    pool_t, to_torch(dest), to_torch(payload), ttable,
                    num_nodes=n, budget=budget, channels=channels,
                    program=tprog,
                    active_budget=None if ab is None else to_torch(ab))
                assert got is pool_t                  # updated in place
                assert np.array_equal(to_numpy(got), np.asarray(exp)), (
                    dname, pname, ab)


def test_scalar_active_budget_and_default_program_match_oracle():
    """An int rate limiter is shared by every node; no program means full
    bidirectional coverage; zero rounds pull zeros and push nothing."""
    rng = np.random.default_rng(3)
    n, ppn, budget = 4, 6, 4
    jtable, ttable = random_table(rng, n * ppn, n, ppn, unmapped=0.0)
    pool = random_pages(rng, (n * ppn,) + PAGE, np.float32)
    want = rng.integers(-1, n * ppn, size=(n, 10)).astype(np.int32)
    exp = ref.pull_pages_pipelined_ref(
        jnp.asarray(pool), jnp.asarray(want), jtable, ppn, None,
        budget=budget, channels=1, active_budget=np.full(n, 2))
    got = tbridge.pull_pages(to_torch(pool), to_torch(want), ttable,
                             num_nodes=n, budget=budget, active_budget=2)
    assert np.array_equal(got.numpy(), np.asarray(exp))
    empty = torch.zeros((n, 0), dtype=torch.int32)
    assert tuple(tbridge.pull_pages(to_torch(pool), empty, ttable,
                                    num_nodes=n).shape) == (n, 0) + PAGE
    pool_t = to_torch(pool)
    tbridge.push_pages(pool_t, empty, torch.zeros((n, 0) + PAGE), ttable,
                       num_nodes=n)
    assert np.array_equal(pool_t.numpy(), pool)


def test_nnode_arguments_are_checked():
    n, ppn = 4, 3
    pool = torch.zeros((n * ppn,) + PAGE)
    table = TTable.striped(n * ppn, n, ppn, device="cpu")
    want = torch.zeros((n, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="slots"):
        tbridge.pull_pages(pool, want, table, num_nodes=n,
                           program=ts.bidirectional_program(3, device="cpu"))
    with pytest.raises(ValueError, match="channels"):
        tbridge.pull_pages(pool, want, table, num_nodes=n, channels=0)
    with pytest.raises(ValueError, match="num_nodes"):
        tbridge.pull_pages(pool, want[:3], table, num_nodes=n)
    with pytest.raises(ValueError, match="split"):
        tbridge.pull_pages(pool[:-1], want, table, num_nodes=n)
    with pytest.raises(ValueError, match="payload"):
        tbridge.push_pages(pool, want, torch.zeros((n, 3) + PAGE), table,
                           num_nodes=n)
    with pytest.raises(ValueError, match="tenant_ids"):
        tbridge.push_pages(pool, want, torch.zeros((n, 2) + PAGE), table,
                           num_nodes=n, collect_telemetry=True,
                           tenant_ids=torch.zeros((n, 3), dtype=torch.int32))


def test_nnode_engine_matches_jax_fused_engine_on_8_devices():
    """The JAX fused engine ("a2a" lowering, pull_commit / push_commit) on
    8 virtual CPU devices, bidirectional and hierarchical programs at
    channels 2: the port's pages and in-band counters must match it bit
    for bit; then the 8-node push attention."""
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", str(REPO)),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_fused_a2a_8dev.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert "ALL OK" in proc.stdout
    assert proc.stdout.count("ok: ") == 8
    assert "push attention: " in proc.stdout
