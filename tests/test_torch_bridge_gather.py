"""Port parity: page gather/scatter and the loopback bridge, bit for bit.

The same numpy inputs, made from a seed, go through the JAX package on the
CPU (its kernels' off-TPU lax path, ``interpret=True``) and through the
port's plain versions (the port picks them for CPU tensors).  Data movement
must match exactly (``np.array_equal``): no arithmetic touches a page.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bridge as jbridge
from repro.core.memport import MemPortTable as JTable
from repro.kernels import bridge_gather as jbg

from repro_torch.core import bridge as tbridge
from repro_torch.core.memport import FREE, MemPortTable as TTable
from repro_torch.kernels import bridge_gather as tbg


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor (a copy: the port updates pools in place)."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def random_pool(rng, rows, page=(4, 2, 8), dtype=np.float32):
    return rng.standard_normal((rows,) + page).astype(np.float32).astype(dtype)


def ids_with_free(rng, shape, hi, free_frac=0.3):
    ids = rng.integers(0, hi, size=shape).astype(np.int32)
    ids[rng.random(shape) < free_frac] = FREE
    return ids


# ``past``: ids are drawn up to rows + past, so some lie past the pool; the
# reference's off-TPU path clamps them (gather) or drops them (scatter).
@pytest.mark.parametrize("seed,rows,shape,dtype,past", [
    (0, 16, (8,), np.float32, 0),
    (1, 9, (3, 5), np.float32, 0),
    (2, 32, (24,), jnp.bfloat16, 0),
    (3, 5, (1,), np.float32, 0),
    (5, 6, (12,), np.float32, 4),
])
def test_gather_pages_matches_reference(seed, rows, shape, dtype, past):
    rng = np.random.default_rng(seed)
    pool = random_pool(rng, rows, dtype=dtype)
    reqs = ids_with_free(rng, shape, rows + past)
    want = np.asarray(jbg.gather_pages(jnp.asarray(pool), jnp.asarray(reqs),
                                       interpret=True))
    got = tbg.gather_pages(to_torch(pool), to_torch(reqs))
    assert got.shape == want.shape
    assert np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("seed,rows,w,dtype,past", [
    (0, 16, 8, np.float32, 0),
    (1, 6, 12, np.float32, 0),      # more lanes than rows: many duplicates
    (2, 32, 24, jnp.bfloat16, 0),
    (5, 6, 12, np.float32, 4),
])
def test_scatter_pages_matches_reference(seed, rows, w, dtype, past):
    rng = np.random.default_rng(seed)
    pool = random_pool(rng, rows, dtype=dtype)
    slots = ids_with_free(rng, (w,), rows + past)
    slots[-1] = slots[0] = max(slots[0], 0)   # a live duplicate, last wins
    data = random_pool(rng, w, dtype=dtype)
    want = np.asarray(jbg.scatter_pages(jnp.asarray(pool), jnp.asarray(slots),
                                        jnp.asarray(data), interpret=True))
    pool_t = to_torch(pool)
    got = tbg.scatter_pages(pool_t, to_torch(slots), to_torch(data))
    assert got is pool_t                      # updated in place
    assert np.array_equal(to_numpy(got), want)


def random_table(rng, num_logical, ppn, nodes=1, unmapped=0.15):
    """A permuted placement with some unmapped (FREE) logical pages."""
    flat = rng.permutation(nodes * ppn)[:num_logical]
    home = (flat // ppn).astype(np.int32)
    slot = (flat % ppn).astype(np.int32)
    off = rng.random(num_logical) < unmapped
    home[off] = FREE
    slot[off] = FREE
    return home, slot


# (seed, pool rows, nodes x requests, budget, active_budget): the last cases
# throttle the rate limiter so requests spill.
LOOPBACK_CASES = [
    (0, 24, (1, 16), 8, None),
    (1, 24, (2, 11), 4, None),
    (2, 20, (1, 13), 8, None),
    (3, 24, (1, 20), 8, 3),
    (4, 16, (2, 9), 4, 1),
]


@pytest.mark.parametrize("seed,ppn,shape,budget,ab", LOOPBACK_CASES)
def test_pull_pages_loopback_matches_reference(seed, ppn, shape, budget, ab):
    rng = np.random.default_rng(seed)
    num_logical = ppn - 2
    home, slot = random_table(rng, num_logical, ppn)
    pool = random_pool(rng, ppn)
    want = ids_with_free(rng, shape, num_logical, free_frac=0.2)
    kw = dict(budget=budget)
    ref = jbridge.pull_pages(
        jnp.asarray(pool), jnp.asarray(want),
        JTable(home=jnp.asarray(home), slot=jnp.asarray(slot)), mesh=None,
        active_budget=None if ab is None else jnp.int32(ab), **kw)
    got = tbridge.pull_pages(
        to_torch(pool), to_torch(want),
        TTable(home=to_torch(home), slot=to_torch(slot)),
        active_budget=None if ab is None else torch.tensor(ab, dtype=torch.int32),
        **kw)
    assert tuple(got.shape) == ref.shape
    assert np.array_equal(to_numpy(got), np.asarray(ref))


@pytest.mark.parametrize("seed,ppn,shape,budget,ab", LOOPBACK_CASES)
def test_push_pages_loopback_matches_reference(seed, ppn, shape, budget, ab):
    rng = np.random.default_rng(seed)
    num_logical = ppn - 2
    home, slot = random_table(rng, num_logical, ppn)
    pool = random_pool(rng, ppn)
    dest = ids_with_free(rng, shape, num_logical, free_frac=0.2)
    dest.reshape(-1)[-1] = dest.reshape(-1)[0] = 1   # a duplicate write
    payload = random_pool(rng, int(np.prod(shape))).reshape(
        shape + pool.shape[1:])
    kw = dict(budget=budget)
    ref = jbridge.push_pages(
        jnp.asarray(pool), jnp.asarray(dest), jnp.asarray(payload),
        JTable(home=jnp.asarray(home), slot=jnp.asarray(slot)), mesh=None,
        active_budget=None if ab is None else jnp.int32(ab), **kw)
    got = tbridge.push_pages(
        to_torch(pool), to_torch(dest), to_torch(payload),
        TTable(home=to_torch(home), slot=to_torch(slot)),
        active_budget=None if ab is None else torch.tensor(ab, dtype=torch.int32),
        **kw)
    assert np.array_equal(to_numpy(got), np.asarray(ref))


def test_memport_translate_matches_reference():
    rng = np.random.default_rng(7)
    home, slot = random_table(rng, 30, 12, nodes=3)
    ids = ids_with_free(rng, (40,), 30)
    jh, js = JTable(home=jnp.asarray(home), slot=jnp.asarray(slot)).translate(
        jnp.asarray(ids))
    th, ts = TTable(home=to_torch(home), slot=to_torch(slot)).translate(
        to_torch(ids))
    assert th.dtype == ts.dtype == torch.int32
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    jt = JTable.striped(30, 3, 10)
    tt = TTable.striped(30, 3, 10, device="cpu")
    assert np.array_equal(tt.home.numpy(), np.asarray(jt.home))
    assert np.array_equal(tt.slot.numpy(), np.asarray(jt.slot))
    with pytest.raises(ValueError):
        TTable.striped(31, 3, 10, device="cpu")


@pytest.mark.parametrize("kwargs", [dict(collect_telemetry=True)])
def test_unported_bridge_options_raise(kwargs):
    """The options that once raised here (in-band telemetry) now run: both
    entry points return ``(pages, telemetry)``, one counter row per request
    row on the loopback path."""
    pool = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    want = torch.tensor([[2, -1, 0, 3]], dtype=torch.int32)
    table = TTable.striped(4, 1, 4, device="cpu")
    pages, telem = tbridge.pull_pages(pool, want, table, **kwargs)
    assert torch.equal(pages[0, 0], pool[2]) and not pages[0, 1].any()
    assert telem.loopback_served.tolist() == [3]
    assert telem.tenant_served.tolist() == [[3, 0, 0, 0]]
    out, telem = tbridge.push_pages(pool, want, pool[None], table, **kwargs)
    assert out is pool and telem.traffic.tolist() == [[3]]
