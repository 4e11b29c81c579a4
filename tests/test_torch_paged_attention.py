"""Port parity: paged decode attention over pool pages.

The same numpy pools, page tables and lengths go through the JAX package's
``ops.paged_attention`` (its Pallas kernel in interpret mode), its oracle
``ref.paged_attention_ref`` and the port's kernel API, which on CPU tensors
runs the plain version.  Tolerances are the reference suite's: 3e-5 in
float32 (the kernel's online softmax against the dense softmax), 3e-2 with
bfloat16 pools (one rounding of the output).  A seeded sweep of 15 random
placements and lengths stands in for the reference's hypothesis property.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref


def make_paged(b, max_pages, t, h, kv, hd, lengths, seed=0):
    rng = np.random.default_rng(seed)
    slots = b * max_pages + 3
    k_pool = rng.normal(size=(slots, t, kv, hd)).astype(np.float32)
    v_pool = rng.normal(size=(slots, t, kv, hd)).astype(np.float32)
    # random permutation placement: logical (b, p) -> random distinct slot
    table = rng.permutation(slots)[: b * max_pages].reshape(b, max_pages)
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    return (q, k_pool, v_pool, table.astype(np.int32),
            np.asarray(lengths, np.int32))


def run_both(args, max_pages, dtype=None):
    q, k_pool, v_pool, table, lengths = args
    jf = [jnp.asarray(a, dtype or jnp.float32) for a in (q, k_pool, v_pool)]
    tf = [torch.from_numpy(a) for a in (q, k_pool, v_pool)]
    if dtype is not None:
        tf = [x.bfloat16() for x in tf]
    jt, jl = jnp.asarray(table), jnp.asarray(lengths)
    tt, tl = torch.from_numpy(table), torch.from_numpy(lengths)
    got = tops.paged_attention(*tf, tt, tl, max_pages=max_pages)
    kernel = jops.paged_attention(*jf, jt, jl, max_pages=max_pages)
    oracle = jref.paged_attention_ref(*jf, jt, jl, max_pages=max_pages)
    return (got.float().numpy(), np.asarray(kernel, np.float32),
            np.asarray(oracle, np.float32))


@pytest.mark.parametrize("h,kv,hd", [(8, 8, 64), (8, 2, 64), (4, 1, 128)])
def test_paged_gqa_matches_reference(h, kv, hd):
    b, mp, t = 3, 4, 16
    args = make_paged(b, mp, t, h, kv, hd, [64, 33, 16])
    got, kernel, oracle = run_both(args, mp)
    np.testing.assert_allclose(got, kernel, atol=3e-5)
    np.testing.assert_allclose(got, oracle, atol=3e-5)


@pytest.mark.parametrize("seed", range(15))
def test_paged_random_placements(seed):
    """Random placements and ragged lengths (0 to 64 over 4 pages of 16)."""
    b, mp, t, h, kv, hd = 2, 4, 16, 4, 2, 64
    lengths = np.random.default_rng(10_000 + seed).integers(0, 65, size=b)
    args = make_paged(b, mp, t, h, kv, hd, lengths, seed)
    got, kernel, oracle = run_both(args, mp)
    np.testing.assert_allclose(got, kernel, atol=3e-5)
    np.testing.assert_allclose(got, oracle, atol=3e-5)


def test_paged_bf16_pool():
    b, mp, t, h, kv, hd = 2, 3, 8, 4, 4, 64
    args = make_paged(b, mp, t, h, kv, hd, [24, 17])
    got, kernel, oracle = run_both(args, mp, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, kernel, atol=3e-2)
    np.testing.assert_allclose(got, oracle, atol=3e-2)


def test_paged_unmapped_entry_and_empty_sequence():
    """A -1 table entry below the flushed count reads slot 0, as the
    reference's kernel and oracle do; a sequence of length 0 (and one of
    length 7, no full page) gives zeros."""
    b, mp, t, h, kv, hd = 4, 4, 8, 4, 2, 32
    q, k_pool, v_pool, table, lengths = make_paged(
        b, mp, t, h, kv, hd, [32, 0, 7, 29], seed=7)
    table[0, 1] = -1
    table[3, 2] = -1
    args = (q, k_pool, v_pool, table, lengths)
    got, kernel, oracle = run_both(args, mp)
    np.testing.assert_allclose(got, kernel, atol=3e-5)
    np.testing.assert_allclose(got, oracle, atol=3e-5)
    assert not got[1].any() and not got[2].any()
    moved = table.copy()
    moved[0, 1] = 5                      # another slot: the result changes
    assert not np.allclose(run_both((q, k_pool, v_pool, moved, lengths),
                                    mp)[0], got, atol=1e-3)


def test_paged_slot_past_the_pool_reads_the_last_slot():
    """jnp indexing clamps in the reference's oracle; the port copies it."""
    b, mp, t, h, kv, hd = 2, 2, 8, 4, 2, 32
    q, k_pool, v_pool, table, lengths = make_paged(b, mp, t, h, kv, hd,
                                                   [16, 16], seed=8)
    slots = k_pool.shape[0]
    far = table.copy()
    far[1, 0] = slots + 40
    last = table.copy()
    last[1, 0] = slots - 1
    got_far = run_both((q, k_pool, v_pool, far, lengths), mp)
    got_last = run_both((q, k_pool, v_pool, last, lengths), mp)
    np.testing.assert_allclose(got_far[0], got_far[2], atol=3e-5)
    np.testing.assert_array_equal(got_far[0], got_last[0])


def test_paged_ref_names_the_plain_version_and_checks_shapes():
    q, k_pool, v_pool, table, lengths = (
        torch.from_numpy(a) for a in make_paged(2, 3, 4, 4, 2, 16, [9, 12]))
    want = tpa.paged_attention_plain(q, k_pool, v_pool, table, lengths,
                                     max_pages=3)
    got = tref.paged_attention_ref(q, k_pool, v_pool, table, lengths,
                                   max_pages=3)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="max_pages=4"):
        tpa.paged_attention(q, k_pool, v_pool, table, lengths, max_pages=4)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_attention(q, k_pool, v_pool, table.long(), lengths,
                            max_pages=3)
    assert tpa.paged_attention.launches == 0


def test_paged_never_falls_back_off_the_cpu():
    meta = dict(device="meta")
    q = torch.empty((2, 4, 16), **meta)
    pool = torch.empty((6, 4, 2, 16), **meta)
    table = torch.empty((2, 3), dtype=torch.int32, **meta)
    lengths = torch.empty((2,), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(q, pool, pool, table, lengths, max_pages=3)
    with pytest.raises(ValueError, match="one device"):
        tpa.paged_attention(q, pool, pool,
                            torch.zeros((2, 3), dtype=torch.int32), lengths,
                            max_pages=3)
    assert tpa.paged_attention.launches == 0


# The ragged lengths of the smoke run's paged check (B 8, T 16, 64 pages):
# a full sequence, an empty one, under a page, exactly one page, and lengths
# that end inside a page.
SMOKE_LENGTHS = [1024, 0, 17, 500, 1023, 16, 777, 64]


def make_smoke_paged(dtype=None, q_scale=1.0, seed=11):
    """The smoke run's paged shapes at granite-3-8b's head layout (32/8 heads
    of 128), with one -1 entry and one slot past the pool."""
    b, mp, t, h, kv, hd = 8, 64, 16, 32, 8, 128
    q, k_pool, v_pool, table, lengths = make_paged(b, mp, t, h, kv, hd,
                                                   SMOKE_LENGTHS, seed)
    table[2, 0] = -1
    table[6, 40] = k_pool.shape[0] + 5
    q = q * q_scale
    if dtype is not None:                  # the values a bf16 pool holds
        q, k_pool, v_pool = (torch.from_numpy(x).bfloat16().float().numpy()
                             for x in (q, k_pool, v_pool))
    return (q, k_pool, v_pool, table, lengths), mp


@pytest.mark.parametrize("dtype,tol", [(None, 3e-5), (jnp.bfloat16, 3e-2)])
def test_paged_matches_reference_at_the_smoke_lengths(dtype, tol):
    args, mp = make_smoke_paged(dtype)
    got, kernel, oracle = run_both(args, mp, dtype=dtype)
    np.testing.assert_allclose(got, kernel, atol=tol)
    np.testing.assert_allclose(got, oracle, atol=tol)
    assert not got[1].any()


def _merge(a, b):
    """Two partial states (m, l, acc) merged as kvbridge._merge does."""
    m = torch.maximum(a[0], b[0])
    x, y = torch.exp(a[0] - m), torch.exp(b[0] - m)
    return m, a[1] * x + b[1] * y, a[2] * x[:, None] + b[2] * y[:, None]


def paged_by_split_partials(q, k_pool, v_pool, table, lengths, max_pages,
                            split=tpa.SPLIT_PAGES, warps=4):
    """The CUDA kernels' decomposition in plain PyTorch: a sequence's
    flushed pages cut into splits of ``split`` pages; in a split, warp w
    folds pages w, w + warps, ... (each page's partial merged into the
    warp's), the warps' partials merge in warp order, the splits' partials
    in split order into the empty state (-1e30, 0, 0), and the output is
    acc / max(l, 1e-30) (``csrc/paged_attention.cu``)."""
    q, kp, vp = (torch.from_numpy(x).float() for x in (q, k_pool, v_pool))
    b, h, hd = q.shape
    slots, t, kv, _ = kp.shape
    g = h // kv
    out = torch.zeros((b, h, hd))
    for bi in range(b):
        pages = min(int(lengths[bi]) // t, max_pages)
        qg = q[bi].reshape(kv, g, hd)

        def page(p):
            slot = min(max(int(table[bi, p]), 0), slots - 1)
            s = torch.einsum("kgd,tkd->kgt", qg, kp[slot]) * hd ** -0.5
            m = s.amax(-1)
            e = torch.exp(s - m[..., None])
            acc = torch.einsum("kgt,tkd->kgd", e, vp[slot])
            return m.reshape(h), e.sum(-1).reshape(h), acc.reshape(h, hd)

        state = (torch.full((h,), -1e30), torch.zeros(h), torch.zeros(h, hd))
        for p0 in range(0, pages, split):
            n = min(split, pages - p0)
            parts = []
            for w in range(min(warps, n)):
                part = page(p0 + w)
                for p in range(p0 + w + warps, p0 + n, warps):
                    part = _merge(part, page(p))
                parts.append(part)
            block = parts[0]
            for part in parts[1:]:
                block = _merge(block, part)
            state = _merge(state, block)
        out[bi] = state[2] / state[1].clamp(min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("dtype,tol", [(None, 3e-5), (jnp.bfloat16, 3e-2)])
def test_split_partials_merged_in_split_order_match_reference(dtype, tol):
    """The kernels' reordering (per-warp and per-split partials, merged in
    warp and split order) against the JAX kernel at the smoke's lengths and
    granite-3-8b's head layout, with scores spanning about +-30."""
    args, mp = make_smoke_paged(dtype, q_scale=6.0)
    q, k_pool = args[:2]
    s = np.einsum("bkgd,ntkd->bkgnt", q.reshape(8, 8, 4, 128),
                  k_pool[:64]) * 128 ** -0.5
    assert 25 < np.abs(s).max() < 35
    got = paged_by_split_partials(*args, mp)
    if dtype is not None:
        got = got.bfloat16().float()
    jf = [jnp.asarray(a, dtype or jnp.float32) for a in args[:3]]
    want = np.asarray(jops.paged_attention(*jf, jnp.asarray(args[3]),
                                           jnp.asarray(args[4]),
                                           max_pages=mp), np.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    assert not got[1].any()
