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
