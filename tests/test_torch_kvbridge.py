"""Port parity: the paged KV cache through the bridge.

Token after token, ``append`` writes the same random (k, v) into both
packages' caches and ``decode_attention_pull`` attends a random query over
them, over enough steps to flush several pages into the pool.  The pools and
tail buffers must match bit for bit (only data moves); the attention output
matches at 1e-5 in float32 (the online softmax sums in another order).  The
port's cache striped over 1, 2 or 8 memory nodes is held to
``ref.push_pages_ref`` on the same flushes, and its attention to the
reference's dense attention and one-node ``decode_attention_pull``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvbridge as jkv
from repro.core.memport import MemPortTable as JTable

from repro_torch.core import kvbridge as tkv
from repro_torch.core.memport import FREE, MemPortTable as TTable

TOL = dict(rtol=1e-5, atol=1e-5)


# (B, H, kv, hd, page_tokens, max_len, budget, steps)
CASES = [
    (3, 4, 2, 8, 4, 20, 3, 13),    # rounds straddle sequences, last partial
    (2, 8, 2, 16, 8, 32, 8, 20),   # one round holds every page
]


@pytest.mark.parametrize("b,h,kv,hd,t,max_len,budget,steps", CASES)
def test_append_and_pull_match_reference(b, h, kv, hd, t, max_len, budget,
                                         steps):
    rng = np.random.default_rng(b * 100 + t)
    max_pages = -(-max_len // t)
    pool_shape = (b * max_pages, t, kv, hd)
    tail_shape = (b, t, kv, hd)
    j_layer = jkv.PagedKVLayer(
        k_pool=jnp.zeros(pool_shape), v_pool=jnp.zeros(pool_shape),
        tail_k=jnp.zeros(tail_shape), tail_v=jnp.zeros(tail_shape))
    j_table = JTable.striped(b * max_pages, 1, b * max_pages)
    t_layer = tkv.PagedKVLayer(
        k_pool=torch.zeros(pool_shape), v_pool=torch.zeros(pool_shape),
        tail_k=torch.zeros(tail_shape), tail_v=torch.zeros(tail_shape))
    t_table = TTable.striped(b * max_pages, 1, b * max_pages, device="cpu")
    kw = dict(page_tokens=t, max_pages=max_pages, budget=budget)

    @jax.jit
    def j_step(layer, lengths, k_new, v_new, q):
        layer = jkv.append(layer, j_table, lengths, k_new, v_new, mesh=None,
                           **kw)
        out = jkv.decode_attention_pull(q, layer, j_table, lengths + 1,
                                        mesh=None, **kw)
        return layer, out

    hist_k = np.zeros((b, steps, kv, hd), np.float32)
    hist_v = np.zeros((b, steps, kv, hd), np.float32)
    for step in range(steps):
        lengths = np.full((b,), step, np.int32)
        k_new = rng.standard_normal((b, kv, hd)).astype(np.float32)
        v_new = rng.standard_normal((b, kv, hd)).astype(np.float32)
        q = rng.standard_normal((b, h, hd)).astype(np.float32)
        hist_k[:, step], hist_v[:, step] = k_new, v_new
        j_layer, j_out = j_step(j_layer, jnp.asarray(lengths),
                                jnp.asarray(k_new), jnp.asarray(v_new),
                                jnp.asarray(q))
        t_lengths = torch.from_numpy(lengths)
        t_layer = tkv.append(t_layer, t_table, t_lengths,
                             torch.from_numpy(k_new), torch.from_numpy(v_new),
                             **kw)
        t_out = tkv.decode_attention_pull(torch.from_numpy(q), t_layer,
                                          t_table, t_lengths + 1, **kw)
        for name in ("k_pool", "v_pool", "tail_k", "tail_v"):
            assert np.array_equal(getattr(t_layer, name).numpy(),
                                  np.asarray(getattr(j_layer, name))), name
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
        # ... and both equal dense attention over the whole history.
        dense = tkv.decode_attention_ref(
            torch.from_numpy(q), torch.from_numpy(hist_k),
            torch.from_numpy(hist_v), t_lengths + 1)
        np.testing.assert_allclose(t_out.numpy(), dense.numpy(), **TOL)
    assert (steps // t) >= 2      # pages were flushed and pulled back


def test_logical_page_ids_match_reference():
    want = np.asarray(jkv.logical_page_ids(3, 5))
    got = tkv.logical_page_ids(3, 5, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_decode_attention_ref_matches_reference():
    rng = np.random.default_rng(11)
    q = rng.standard_normal((3, 8, 16)).astype(np.float32)
    k = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    lengths = np.array([1, 7, 10], np.int32)
    want = jkv.decode_attention_ref(*map(jnp.asarray, (q, k, v, lengths)))
    got = tkv.decode_attention_ref(*map(torch.from_numpy, (q, k, v, lengths)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (num_nodes, channels): the batch of 3 splits evenly over neither 2 nor 8
# nodes, so padding rows ride along; 8 nodes leave most of them idle.
NNODE_CASES = [(1, 1), (2, 1), (2, 2), (8, 1), (8, 4)]


@pytest.mark.parametrize("num_nodes,channels", NNODE_CASES)
def test_append_and_pull_over_nodes_match_reference(num_nodes, channels):
    """The cache striped over ``num_nodes`` memory nodes: after every append
    the pools equal ``ref.push_pages_ref`` applied to the same flushes (bit
    for bit), and the attention output is within 1e-5 of the reference's
    dense attention and of its one-node ``decode_attention_pull``."""
    from repro.core import ref as jref
    b, h, kv, hd, t, max_len, budget, steps = 3, 4, 2, 8, 4, 24, 3, 17
    rng = np.random.default_rng(40 + num_nodes * 3 + channels)
    max_pages = -(-max_len // t)
    per_node = -(-b // num_nodes)
    ppn = -(-b * max_pages // num_nodes)
    pool_shape = (num_nodes * ppn, t, kv, hd)
    tail_shape = (b, t, kv, hd)
    t_layer = tkv.PagedKVLayer(
        k_pool=torch.zeros(pool_shape), v_pool=torch.zeros(pool_shape),
        tail_k=torch.zeros(tail_shape), tail_v=torch.zeros(tail_shape))
    t_table = TTable.striped(b * max_pages, num_nodes, ppn, device="cpu")
    j_table_n = JTable.striped(b * max_pages, num_nodes, ppn)
    kw = dict(page_tokens=t, max_pages=max_pages, budget=budget)
    # The reference's one-node cache, for its decode_attention_pull.
    one = (b * max_pages, t, kv, hd)
    j_layer = jkv.PagedKVLayer(k_pool=jnp.zeros(one), v_pool=jnp.zeros(one),
                               tail_k=jnp.zeros(tail_shape),
                               tail_v=jnp.zeros(tail_shape))
    j_table = JTable.striped(b * max_pages, 1, b * max_pages)

    @jax.jit
    def j_step(layer, lengths, k_new, v_new, q):
        layer = jkv.append(layer, j_table, lengths, k_new, v_new, mesh=None,
                           **kw)
        return layer, jkv.decode_attention_pull(q, layer, j_table,
                                                lengths + 1, mesh=None, **kw)

    ref_k, ref_v = jnp.zeros(pool_shape), jnp.zeros(pool_shape)
    tail_k, tail_v = np.zeros(tail_shape, np.float32), np.zeros(
        tail_shape, np.float32)
    hist_k = np.zeros((b, steps, kv, hd), np.float32)
    hist_v = np.zeros((b, steps, kv, hd), np.float32)

    def by_node(x, fill):
        pad = num_nodes * per_node - b
        x = np.concatenate([x, np.full((pad,) + x.shape[1:], fill, x.dtype)])
        return jnp.asarray(x.reshape((num_nodes, per_node) + x.shape[1:]))

    for step in range(steps):
        lengths = np.full((b,), step, np.int32)
        k_new = rng.standard_normal((b, kv, hd)).astype(np.float32)
        v_new = rng.standard_normal((b, kv, hd)).astype(np.float32)
        q = rng.standard_normal((b, h, hd)).astype(np.float32)
        hist_k[:, step], hist_v[:, step] = k_new, v_new
        # What the step flushes: each tail page that this token fills.
        off = step % t
        tail_k[:, off], tail_v[:, off] = k_new, v_new
        full = off == t - 1 and step // t < max_pages
        dest = np.where(full, np.arange(b) * max_pages + step // t,
                        FREE).astype(np.int32)
        for name, tail in (("k", tail_k), ("v", tail_v)):
            pool = ref_k if name == "k" else ref_v
            pool = jref.push_pages_ref(pool, by_node(dest, FREE),
                                       by_node(tail, 0.0), j_table_n, ppn)
            if name == "k":
                ref_k = pool
            else:
                ref_v = pool
        if full:
            tail_k[:], tail_v[:] = 0.0, 0.0

        t_lengths = torch.from_numpy(lengths)
        t_layer = tkv.append(t_layer, t_table, t_lengths,
                             torch.from_numpy(k_new), torch.from_numpy(v_new),
                             num_nodes=num_nodes, channels=channels, **kw)
        t_out = tkv.decode_attention_pull(
            torch.from_numpy(q), t_layer, t_table, t_lengths + 1,
            num_nodes=num_nodes, channels=channels, **kw)
        assert np.array_equal(t_layer.k_pool.numpy(), np.asarray(ref_k))
        assert np.array_equal(t_layer.v_pool.numpy(), np.asarray(ref_v))
        assert np.array_equal(t_layer.tail_k.numpy(), tail_k)
        j_layer, j_out = j_step(j_layer, jnp.asarray(lengths),
                                jnp.asarray(k_new), jnp.asarray(v_new),
                                jnp.asarray(q))
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
        dense = jkv.decode_attention_ref(
            jnp.asarray(q), jnp.asarray(hist_k), jnp.asarray(hist_v),
            jnp.asarray(lengths + 1))
        np.testing.assert_allclose(t_out.numpy(), np.asarray(dense), **TOL)
    assert steps // t >= 3          # pages were flushed and pulled back
