"""Port parity: the paged KV cache through the loopback bridge.

Token after token, ``append`` writes the same random (k, v) into both
packages' caches and ``decode_attention_pull`` attends a random query over
them, over enough steps to flush several pages into the pool.  The pools and
tail buffers must match bit for bit (only data moves); the attention output
matches at 1e-5 in float32 (the online softmax sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvbridge as jkv
from repro.core.memport import MemPortTable as JTable

from repro_torch.core import kvbridge as tkv
from repro_torch.core.memport import MemPortTable as TTable

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
