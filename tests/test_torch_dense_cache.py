"""Port parity of the local (dense) KV cache past ``max_len``.

The reference's ``DenseCacheOps.append_and_attend`` writes with
``.at[rows, lengths].set``, which drops a write whose position is past the
cache, and keeps attending over the whole cache.  A continuous batcher keeps
stepping free slots, so their lengths run past ``max_len``.  The port must
drop those writes the same way: same inputs, from a seed with numpy, through
both packages, the written cache and the attention output held at 1e-5
(float32; the two sum the softmax in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro_torch.models import transformer as ttransformer

B, H, KV, HD, MAX_LEN = 4, 4, 2, 16, 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 3])
def test_dense_cache_past_max_len_matches_reference(window):
    rng = np.random.default_rng(7)
    shape = (B, MAX_LEN, KV, HD)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    # row 0 stays inside the cache, row 1 reaches max_len on the third step,
    # rows 2 and 3 start at and past it
    lengths = np.array([2, 5, 8, 11], dtype=np.int32)
    jops = jtransformer.DenseCacheOps(MAX_LEN, dtype=jnp.float32)
    tops = ttransformer.DenseCacheOps(MAX_LEN, dtype=torch.float32,
                                      device="cpu")
    jst = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    tst = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    for _ in range(4):
        q = rng.standard_normal((B, H, HD)).astype(np.float32)
        k_new, v_new = (rng.standard_normal((B, KV, HD)).astype(np.float32)
                        for _ in "kv")
        jatt, jst = jops.append_and_attend(
            None, jst, None, jnp.asarray(lengths), jnp.asarray(q),
            jnp.asarray(k_new), jnp.asarray(v_new), window=window)
        tatt, tst = tops.append_and_attend(
            None, tst, None, torch.from_numpy(lengths), torch.from_numpy(q),
            torch.from_numpy(k_new), torch.from_numpy(v_new), window=window)
        for name in "kv":
            torch.testing.assert_close(tst[name],
                                       torch.from_numpy(np.array(jst[name])),
                                       **TOL)
        torch.testing.assert_close(tatt, torch.from_numpy(np.array(jatt)),
                                   **TOL)
        lengths = lengths + 1
    # the rows past max_len kept the cache they started with
    assert torch.equal(tst["k"][2:], torch.from_numpy(k0[2:]))
    assert not torch.equal(tst["k"][:2], torch.from_numpy(k0[:2]))
