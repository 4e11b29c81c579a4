"""Port parity: the streaming decode-attention accumulate.

The same numpy inputs go through the JAX package's
``stream_decode_accumulate`` on the CPU (its Pallas interpreter) and through
the port's plain version.  Tolerance: 1e-5 in float32, because the two
compute the same online-softmax update in the same lane order and differ
only in the order of the exp and dot-product sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bridge_attention import (
    stream_decode_accumulate as jax_stream)

from repro_torch.kernels import bridge_attention as tba

TOL = dict(rtol=1e-5, atol=1e-5)


def make_round(seed, b, h, kv, hd, w, t, fresh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((w, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((w, t, kv, hd)).astype(np.float32)
    seq = rng.integers(0, b, size=w).astype(np.int32)
    live = (rng.random(w) < 0.7).astype(np.int32)
    live[0] = 1
    seq[~live.astype(bool)] = -1            # dead lanes, as kvbridge marks them
    if fresh:                               # the state before the first round
        m = np.full((b, h), -1e30, np.float32)
        l = np.zeros((b, h), np.float32)
        o = np.zeros((b, h, hd), np.float32)
    else:                                   # the state after earlier rounds
        m = rng.standard_normal((b, h)).astype(np.float32)
        l = rng.uniform(0.5, 4.0, (b, h)).astype(np.float32)
        o = rng.standard_normal((b, h, hd)).astype(np.float32)
    return q, k, v, seq, live, m, l, o


def run_jax(args):
    return [np.asarray(x) for x in jax_stream(*map(jnp.asarray, args))]


def run_port(args):
    return [x.numpy() for x in tba.stream_decode_accumulate(
        *(torch.from_numpy(a.copy()) for a in args))]


# (seed, B, H, kv, hd, W, T, fresh state)
SHAPES = [
    (0, 3, 4, 2, 16, 6, 4, True),      # GQA g=2
    (1, 2, 8, 1, 32, 8, 8, False),     # MQA g=8
    (2, 4, 4, 4, 8, 5, 3, False),      # no grouping
    (3, 2, 32, 8, 128, 8, 16, True),   # granite-3-8b's head layout
]


@pytest.mark.parametrize("seed,b,h,kv,hd,w,t,fresh", SHAPES)
def test_stream_accumulate_matches_reference(seed, b, h, kv, hd, w, t, fresh):
    args = make_round(seed, b, h, kv, hd, w, t, fresh)
    for got, want in zip(run_port(args), run_jax(args)):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seed,b,h,kv,hd,w,t,fresh", SHAPES[:2])
def test_stream_accumulate_round_split_in_two(seed, b, h, kv, hd, w, t,
                                              fresh):
    """Folding a round as two half rounds in order equals folding it whole:
    the accumulate is lane-sequential, so the split changes nothing."""
    q, k, v, seq, live, m, l, o = make_round(seed, b, h, kv, hd, w, t, fresh)
    want = run_jax((q, k, v, seq, live, m, l, o))
    half = w // 2
    m1, l1, o1 = run_port((q, k[:half], v[:half], seq[:half], live[:half],
                           m, l, o))
    got = run_port((q, k[half:], v[half:], seq[half:], live[half:],
                    m1, l1, o1))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g, wnt, **TOL)


def test_stream_accumulate_all_dead_round_is_identity():
    q, k, v, seq, live, m, l, o = make_round(5, 2, 4, 2, 8, 4, 4, False)
    live[:] = 0
    seq[:] = -1
    for got, before in zip(run_port((q, k, v, seq, live, m, l, o)),
                           (m, l, o)):
        assert np.array_equal(got, before)


def test_stream_accumulate_rejects_bad_shapes():
    q, k, v, seq, live, m, l, o = (
        torch.from_numpy(a) for a in make_round(6, 2, 4, 2, 8, 4, 4, True))
    with pytest.raises(ValueError, match="shapes"):
        tba.stream_decode_accumulate(q, k, v[:2], seq, live, m, l, o)
