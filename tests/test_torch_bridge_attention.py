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


def make_nnode_round(seed, fresh, nodes=8, budget=8, b=8, h=32, kv=8,
                     hd=128, t=16):
    """One round of the 8-node decode path at granite-3-8b's head layout:
    node j pulls ``budget`` pages of sequence j, node-major, so W = 64 lanes
    of 8 sequences; a few lanes are dead (FREE), one of them with its
    sequence id kept, which ``live`` alone must silence."""
    q, k, v, _, _, m, l, o = make_round(seed, b, h, kv, hd, nodes * budget, t,
                                        fresh)
    seq = np.repeat(np.arange(nodes, dtype=np.int32), budget) % b
    live = np.ones(nodes * budget, np.int32)
    live[[3, 17, 18, 40, 63]] = 0
    seq[[3, 17, 40, 63]] = -1              # lane 18 keeps its sequence
    return q, k, v, seq, live, m, l, o


@pytest.mark.parametrize("fresh", [True, False])
def test_stream_accumulate_matches_reference_at_the_8_node_round(fresh):
    args = make_nnode_round(7, fresh)
    for got, want in zip(run_port(args), run_jax(args)):
        np.testing.assert_allclose(got, want, **TOL)


def fold_by_lane_partials(q, k, v, seq, live, m, l, o):
    """The CUDA kernel's decomposition in plain PyTorch: each live lane's
    page partial (its row max, sum of exponentials and p @ v, as the shared
    fold computes them) merged into its sequence's state in landing order,
    m = max(m, m_i) and each side rescaled by exp(its m - m)
    (``csrc/decode_fold.cuh``, fold_page and merge_partials)."""
    q, k, v = (torch.from_numpy(x).float() for x in (q, k, v))
    m, l, o = (torch.from_numpy(x.copy()) for x in (m, l, o))
    b, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, kv, h // kv, hd)
    for i in range(k.shape[0]):
        if not live[i] or not 0 <= seq[i] < b:
            continue
        s = torch.einsum("kgd,tkd->kgt", qg[seq[i]], k[i]) * hd ** -0.5
        m_i = s.amax(-1)                                     # [kv, g]
        p = torch.exp(s - m_i[..., None])
        l_i = p.sum(-1)
        acc_i = torch.einsum("kgt,tkd->kgd", p, v[i])
        m_i, l_i, acc_i = m_i.reshape(h), l_i.reshape(h), acc_i.reshape(h, hd)
        mn = torch.maximum(m[seq[i]], m_i)
        a, bb = torch.exp(m[seq[i]] - mn), torch.exp(m_i - mn)
        l[seq[i]] = l[seq[i]] * a + l_i * bb
        o[seq[i]] = o[seq[i]] * a[:, None] + acc_i * bb[:, None]
        m[seq[i]] = mn
    return m.numpy(), l.numpy(), o.numpy()


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("round_", ["1-node", "8-node"])
def test_lane_partials_merged_in_landing_order_match_reference(round_, fresh):
    """The kernel's reordering (a partial per lane, merged in landing order)
    against the JAX kernel at granite-3-8b's head layout, scores spanning
    about +-30 and, fresh, the -1e30 initial state: within 1e-5."""
    if round_ == "1-node":
        args = list(make_round(8, 8, 32, 8, 128, 8, 16, fresh))
        args[3][:] = 5                               # one sequence's 8 pages
        args[4][:] = 1
    else:
        args = list(make_nnode_round(9, fresh))
    args[0] = args[0] * 6.0                          # q: scores to +-30
    s = np.einsum("bkgd,wtkd->bkgwt", args[0].reshape(8, 8, 4, 128),
                  args[1]) * 128 ** -0.5
    assert 25 < np.abs(s).max() < 35
    for got, want in zip(fold_by_lane_partials(*args), run_jax(args)):
        np.testing.assert_allclose(got, want, **TOL)
