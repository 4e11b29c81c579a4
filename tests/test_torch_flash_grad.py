"""Port parity: flash attention's backward (the training path).

The same numpy inputs and output gradient go through ``jax.vjp`` of the
JAX package's ``models.flash.flash_attention`` (its custom VJP, plain JAX
on the CPU) and through the port: its plain backward
(``models.flash.flash_bwd_ref``, what the backward kernel computes), fed
the port's plain forward and log-sum-exp, and the autograd function
``models.flash.flash_attention`` on CPU tensors, which must give the plain
backward's gradients bit for bit.  Cases: causal, sliding window,
``q_offset`` (a continued prefill, and one whose first rows see no key),
GQA 4/2 and 8/1, bidirectional, and a ragged Sk.  Float32 within 1e-4;
bf16 within 2e-2 of the largest gradient (the reference rounds p and ds to
bf16 where the port does, but sums in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # minimal environments
    from hypofallback import given, settings, st

from repro.models import flash as jflash

from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import flash as tflash

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL = 1e-4
BF16_REL_TOL = 2e-2

# (B, Sq, Sk, H, kv, hd, causal, window, q_offset)
CASES = [
    (2, 40, 40, 4, 2, 16, True, 0, 0),        # causal, GQA 4/2
    (1, 48, 48, 8, 1, 8, True, 0, 0),         # GQA 8/1
    (1, 40, 40, 4, 2, 16, True, 9, 0),        # sliding window
    (1, 24, 56, 4, 2, 16, True, 0, 32),       # q_offset, ragged Sk
    (1, 32, 24, 4, 4, 16, True, 5, -6),       # first rows see no key
    (2, 30, 37, 4, 2, 24, False, 0, 0),       # bidirectional, ragged
]


def make(seed, b, sq, sk, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sq, h, hd)).astype(np.float32))


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _jax_vjp(q, k, v, do, causal, window, chunk, q_offset):
    out, vjp = jax.vjp(
        lambda q_, k_, v_: jflash.flash_attention(q_, k_, v_, causal, window,
                                                  chunk, q_offset), q, k, v)
    return (out, *vjp(do))


def jax_grads(arrays, dtype, causal, window, q_offset, chunk=16):
    """(o, dq, dk, dv) of the reference's custom VJP, jitted (one trace a
    shape and mask)."""
    q, k, v, do = (jnp.asarray(a, JDT[dtype]) for a in arrays)
    return [np.asarray(x, np.float32)
            for x in _jax_vjp(q, k, v, do, causal, window, chunk, q_offset)]


def port_plain(arrays, dtype, causal, window, q_offset):
    q, k, v, do = (torch.from_numpy(a).to(TDT[dtype]) for a in arrays)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    with torch.no_grad():
        o, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
        grads = tfa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    return o, lse, grads


def port_autograd(arrays, dtype, causal, window, q_offset):
    q, k, v, do = (torch.from_numpy(a).to(TDT[dtype]) for a in arrays)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tflash.flash_attention(*leaves, causal=causal, window=window,
                                 q_offset=q_offset)
    out.backward(do)
    return out.detach(), [x.grad for x in leaves]


def check(got, want, dtype, what):
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL,
                                   err_msg=what)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_REL_TOL * np.abs(want).max(), (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_jax_vjp(case, dtype):
    b, sq, sk, h, kv, hd, causal, window, q_offset = case
    arrays = make(sum(case[:6]), b, sq, sk, h, kv, hd)
    want = jax_grads(arrays, dtype, causal, window, q_offset)
    o, _, grads = port_plain(arrays, dtype, causal, window, q_offset)
    # A row that sees no key: the reference's chunked forward averages v
    # over the masked keys there (its exp(s - m) is 1 when m is -1e30 too),
    # where its Pallas kernel and the port give zeros; both backwards give
    # such a row zero gradients.
    dead = ~tflash._mask(torch.arange(sq) + q_offset, torch.arange(sk),
                         causal, window).any(1).numpy()
    assert not o[:, dead].any()
    want[0] = np.where(dead[None, :, None, None], 0, want[0])
    for name, got, ref in zip(("o", "dq", "dk", "dv"), (o, *grads), want):
        assert got.dtype == TDT[dtype], name
        check(got, ref, dtype, name)


@pytest.mark.parametrize("case", CASES[:5], ids=lambda c: "-".join(map(str, c)))
def test_lse_matches_reference_forward(case):
    """The forward's lse, as the reference's ``_flash_fwd_inner`` keeps it
    ([B, kv, G, Sq] there); -1e30 on a row that sees no key."""
    b, sq, sk, h, kv, hd, causal, window, q_offset = case
    arrays = make(sum(case[:6]), b, sq, sk, h, kv, hd)
    _, lse, _ = port_plain(arrays, "float32", causal, window, q_offset)
    _, want = jflash._flash_fwd_inner(
        *(jnp.asarray(a) for a in arrays[:3]), causal, window, 16, q_offset)
    want = np.asarray(want).reshape(b, h, sq)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    if q_offset < 0:
        assert (lse[..., :-q_offset] == np.float32(-1e30)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES[2:5], ids=lambda c: "-".join(map(str, c)))
def test_autograd_function_gives_the_plain_backward(case, dtype):
    b, sq, sk, h, kv, hd, causal, window, q_offset = case
    arrays = make(7 + sum(case[:6]), b, sq, sk, h, kv, hd)
    o, _, grads = port_plain(arrays, dtype, causal, window, q_offset)
    out, auto = port_autograd(arrays, dtype, causal, window, q_offset)
    assert torch.equal(out, o)
    for got, want in zip(auto, grads):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_dead_rows_get_zero_gradients():
    arrays = make(3, 1, 20, 20, 4, 2, 16)
    _, _, (dq, dk, dv) = port_plain(arrays, "float32", True, 4, -8)
    assert not dq[:, :8].any()
    # keys 12.. are seen by no row of positions -8 .. 11 (causal)
    assert not dk[:, 12:].any() and not dv[:, 12:].any()


def test_kernel_wrapper_stays_forward_only_and_refuses_mixed_dtypes():
    q, k, v, do = (torch.from_numpy(a) for a in make(1, 1, 8, 8, 4, 2, 16))
    with pytest.raises(RuntimeError, match="backward"):
        tfa.flash_attention(q.clone().requires_grad_(), k, v)
    o, lse = tfa.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd(q, k, v, o, do, lse[:, :, :4])
    assert tfa.flash_attention_bwd.launches == 0


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000), sq=st.integers(1, 40),
       sk=st.integers(1, 40), causal=st.booleans())
def test_flash_grad_property_shapes(seed, sq, sk, causal):
    """Any Sq and Sk, as ``test_flash_property_shapes`` draws them, with
    the mask on or off: the plain backward against ``jax.vjp``."""
    arrays = make(seed, 1, sq, sk, 2, 2, 8)
    want = jax_grads(arrays, "float32", causal, 0, 0, chunk=16)
    o, _, grads = port_plain(arrays, "float32", causal, 0, 0)
    for name, got, ref in zip(("o", "dq", "dk", "dv"), (o, *grads), want):
        check(got, ref, "float32", name)
