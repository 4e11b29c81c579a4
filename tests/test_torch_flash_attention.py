"""Port parity: flash attention (the sequence forward's kernel).

The same numpy inputs go through the JAX package's ``ops.flash_attention``
(its Pallas kernel in interpret mode on the CPU, as ``tests/test_kernels.py``
runs it), its oracle ``ref.flash_attention_ref``, and the port's kernel API,
which on CPU tensors runs the plain version (``models.flash.
attention_ref``).  Tolerances are the reference suite's: 2e-5 in float32
for the shape sweep and 3e-5 for the mask cases (the online softmax sums in
another order than the dense softmax), 2e-2 in bfloat16 (one rounding of
the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import flash as tflash

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make(seed, b, sq, sk, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32))


def run_both(arrays, dtype, **kw):
    """-> (port, JAX kernel, JAX oracle) outputs as float32 numpy."""
    jx = [jnp.asarray(a, JDT[dtype]) for a in arrays]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    got = tops.flash_attention(*tx, **kw)
    assert got.dtype == TDT[dtype]
    kernel = jops.flash_attention(*jx, **kw)
    oracle = jref.flash_attention_ref(*jx, **kw)
    return (got.float().numpy(), np.asarray(kernel, np.float32),
            np.asarray(oracle, np.float32))


# tests/test_kernels.py's shapes, then hd 120 and 256 (Sk ragged too).
SHAPES = [
    (1, 128, 128, 4, 4, 64),       # MHA square
    (2, 128, 256, 8, 2, 64),       # GQA, longer K
    (1, 256, 128, 4, 1, 128),      # MQA, q longer than k
    (1, 72, 100, 4, 2, 120),       # hd 120, ragged tiles
    (1, 64, 96, 2, 1, 256),        # hd 256
]


@pytest.mark.parametrize("b,sq,sk,h,kv,hd", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_reference(b, sq, sk, h, kv, hd, dtype):
    got, kernel, oracle = run_both(make(0, b, sq, sk, h, kv, hd), dtype,
                                   causal=True)
    np.testing.assert_allclose(got, kernel, atol=TOL[dtype])
    np.testing.assert_allclose(got, oracle, atol=TOL[dtype])


@pytest.mark.parametrize("window", [0, 64, 100])
def test_flash_sliding_window(window):
    got, kernel, oracle = run_both(make(1, 1, 256, 256, 4, 2, 64), "float32",
                                   causal=True, window=window)
    np.testing.assert_allclose(got, kernel, atol=3e-5)
    np.testing.assert_allclose(got, oracle, atol=3e-5)


def test_flash_q_offset_decode_chunk():
    """Prefill continuation: the q block at absolute offset 256 of the KV."""
    got, kernel, oracle = run_both(make(2, 1, 128, 384, 4, 4, 64), "float32",
                                   causal=True, q_offset=256)
    np.testing.assert_allclose(got, kernel, atol=3e-5)
    np.testing.assert_allclose(got, oracle, atol=3e-5)


def test_flash_unaligned_not_causal():
    got, kernel, oracle = run_both(make(3, 1, 100, 200, 4, 4, 64), "float32",
                                   causal=False)
    np.testing.assert_allclose(got, kernel, atol=3e-5)
    np.testing.assert_allclose(got, oracle, atol=3e-5)


def test_flash_fully_masked_rows_give_zeros():
    """q_offset -3 under the causal mask: the first three query rows see no
    key at all, and the kernel's acc / max(l, 1e-30) gives zeros there."""
    got, kernel, oracle = run_both(make(4, 1, 40, 40, 4, 2, 64), "float32",
                                   causal=True, q_offset=-3)
    assert not got[:, :3].any()
    assert got[:, 3:].any()
    np.testing.assert_allclose(got, kernel, atol=3e-5)
    np.testing.assert_allclose(got, oracle, atol=3e-5)


def test_flash_ref_names_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in make(5, 1, 20, 30, 4, 2, 16))
    want = tflash.attention_ref(q, k, v, causal=True, window=8, q_offset=5)
    for got in (tref.flash_attention_ref(q, k, v, window=8, q_offset=5),
                tfa.flash_attention(q, k, v, window=8, q_offset=5)):
        assert torch.equal(got, want)


def test_flash_mask_matches_reference():
    from repro.models import flash as jflash
    q_pos, k_pos = np.arange(30) + 7, np.arange(41)
    for causal, window in [(True, 0), (True, 5), (False, 9), (False, 0)]:
        want = np.asarray(jflash._mask(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                       causal, window))
        got = tflash._mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                           causal, window)
        assert np.array_equal(got.numpy(), want)


def test_flash_raises_on_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in make(6, 1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple of 8"):
        tfa.flash_attention(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError, match="do not match"):
        tfa.flash_attention(q, k[:, :, :1], v)
    with pytest.raises(RuntimeError, match="backward"):
        tfa.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).shape == q.shape
    assert tfa.flash_attention.launches == 0


def test_flash_never_falls_back_off_the_cpu():
    meta = torch.empty((1, 8, 4, 16), device="meta")
    kv = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(meta, kv, kv)
    with pytest.raises(ValueError, match="one device"):
        tfa.flash_attention(torch.zeros((1, 8, 4, 16)), kv, kv)
    assert tfa.flash_attention.launches == 0
