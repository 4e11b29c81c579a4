"""Port parity: flash attention (the sequence forward's kernel).

The same numpy inputs go through the JAX package's ``ops.flash_attention``
(its Pallas kernel in interpret mode on the CPU, as ``tests/test_kernels.py``
runs it), its oracle ``ref.flash_attention_ref``, and the port's kernel API,
which on CPU tensors runs the plain version (``models.flash.
attention_ref``).  Tolerances are the reference suite's: 2e-5 in float32
for the shape sweep and 3e-5 for the mask cases (the online softmax sums in
another order than the dense softmax), 2e-2 in bfloat16 (one rounding of
the output).  The bf16 tensor-core kernel adds one rounding, of p to bf16
before P·V; its arithmetic, written densely here, is held to the JAX kernel
at the same 2e-2.  The float32 kernel takes each product as three TF32
products (hi·hi + hi·lo + lo·hi of each operand split in two TF32 halves);
its arithmetic, transcribed tile by tile here, is held to the JAX kernel at
2e-5, and the same transcription with one TF32 product must miss 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
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
    assert tfa.flash_attention.launches_by_kernel == {tfa.WGMMA: 0,
                                                      tfa.TF32X3: 0}


def attention_p_bf16(q, k, v, *, causal=True, window=0, q_offset=0):
    """The bf16 tensor-core kernel's arithmetic, densely (test-only):
    float32 scores of the bf16 inputs, p = exp(s - m) with masked p 0, l
    the float32 sum of p, p rounded to bf16 before P·V, acc / max(l, 1e-30)
    rounded to bf16.  The kernel takes m as a running max over key tiles;
    p's relative rounding is the same either way."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * hd ** -0.5
    mask = tflash._mask(torch.arange(sq) + q_offset,
                        torch.arange(k.shape[1]), causal, window)
    s = torch.where(mask, s, tflash.NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1).permute(0, 3, 1, 2)[..., None]          # [b, q, kv, g, 1]
    o = torch.einsum("bkgqs,bskd->bqkgd", p.bfloat16().float(), v.float())
    return (o / l.clamp(min=1e-30)).reshape(b, sq, h, hd).bfloat16()


@pytest.mark.parametrize("window,q_offset", [(0, 0), (64, 0), (16, -40)])
def test_flash_p_rounded_to_bf16_matches_reference(window, q_offset):
    """granite-3-8b's heads (32/8 of 128) at S 256: p rounded to bf16
    before P·V stays within the bf16 limit of the JAX kernel (interpret
    mode) and of the port's plain version; q_offset -40 leaves 40 rows no
    key, which give zeros."""
    arrays = make(7, 1, 256, 256, 32, 8, 128)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = attention_p_bf16(*(torch.from_numpy(a).bfloat16() for a in arrays),
                           **kw).float()
    plain, jax_kernel, _ = run_both(arrays, "bfloat16", **kw)
    np.testing.assert_allclose(got.numpy(), jax_kernel, atol=TOL["bfloat16"])
    np.testing.assert_allclose(got.numpy(), plain, atol=TOL["bfloat16"])
    if q_offset < 0:
        assert not got[:, :-q_offset].any() and got[:, -q_offset:].any()


# bf16 head dim -> (padded head dim, keys a tile) of the tensor-core kernel.
WGMMA_TILES = {8: (64, 128), 64: (64, 128), 120: (128, 128),
               128: (128, 128), 192: (192, 64), 256: (256, 64)}
CONFIG_HEAD_DIMS = {jconfigs.get_config(a).head_dim
                    for a in jconfigs.lm_archs()}


@pytest.mark.parametrize("hd", sorted(CONFIG_HEAD_DIMS | set(WGMMA_TILES)))
def test_flash_variant_follows_the_dtype(hd):
    """The dtype alone picks the kernel: bf16 the wgmma kernel (hd padded
    to a multiple of 64, 128 keys a tile up to hd 128, else 64), float32
    the three-term TF32 kernel (hd padded likewise, 32 keys a tile up to hd
    192, else 16).  Every head size of the repo's configs is in the
    table."""
    hd_pad = WGMMA_TILES[hd][0]
    assert tfa.variant(torch.bfloat16, hd) == tfa.Variant(tfa.WGMMA,
                                                          *WGMMA_TILES[hd])
    assert tfa.variant(torch.float32, hd) == tfa.Variant(
        tfa.TF32X3, hd_pad, 32 if hd_pad <= 192 else 16)


def test_flash_variant_refuses_other_inputs():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.variant(torch.float16, 128)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfa.variant(torch.bfloat16, 12)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfa.variant(torch.bfloat16, 264)


def tf32(x):
    """float32 rounded to TF32 on the bit pattern as the kernel rounds it
    (``cvt.rna.tf32.f32``'s rule): to nearest, ties away from zero, 10
    mantissa bits kept (the low 13 of 23 cleared)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    """x = hi + lo: hi rounded to TF32; lo = x - hi (exact in float32) as
    the mma reads it, its low 13 bits dropped."""
    hi = tf32(x)
    return hi, ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)


def product(a, b, terms):
    """a @ b as the kernel's mma.sync takes it: three TF32 products, the
    small terms summed apart and added last, or (``terms`` 1) one."""
    (ah, al), (bh, bl) = split(a), split(b)
    if terms == 1:
        return ah @ bh
    return ah @ bh + (ah @ bl + al @ bh)


def attention_tf32x3(q, k, v, *, causal=True, window=0, q_offset=0,
                     terms=3, key_tile=32):
    """The float32 kernel's arithmetic (test-only): key tiles of 32 in
    order; S = Q Kᵀ as ``product`` takes it, summed over chunks of 32
    columns of hd in float32, scaled to log2 units; mask, running max m,
    p = 2^(s - m) with masked p 0; O += P V as ``product`` takes it, one
    sum a tile added to the rescaled O; l and O in float32, and
    acc / max(l, 1e-30) at the end."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]          # [b, kv, 1, hd, sk]
    vt = v.permute(0, 2, 1, 3)[:, :, None]          # [b, kv, 1, sk, hd]
    mask = tflash._mask(torch.arange(sq) + q_offset, torch.arange(sk),
                        causal, window)
    scale2 = torch.tensor(hd ** -0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    m = torch.full(qg.shape[:-1] + (1,), tflash.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for k0 in range(0, sk, key_tile):
        keys = slice(k0, k0 + key_tile)
        s = sum(product(qg[..., c:c + 32], kt[..., c:c + 32, keys], terms)
                for c in range(0, hd, 32))
        s = torch.where(mask[:, keys], s * scale2, tflash.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(mask[:, keys], torch.exp2(s - m_new), 0.0)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + product(p, vt[..., keys, :], terms)
        m = m_new
    o = acc / l.clamp(min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


# (seed, B, Sq, Sk, H, kv, hd, q scale, mask): the float32 cases above, then
# granite-3-8b's heads with q scaled up so that scores reach |s| 10-20.
TF32_CASES = [(0, *shape, 1.0, {}) for shape in SHAPES] + [
    (1, 1, 256, 256, 4, 2, 64, 1.0, dict(window=64)),
    (2, 1, 128, 384, 4, 4, 64, 1.0, dict(q_offset=256)),
    (3, 1, 100, 200, 4, 4, 64, 1.0, dict(causal=False)),
    (4, 1, 40, 40, 4, 2, 64, 1.0, dict(q_offset=-3)),
    (7, 1, 256, 256, 32, 8, 128, 4.0, {}),
]


@pytest.mark.parametrize("case", TF32_CASES)
def test_flash_tf32x3_matches_reference(case):
    """Three TF32 products hold the float32 limit (2e-5) against the JAX
    kernel (interpret mode) and the port's plain version; one TF32 product
    does not, so the limit sees the split's absence."""
    seed, b, sq, sk, h, kv, hd, q_scale, kw = case
    arrays = make(seed, b, sq, sk, h, kv, hd)
    arrays = (arrays[0] * np.float32(q_scale), *arrays[1:])
    kw = dict(dict(causal=True), **kw)
    plain, jax_kernel, _ = run_both(arrays, "float32", **kw)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = attention_tf32x3(q, k, v, **kw).numpy()
    one = attention_tf32x3(q, k, v, terms=1, **kw).numpy()
    np.testing.assert_allclose(got, jax_kernel, rtol=0, atol=TOL["float32"])
    np.testing.assert_allclose(got, plain, rtol=0, atol=TOL["float32"])
    assert np.abs(one - jax_kernel).max() > TOL["float32"]
    if kw.get("q_offset", 0) < 0:
        assert not got[:, :-kw["q_offset"]].any()
    if q_scale > 1:
        scores = torch.einsum("bqhd,bkhd->bhqk", q[:, :, :kv], k) * hd ** -0.5
        assert 10 <= float(scores.abs().max()) <= 20
