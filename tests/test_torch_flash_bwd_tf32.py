"""The float32 flash backward's arithmetic, held to the reference's VJP.

``csrc/flash_attention_bwd_tf32.cu`` (up to hd 128) and
``csrc/flash_attention_bwd_tf32_256.cu`` (hd 136 to 256) run only on the
card.  Their arithmetic is transcribed here in plain PyTorch
(:func:`bwd_tf32x3`): every product split into TF32 halves (hi rounded to
nearest with ties away from zero, lo = x - hi with its low 13 bits
dropped, as the mma reads it) and taken as hi·hi + (hi·lo + lo·hi); S and
dP summed by chunks of 32 columns of hd (above hd 128 the first half of
the chunks and the second summed apart, then added, as the two warps that
share a block's 16 keys or rows each take half and add their partials);
the dk/dv pass over blocks of ``res`` keys (128, or 64 above hd 128)
walking the group's query rows, flattened (position, head), in tiles of 16
from the first row that can see one of the block's keys, the dq pass over
blocks of ``res`` flattened rows walking key tiles of 16; each tile's share
of dk, dv and dq summed apart and added in float32, in that order; masked
probabilities selected to 0 before the exponential.  (Above hd 128 the two
warps of a pair also split the tile's product by columns; that changes no
sum.)  The same seeded numpy inputs go through ``jax.vjp`` of
``repro.models.flash.flash_attention`` (its custom VJP): the transcription
within 2e-4, and with hi alone (one TF32 product) it misses 2e-4 in every
case, so the limit tells the split from none.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash as jflash

from repro_torch.models import flash as tflash

TOL = 2e-4
LOG2E = 1.4426950408889634
TILE, CHUNK = 16, 32   # streamed tile, S chunk

# (B, Sq, Sk, H, kv, hd, causal, window, q_offset, q scale)
CASES = [
    (1, 96, 96, 4, 1, 64, True, 0, 0, 1.0),       # g 4, causal
    (1, 80, 120, 2, 2, 120, True, 0, 40, 1.0),    # g 1, hd 120, ragged
    (1, 64, 64, 4, 1, 64, True, 20, -24, 1.0),    # window; 24 rows see no key
    (1, 40, 40, 9, 1, 64, True, 0, 0, 1.0),       # g 9
    (1, 50, 90, 4, 4, 64, False, 0, 0, 1.0),      # g 1, bidirectional, ragged
    (1, 160, 160, 4, 1, 120, True, 0, 0, 4.0),    # q x 4: large scores
    # above hd 128 (the split-hd kernel: 64-key blocks)
    (1, 128, 128, 4, 2, 256, True, 0, 0, 1.0),    # gemma3-12b's g 2
    (1, 64, 64, 4, 2, 192, True, 20, -24, 1.0),   # window; 24 rows see no key
    (1, 80, 120, 2, 1, 136, True, 0, 40, 1.0),    # hd 136 (pad 192), ragged
    (1, 96, 96, 2, 1, 256, True, 0, 0, 4.0),      # q x 4: large scores
]


def layout(hd):
    """The kernel's resident block and whether S and dP are summed in two
    halves of the chunks: (128, False) up to hd 128, (64, True) above."""
    return (128, False) if hd <= 128 else (64, True)


@pytest.fixture(autouse=True)
def one_thread():
    """Small products in a loop: torch's intra-op threads only contend
    with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make(seed, b, sq, sk, h, kv, hd, q_scale):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(b, sq, h, hd)) * q_scale).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sq, h, hd)).astype(np.float32))


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _jax_vjp(q, k, v, do, causal, window, chunk, q_offset):
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jflash.flash_attention(q_, k_, v_, causal, window,
                                                  chunk, q_offset), q, k, v)
    return vjp(do)


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


def chunked(a, b, terms, halves):
    """a @ b^T over hd by chunks of 32 columns, each added in float32; with
    ``halves`` the first half of the chunks and the second apart, then the
    two sums.  hd is padded to a multiple of 64 first, as the kernels pad
    it (zero columns add exact zeros, but they count in the halves)."""
    pad = -a.shape[-1] % 64
    a, b = (torch.nn.functional.pad(x, (0, pad)) for x in (a, b))
    parts = [product(a[..., c:c + CHUNK], b[..., c:c + CHUNK].transpose(
        -1, -2), terms) for c in range(0, a.shape[-1], CHUNK)]
    if not halves:
        return sum(parts)
    return sum(parts[:len(parts) // 2]) + sum(parts[len(parts) // 2:])


def bwd_tf32x3(q, k, v, o, do, lse, *, causal, window, q_offset, res,
               halves, terms=3):
    """The float32 backward kernels' arithmetic in plain PyTorch:
    (dq, dk, dv) in float32, tiles, masks and sums as the kernel takes
    them: ``res`` resident keys (rows) a block; with ``halves`` S and dP
    summed in two halves of their chunks.  A tile the kernel skips for a
    warp, or items past the ends, would add exact zeros, so every visible
    item is taken here."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    rows = sq * g
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    scale2 = scale * torch.tensor(LOG2E, dtype=torch.float32)

    def flat(x):
        """[B, Sq, H, d] -> [B, kv, Sq g, d], row = position g + head."""
        return x.reshape(b, sq, kv, g, -1).permute(0, 2, 1, 3, 4).reshape(
            b, kv, rows, -1)

    qf, dof = flat(q), flat(do)
    delta = flat((o * do).sum(-1, keepdim=True))[..., 0]
    lse2 = flat(lse.permute(0, 2, 1)[..., None])[..., 0] * LOG2E
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    pos = torch.arange(rows) // g + q_offset

    def visible(r, keys):
        """[len(r), len(keys)]: row r sees the key."""
        see = torch.ones((len(r), len(keys)), dtype=torch.bool)
        if causal:
            see &= keys[None, :] <= pos[r][:, None]
        if window > 0:
            see &= pos[r][:, None] - keys[None, :] < window
        return see

    def p_ds(s, dp, r, see):
        """P and dS of a tile from S and dP (rows r on the second-to-last
        axis); a masked p is 0 before the exponential."""
        p = torch.exp2(torch.where(see, s * scale2 - lse2[..., r, None],
                                   float("-inf")))
        return p, p * (dp - delta[..., r, None]) * scale

    # dk / dv: blocks of res keys over tiles of 16 flattened rows.
    dk = torch.zeros(b, kv, sk, hd)
    dv = torch.zeros(b, kv, sk, hd)
    for k0 in range(0, sk, res):
        keys = torch.arange(k0, min(k0 + res, sk))
        p_lo = max(0, k0 - q_offset) if causal else 0
        p_end = min(sq, int(keys[-1]) + window - q_offset) if window else sq
        acc_k = torch.zeros(b, kv, len(keys), hd)
        acc_v = torch.zeros(b, kv, len(keys), hd)
        for j0 in range(p_lo * g, p_end * g, TILE):
            r = torch.arange(j0, min(j0 + TILE, rows))
            st = chunked(kt[:, :, keys], qf[:, :, r], terms, halves)
            dpt = chunked(vt[:, :, keys], dof[:, :, r], terms, halves)
            p, ds = p_ds(st.transpose(-1, -2), dpt.transpose(-1, -2), r,
                         visible(r, keys))
            acc_v += product(p.transpose(-1, -2), dof[:, :, r], terms)
            acc_k += product(ds.transpose(-1, -2), qf[:, :, r], terms)
        dk[:, :, keys] = acc_k
        dv[:, :, keys] = acc_v

    # dq: blocks of res flattened rows over key tiles of 16.
    dq = torch.zeros(b, kv, rows, hd)
    for r0 in range(0, rows, res):
        r = torch.arange(r0, min(r0 + res, rows))
        k_end = min(sk, int(r[-1]) // g + q_offset + 1) if causal else sk
        k_begin = max(0, r0 // g + q_offset - window + 1) if window else 0
        acc = torch.zeros(b, kv, len(r), hd)
        for j0 in range(k_begin, k_end, TILE):
            keys = torch.arange(j0, min(j0 + TILE, sk))
            s = chunked(qf[:, :, r], kt[:, :, keys], terms, halves)
            dp = chunked(dof[:, :, r], vt[:, :, keys], terms, halves)
            _, ds = p_ds(s, dp, r, visible(r, keys))
            acc += product(ds, kt[:, :, keys], terms)
        dq[:, :, r] = acc
    dq = dq.reshape(b, kv, sq, g, hd).permute(0, 2, 1, 3, 4).reshape(
        b, sq, h, hd)
    return dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_tf32x3_backward_matches_jax_vjp(case):
    """The transcription within 2e-4 of the reference's VJP, zero dq on
    rows that see no key; one TF32 product misses 2e-4."""
    b, sq, sk, h, kv, hd, causal, window, q_offset, q_scale = case
    arrays = make(sum(case[:6]), b, sq, sk, h, kv, hd, q_scale)
    want = [np.asarray(x, np.float32) for x in _jax_vjp(
        *(jnp.asarray(a) for a in arrays), causal, window, 16, q_offset)]
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = tflash.attention_lse_ref(q, k, v, **kw)
    res, halves = layout(hd)
    kw_k = dict(kw, res=res, halves=halves)
    got = bwd_tf32x3(q, k, v, o, do, lse, **kw_k)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        g_ = g_.numpy()
        assert np.isfinite(g_).all(), name
        err = np.abs(g_ - w_).max()
        assert err <= TOL, (name, err)
    dead = ~tflash._mask(torch.arange(sq) + q_offset, torch.arange(sk),
                         causal, window).any(1)
    assert not got[0][:, dead].any()
    if q_offset < 0:
        assert dead.any()
    one = bwd_tf32x3(q, k, v, o, do, lse, terms=1, **kw_k)
    assert max(np.abs(g_.numpy() - w_).max()
               for g_, w_ in zip(one, want)) > TOL

