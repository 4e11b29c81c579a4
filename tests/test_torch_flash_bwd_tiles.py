"""The bf16 flash backward's decomposition, held to the reference's VJP.

``csrc/flash_attention_bwd_wgmma.cu`` runs only on the card.  Its tiling is
transcribed here in plain PyTorch (:func:`bwd_by_tiles`): a kv head's query
rows flattened position-major into tiles of 64 rows (``bwd_tiles``), the
row statistics (lse log2e, delta; +inf and 0 on padding rows and rows past
Sq) as ``flash_bwd_wgmma_delta`` writes them, the dk/dv pass over blocks of
128 keys (two halves of 64, one a consumer warpgroup) walking the row tiles
that see one of their keys, and the dq pass over pairs of row tiles walking
key tiles of 128; tiles wholly outside the mask skipped, only tiles that
straddle an edge masked (each key by its range of rows, each row by its
range of keys), p and ds rounded to the inputs' dtype where the kernels
round them, float32 sums tile by tile.  The same seeded numpy inputs go
through ``jax.vjp`` of ``repro.models.flash.flash_attention`` (its custom
VJP): bf16 within 2e-2 of the largest gradient, float32 within 2e-4.  The
``(dtype, hd) -> kernel`` table and the row tiling are checked as well.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash as jflash

from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import flash as tflash

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # bf16: of the largest gradient
LOG2E = 1.4426950408889634
TILE, KEY_BLOCK, KEY_TILE = 64, 128, 128

# (B, Sq, Sk, H, kv, hd, causal, window, q_offset)
CASES = [
    (1, 150, 150, 4, 1, 64, True, 0, 0),       # g 4, causal
    (1, 96, 200, 2, 2, 120, True, 0, 100),     # g 1, hd 120, ragged
    (1, 100, 100, 4, 1, 64, True, 24, -30),    # window; first rows see no key
    (1, 70, 130, 8, 2, 120, True, 40, 50),     # g 4, hd 120, window
    (1, 90, 90, 6, 2, 64, True, 0, 0),         # g 3: a padding row a tile
    (1, 60, 140, 4, 4, 64, False, 0, 0),       # g 1, bidirectional, ragged
]


@pytest.fixture(autouse=True)
def one_thread():
    """Small products in a loop: torch's intra-op threads only contend
    with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make(seed, b, sq, sk, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sq, h, hd)).astype(np.float32))


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _jax_vjp(q, k, v, do, causal, window, chunk, q_offset):
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jflash.flash_attention(q_, k_, v_, causal, window,
                                                  chunk, q_offset), q, k, v)
    return vjp(do)


def bwd_by_tiles(q, k, v, o, do, lse, *, causal, window, q_offset):
    """The wgmma backward's decomposition in plain PyTorch: (dq, dk, dv) in
    q's dtype (the kernels' tiles, masks and roundings; the order of float32
    sums within a tile is the tensor cores' own)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    plan = tfa.bwd_tiles(h, kv, sq)
    hb, pos_per, tiles, nhc = plan.hb, plan.pos_per, plan.tiles, plan.nhc
    scale = hd ** -0.5
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    delta = (o.float() * dof).sum(-1)                       # [B, Sq, H]

    def rnd(x):
        return x.to(q.dtype).float()

    r = torch.arange(TILE)

    def tile(bi, kh, hc, t):
        """A row tile's Q and dO rows (zeros on padding rows and past Sq),
        its rows' (position, head), which are real, lse log2e and delta,
        as flash_bwd_wgmma_delta writes them."""
        pos = t * pos_per + r // hb
        head = kh * g + hc * hb + r % hb
        real = (r < pos_per * hb) & (pos < sq)
        p_, h_ = pos.clamp(max=sq - 1), head
        qt = torch.where(real[:, None], qf[bi, p_, h_], 0.0)
        dot = torch.where(real[:, None], dof[bi, p_, h_], 0.0)
        lse2 = torch.where(real, lse[bi, h_, p_] * LOG2E, float("inf"))
        dlt = torch.where(real, delta[bi, p_, h_], 0.0)
        return qt, dot, lse2, dlt, pos, head, real

    def keys(x, bi, kh, k_first, n):
        rows = torch.arange(k_first, k_first + n)
        return torch.where((rows < sk)[:, None],
                           x[bi, rows.clamp(max=sk - 1), kh], 0.0)

    # dk / dv: blocks of 128 keys, 64 a consumer warpgroup, over the row
    # tiles that see one of the block's keys, head blocks outer.
    dk = torch.zeros(b, sk, kv, hd)
    dv = torch.zeros(b, sk, kv, hd)
    for bi in range(b):
        for kh in range(kv):
            for k0 in range(0, sk, KEY_BLOCK):
                k_last = min(k0 + KEY_BLOCK, sk) - 1
                pos_lo = max(0, k0 - q_offset) if causal else 0
                pos_hi = (min(sq, k_last + window - q_offset) if window > 0
                          else sq)
                t_lo, nt = 0, 0
                if pos_hi > pos_lo:
                    t_lo = pos_lo // pos_per
                    nt = -(-pos_hi // pos_per) - t_lo
                for kw in (k0, k0 + 64):
                    if kw >= sk:
                        continue
                    kt_, vt_ = keys(kf, bi, kh, kw, 64), keys(vf, bi, kh, kw,
                                                              64)
                    kpos = torch.arange(kw, kw + 64)
                    acc_k = torch.zeros(64, hd)
                    acc_v = torch.zeros(64, hd)
                    for hc in range(nhc):
                        for t in range(t_lo, t_lo + nt):
                            p0 = t * pos_per
                            qa = p0 + q_offset
                            qb = min(p0 + pos_per, sq) - 1 + q_offset
                            if ((causal and kw > qb) or (
                                    window > 0
                                    and qa - min(kw + 63, sk - 1) >= window)):
                                continue
                            masked = (kw + 64 > sk or (causal and kw + 63 > qa)
                                      or (window > 0 and qb - kw >= window))
                            qt, dot, lse2, dlt, *_ = tile(bi, kh, hc, t)
                            st = kt_ @ qt.T                 # S^T [keys, rows]
                            p = torch.exp2(st * (scale * LOG2E)
                                           - lse2[None, :])
                            if masked:
                                lo = ((kpos - qa) if causal
                                      else torch.zeros_like(kpos))
                                hi = ((kpos - qa + window) if window > 0
                                      else torch.full_like(kpos, pos_per))
                                clo = lo.clamp(0, pos_per) * hb
                                chi = torch.where(kpos < sk,
                                                  hi.clamp(0, pos_per) * hb, 0)
                                see = ((r[None, :] >= clo[:, None])
                                       & (r[None, :] < chi[:, None]))
                                p = torch.where(see, p, 0.0)
                            dpt = vt_ @ dot.T
                            acc_v += rnd(p) @ dot
                            acc_k += rnd(p * (dpt - dlt[None, :]) * scale) @ qt
                    n = min(64, sk - kw)
                    dk[bi, kw:kw + n, kh] = acc_k[:n]
                    dv[bi, kw:kw + n, kh] = acc_v[:n]

    # dq: pairs of row tiles, one a consumer warpgroup, over key tiles of
    # 128 from the first key a row of the pair sees.
    dq = torch.zeros(b, sq, h, hd)
    for bi in range(b):
        for kh in range(kv):
            for hc in range(nhc):
                for pair in range(-(-tiles // 2)):
                    pa = 2 * pair * pos_per
                    pb = min(pa + 2 * pos_per, sq) - 1
                    k_end = min(sk, pb + q_offset + 1) if causal else sk
                    k_begin = (max(0, pa + q_offset - window + 1)
                               if window > 0 else 0)
                    n_tiles = (-(-(k_end - k_begin) // KEY_TILE)
                               if k_end > k_begin else 0)
                    for t in (2 * pair, 2 * pair + 1):
                        p0 = t * pos_per
                        if p0 >= sq:
                            continue
                        qa = p0 + q_offset
                        qb = min(p0 + pos_per, sq) - 1 + q_offset
                        qt, dot, lse2, dlt, pos, head, real = tile(bi, kh, hc,
                                                                   t)
                        qpos = pos + q_offset
                        hi = qpos + 1 if causal else torch.full_like(qpos, sk)
                        hi = hi.clamp(max=sk)
                        lo = (qpos - window + 1 if window > 0
                              else torch.zeros_like(qpos))
                        acc = torch.zeros(TILE, hd)
                        for j in range(n_tiles):
                            kt = k_begin + j * KEY_TILE
                            last = kt + KEY_TILE - 1
                            if ((causal and kt > qb) or (
                                    window > 0
                                    and qa - min(last, sk - 1) >= window)):
                                continue
                            masked = (last >= sk or (causal and last > qa)
                                      or (window > 0 and qb - kt >= window))
                            kt_, vt_ = (keys(kf, bi, kh, kt, KEY_TILE),
                                        keys(vf, bi, kh, kt, KEY_TILE))
                            s = qt @ kt_.T
                            p = torch.exp2(s * (scale * LOG2E)
                                           - lse2[:, None])
                            if masked:
                                key = torch.arange(kt, kt + KEY_TILE)
                                see = ((key[None, :] >= lo[:, None])
                                       & (key[None, :] < hi[:, None]))
                                p = torch.where(see, p, 0.0)
                            dp = dot @ vt_.T
                            acc += rnd(p * (dp - dlt[:, None]) * scale) @ kt_
                        dq[bi, pos[real], head[real]] = acc[real]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def port_inputs(arrays, dtype, causal, window, q_offset):
    q, k, v, do = (torch.from_numpy(a).to(TDT[dtype]) for a in arrays)
    o, lse = tflash.attention_lse_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
    return q, k, v, o, do, lse


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_tiled_backward_matches_jax_vjp(case, dtype):
    b, sq, sk, h, kv, hd, causal, window, q_offset = case
    arrays = make(sum(case[:6]), b, sq, sk, h, kv, hd)
    want = [np.asarray(x, np.float32) for x in _jax_vjp(
        *(jnp.asarray(a, JDT[dtype]) for a in arrays), causal, window, 16,
        q_offset)]
    q, k, v, o, do, lse = port_inputs(arrays, dtype, causal, window,
                                      q_offset)
    got = bwd_by_tiles(q, k, v, o, do, lse, causal=causal, window=window,
                       q_offset=q_offset)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == TDT[dtype], name
        g_ = g_.float().numpy()
        assert np.isfinite(g_).all(), name
        err = np.abs(g_ - w_).max()
        limit = TOL[dtype] * (np.abs(w_).max() if dtype == "bfloat16" else 1)
        assert err <= limit, (name, err, limit)
    dead = ~tflash._mask(torch.arange(sq) + q_offset, torch.arange(sk),
                         causal, window).any(1)
    assert not got[0][:, dead].any()
    if q_offset < 0:
        assert dead.any()


def test_tiling_differs_from_plain_only_in_sum_order():
    """On the same bf16 inputs the transcript and the plain version
    (``flash_bwd_ref``, all keys at once) round p and ds at the same places:
    they differ by float32 sum order and bf16 ties only."""
    case = CASES[3]
    b, sq, sk, h, kv, hd, causal, window, q_offset = case
    q, k, v, o, do, lse = port_inputs(make(5, b, sq, sk, h, kv, hd),
                                      "bfloat16", causal, window, q_offset)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = bwd_by_tiles(q, k, v, o, do, lse, **kw)
    want = tflash.flash_bwd_ref(q, k, v, o, do, lse, **kw)
    for g_, w_ in zip(got, want):
        top = float(w_.float().abs().max())
        assert float((g_.float() - w_.float()).abs().max()) <= 1e-2 * top


@pytest.mark.parametrize("hd", range(8, 257, 8))
def test_backward_kernel_table(hd):
    """bf16 up to hd 128 takes the wgmma backward and float32 up to hd 128
    the TF32 one, hd padded to 64 or 128, 128 keys a dk/dv block; beyond,
    bf16 takes the split-hd wgmma backward and float32 the split-hd TF32
    one, hd padded to 192 or 256, 64 keys a dk/dv block; the forward's
    table is its own."""
    wg = tfa.bwd_variant(torch.bfloat16, hd)
    f32 = tfa.bwd_variant(torch.float32, hd)
    pad = -(-hd // 64) * 64
    if hd <= 128:
        assert wg == tfa.Variant(tfa.BWD_WGMMA, pad, 128)
        assert f32 == tfa.Variant(tfa.BWD_TF32X3, pad, 128)
    else:
        assert wg == tfa.Variant(tfa.BWD_WGMMA256, pad, 64)
        assert f32 == tfa.Variant(tfa.BWD_TF32X3_256, pad, 64)
    kernels = {tfa.BWD_WGMMA, tfa.BWD_WGMMA256, tfa.BWD_TF32X3,
               tfa.BWD_TF32X3_256}
    assert set(tfa.BWD_KERNELS) == kernels
    assert tfa.flash_attention_bwd.launches_by_kernel.keys() == kernels
    assert not hasattr(tfa, "BWD")


def test_float32_above_hd_128_takes_the_split_hd_tf32_kernel():
    """Every float32 head dim from 136 to 256, gemma3-12b's 256 among them,
    takes ``BWD_TF32X3_256`` (its own source and C entry point), as bf16 at
    the same head dims takes ``BWD_WGMMA256``; no table entry names the
    CUDA cores' backward, whose source is gone."""
    for hd in range(136, 257, 8):
        assert tfa.bwd_variant(torch.float32, hd).kernel == tfa.BWD_TF32X3_256
        assert tfa.bwd_variant(torch.bfloat16, hd).kernel == tfa.BWD_WGMMA256
    assert tfa.bwd_variant(torch.float32, 128).kernel == tfa.BWD_TF32X3
    assert tfa._SOURCE[tfa.BWD_TF32X3_256] == "flash_attention_bwd_tf32_256"
    assert tfa._ENTRY[tfa.BWD_TF32X3_256] == (
        "repro_flash_attention_bwd_tf32_256", "21qdq")
    sources = set(tfa._build.sources())
    assert set(tfa._SOURCE.values()) <= sources
    assert "flash_attention_bwd" not in sources


def test_backward_kernel_table_refuses():
    for hd in (0, 4, 12, 264):
        with pytest.raises(ValueError, match="head_dim"):
            tfa.bwd_variant(torch.bfloat16, hd)
    with pytest.raises(ValueError, match="float32"):
        tfa.bwd_variant(torch.float16, 64)


@pytest.mark.parametrize("h,kv", [(32, 8), (8, 8), (36, 4), (6, 2), (16, 2),
                                  (128, 1), (96, 1), (130, 1)])
@pytest.mark.parametrize("sq", [1, 63, 64, 1000])
def test_row_tiles_cover_every_row_once(h, kv, sq):
    """hb is the largest divisor of g up to 64; the tiles of every head
    block cover each (position, head) of the kv head once; the statistics
    scratch holds 64 pairs a tile."""
    g = h // kv
    plan = tfa.bwd_tiles(h, kv, sq)
    assert g % plan.hb == 0 and plan.hb <= 64 and plan.nhc == g // plan.hb
    assert not any(g % d == 0 for d in range(plan.hb + 1, min(g, 64) + 1))
    assert plan.pos_per == 64 // plan.hb
    seen = np.zeros((sq, g), int)
    r = np.arange(64)
    for hc in range(plan.nhc):
        for t in range(plan.tiles):
            pos = t * plan.pos_per + r // plan.hb
            head = hc * plan.hb + r % plan.hb
            real = (r < plan.pos_per * plan.hb) & (pos < sq)
            np.add.at(seen, (pos[real], head[real]), 1)
    assert (seen == 1).all()
    assert plan.stats_numel(2, kv) == 2 * kv * plan.nhc * plan.tiles * 128
