"""The bf16 flash backward above hd 128, its decomposition held to the
reference's VJP.

``csrc/flash_attention_bwd_wgmma256.cu`` runs only on the card.  Its tiling
is transcribed here in plain PyTorch (:func:`bwd_by_tiles`): hd padded with
zeros to 192 or 256; a kv head's query rows flattened position-major into
tiles of 64 rows (``bwd_tiles``), the row statistics (lse log2e, delta;
+inf and 0 on padding rows and rows past Sq) as
``flash_bwd_wgmma256_delta`` writes them; the dk/dv pass over blocks of 64
keys walking the row tiles that see one of their keys, its two consumer
warpgroups each computing the whole S^T and dP^T and keeping dK and dV of
its own 64-column blocks of the head dim (128 / 128 columns at hd 256,
128 / 64 at hd 192); the dq pass over pairs of row tiles walking key tiles
of 32; tiles wholly outside the mask skipped, only tiles that straddle an
edge masked (each key by its range of rows, each row by its range of keys),
p and ds rounded to bf16 where the kernels round them, float32 sums tile by
tile.  The same seeded numpy inputs go through ``jax.vjp`` of
``repro.models.flash.flash_attention`` (its custom VJP): within 2e-2 of the
largest gradient.
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

TOL = 2e-2          # of the largest gradient
LOG2E = 1.4426950408889634
TILE, KEY_BLOCK, KEY_TILE = 64, 64, 32

# (B, Sq, Sk, H, kv, hd, causal, window, q_offset)
CASES = [
    (1, 70, 70, 4, 2, 256, True, 0, 0),        # g 2, gemma3-12b's heads
    (1, 40, 90, 2, 2, 136, True, 0, 50),       # g 1, hd 136, ragged
    (1, 50, 50, 9, 1, 192, True, 16, -20),     # g 9, window; rows see no key
    (1, 60, 40, 4, 2, 192, False, 0, 0),       # bidirectional, Sk < a block
    (1, 80, 100, 2, 1, 256, True, 30, 10),     # window and q_offset
    (1, 30, 30, 9, 1, 136, True, 0, -10),      # g 9, hd 136, dead rows
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


def column_blocks(hd_pad):
    """The 64-column blocks of the head dim that each dk/dv warpgroup owns,
    as column ranges: warpgroup 0 the first ceil(blocks / 2)."""
    c0 = (hd_pad // 64 + 1) // 2
    return (0, 64 * c0), (64 * c0, hd_pad)


def bwd_by_tiles(q, k, v, o, do, lse, *, causal, window, q_offset):
    """The split-hd wgmma backward's decomposition in plain PyTorch:
    (dq, dk, dv) in bf16 (the kernels' tiles, masks and roundings; the
    order of float32 sums within a tile is the tensor cores' own)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    plan = tfa.bwd_variant(q.dtype, hd)
    assert plan.kernel == tfa.BWD_WGMMA256 and plan.key_tile == KEY_BLOCK
    hd_pad = plan.hd_pad
    rows = tfa.bwd_tiles(h, kv, sq)
    hb, pos_per, tiles, nhc = rows.hb, rows.pos_per, rows.tiles, rows.nhc
    scale = hd ** -0.5

    def pad(x):
        """x in float32, hd padded with zeros as the TMA boxes fill it."""
        return torch.nn.functional.pad(x.float(), (0, hd_pad - hd))

    qf, kf, vf, dof = (pad(x) for x in (q, k, v, do))
    delta = (o.float() * do.float()).sum(-1)                # [B, Sq, H]

    def rnd(x):
        return x.to(torch.bfloat16).float()

    r = torch.arange(TILE)

    def tile(bi, kh, hc, t):
        """A row tile's Q and dO rows (zeros on padding rows and past Sq),
        its rows' (position, head), which are real, lse log2e and delta,
        as flash_bwd_wgmma256_delta writes them."""
        pos = t * pos_per + r // hb
        head = kh * g + hc * hb + r % hb
        real = (r < pos_per * hb) & (pos < sq)
        p_ = pos.clamp(max=sq - 1)
        qt = torch.where(real[:, None], qf[bi, p_, head], 0.0)
        dot = torch.where(real[:, None], dof[bi, p_, head], 0.0)
        lse2 = torch.where(real, lse[bi, head, p_] * LOG2E, float("inf"))
        dlt = torch.where(real, delta[bi, p_, head], 0.0)
        return qt, dot, lse2, dlt, pos, head, real

    def keys(x, bi, kh, k_first, n):
        at = torch.arange(k_first, k_first + n)
        return torch.where((at < sk)[:, None],
                           x[bi, at.clamp(max=sk - 1), kh], 0.0)

    # dk / dv: blocks of 64 keys over the row tiles that see one of the
    # block's keys, head blocks outer; each warpgroup computes S^T and dP^T
    # whole and sums dK and dV over its own columns.
    dk = torch.zeros(b, sk, kv, hd_pad)
    dv = torch.zeros(b, sk, kv, hd_pad)
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
                kt_ = keys(kf, bi, kh, k0, KEY_BLOCK)
                vt_ = keys(vf, bi, kh, k0, KEY_BLOCK)
                kpos = torch.arange(k0, k0 + KEY_BLOCK)
                for c_lo, c_hi in column_blocks(hd_pad):
                    acc_k = torch.zeros(KEY_BLOCK, c_hi - c_lo)
                    acc_v = torch.zeros(KEY_BLOCK, c_hi - c_lo)
                    for hc in range(nhc):
                        for t in range(t_lo, t_lo + nt):
                            p0 = t * pos_per
                            qa = p0 + q_offset
                            qb = min(p0 + pos_per, sq) - 1 + q_offset
                            if ((causal and k0 > qb) or (
                                    window > 0
                                    and qa - min(k0 + 63, sk - 1) >= window)):
                                continue
                            masked = (k0 + 64 > sk or (causal and k0 + 63 > qa)
                                      or (window > 0 and qb - k0 >= window))
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
                            acc_v += rnd(p) @ dot[:, c_lo:c_hi]
                            acc_k += (rnd(p * (dpt - dlt[None, :]) * scale)
                                      @ qt[:, c_lo:c_hi])
                    n = min(KEY_BLOCK, sk - k0)
                    dk[bi, k0:k0 + n, kh, c_lo:c_hi] = acc_k[:n]
                    dv[bi, k0:k0 + n, kh, c_lo:c_hi] = acc_v[:n]

    # dq: pairs of row tiles, one a consumer warpgroup, over key tiles of 32
    # from the first key a row of the pair sees.
    dq = torch.zeros(b, sq, h, hd_pad)
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
                        acc = torch.zeros(TILE, hd_pad)
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
    return tuple(x[..., :hd].to(torch.bfloat16) for x in (dq, dk, dv))


def port_inputs(arrays, causal, window, q_offset):
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    o, lse = tflash.attention_lse_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
    return q, k, v, o, do, lse


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_hd_backward_matches_jax_vjp(case):
    b, sq, sk, h, kv, hd, causal, window, q_offset = case
    arrays = make(sum(case[:6]), b, sq, sk, h, kv, hd)
    want = [np.asarray(x, np.float32) for x in _jax_vjp(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays), causal, window, 16,
        q_offset)]
    q, k, v, o, do, lse = port_inputs(arrays, causal, window, q_offset)
    got = bwd_by_tiles(q, k, v, o, do, lse, causal=causal, window=window,
                       q_offset=q_offset)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == torch.bfloat16, name
        g_ = g_.float().numpy()
        assert np.isfinite(g_).all(), name
        err = np.abs(g_ - w_).max()
        limit = TOL * np.abs(w_).max()
        assert err <= limit, (name, err, limit)
    dead = ~tflash._mask(torch.arange(sq) + q_offset, torch.arange(sk),
                         causal, window).any(1)
    assert not got[0][:, dead].any()
    if q_offset < 0:
        assert dead.any()


def test_split_hd_differs_from_plain_only_in_sum_order():
    """On the same bf16 inputs the transcript and the plain version
    (``flash_bwd_ref``, all keys at once, the head dim whole) round p and
    ds at the same places: they differ by float32 sum order and bf16 ties
    only."""
    b, sq, sk, h, kv, hd, causal, window, q_offset = CASES[4]
    q, k, v, o, do, lse = port_inputs(make(5, b, sq, sk, h, kv, hd), causal,
                                      window, q_offset)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = bwd_by_tiles(q, k, v, o, do, lse, **kw)
    want = tflash.flash_bwd_ref(q, k, v, o, do, lse, **kw)
    for g_, w_ in zip(got, want):
        top = float(w_.float().abs().max())
        assert float((g_.float() - w_.float()).abs().max()) <= 1e-2 * top


@pytest.mark.parametrize("hd,pad,split", [(136, 192, (128, 64)),
                                          (192, 192, (128, 64)),
                                          (200, 256, (128, 128)),
                                          (256, 256, (128, 128))])
def test_head_dim_padding_and_split(hd, pad, split):
    """hd pads to three or four 64-column blocks, split between the dk/dv
    warpgroups on a block boundary (a B operand under the transpose bit
    starts on a 64-column swizzle atom)."""
    plan = tfa.bwd_variant(torch.bfloat16, hd)
    assert plan == tfa.Variant(tfa.BWD_WGMMA256, pad, KEY_BLOCK)
    cols = column_blocks(plan.hd_pad)
    assert tuple(hi - lo for lo, hi in cols) == split
    assert cols[0][1] == cols[1][0] and cols[1][1] == pad
