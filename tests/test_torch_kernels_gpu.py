"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA device and ``nvcc`` (the kernels build at first launch);
without a card they skip.  Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels import bridge_attention as ba
from repro_torch.kernels import bridge_gather as bg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import stream as st
from repro_torch.models import flash as tflash
from repro_torch.models.flash import attention_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _pool(gen, rows, dtype, device, page=(16, 8, 128)):
    return torch.randn((rows,) + page, generator=gen, device=device).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,page", [(torch.bfloat16, (16, 8, 128)),
                                        (torch.float32, (8, 2, 32)),
                                        (torch.bfloat16, (8,))])
def test_gather_kernel_matches_plain(cuda, dtype, page):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    pool = _pool(gen, 64, dtype, cuda, page)
    reqs = torch.tensor([3, -1, 63, 0, 3, -1, 17, 40, 64], dtype=torch.int32,
                        device=cuda)
    before = bg.gather_pages.launches
    got = bg.gather_pages(pool, reqs)
    want = bg.gather_pages_plain(pool.view(64, -1), reqs).view_as(got)
    assert bg.gather_pages.launches == before + 1
    assert torch.equal(got, want)


# Rows the gather's 4 KiB chunks make hard: one 16-byte vector, rows that
# end inside a chunk (33,280 and 144 bytes), and the main path's 32 KiB.
GATHER_PAGES = [(torch.bfloat16, (8,)), (torch.float32, (4,)),
                (torch.bfloat16, (16, 8, 130)), (torch.float32, (3, 12)),
                (torch.bfloat16, (16, 8, 128))]


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 8, 512])
@pytest.mark.parametrize("dtype,page", GATHER_PAGES)
def test_gather_kernel_chunks_match_plain(cuda, w, dtype, page):
    """W = 1, the 1-node round's 8 lanes and the 8-node send buffer's 512
    (mostly FREE); ids past the pool read its last row."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(12)
    rows = 40
    pool = _pool(gen, rows, dtype, cuda, page)
    reqs = torch.randint(0, rows + 8, (w,), generator=gen, device=cuda,
                         dtype=torch.int32)
    free = torch.rand((w,), generator=gen, device=cuda) < (0.85 if w > 8
                                                           else 0.25)
    reqs = torch.where(free, -1, reqs)
    if w == 1:
        reqs.fill_(rows + 3)
    else:
        reqs[:2] = torch.tensor([-1, rows + 1], device=cuda)
    before = bg.gather_pages.launches
    got = bg.gather_pages(pool, reqs)
    want = bg.gather_pages_plain(pool.view(rows, -1), reqs).view_as(got)
    assert bg.gather_pages.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_gather_kernel_replays_in_a_cuda_graph(cuda):
    """Ten gathers of the 1-node round (W = 8) and ten of the 8-node send
    buffer (W = 512) recorded in one CUDA graph, replayed after the pool
    changed, give what the plain version gives on the new pool."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(13)
    rows, calls = 64, 10
    pool = _pool(gen, rows, torch.bfloat16, cuda)
    reqs = [torch.randint(-1, rows + 2, (w,), generator=gen, device=cuda,
                          dtype=torch.int32)
            for w in (8, 512) for _ in range(calls)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up: build, load, bind
        bg.gather_pages(pool, reqs[0])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [bg.gather_pages(pool, r) for r in reqs]
    pool.copy_(_pool(gen, rows, torch.bfloat16, cuda))
    graph.replay()
    torch.cuda.synchronize()
    for r, got in zip(reqs, outs):
        want = bg.gather_pages_plain(pool.view(rows, -1), r).view_as(got)
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scatter_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    pool = _pool(gen, 64, dtype, cuda)
    slots = torch.tensor([5, 9, -1, 5, 63, 9, 70, 0], dtype=torch.int32,
                         device=cuda)
    data = _pool(gen, 8, dtype, cuda)
    got = bg.scatter_pages(pool.clone(), slots, data)
    want = pool.clone()
    bg.scatter_pages_plain(want.view(64, -1), slots, data.view(8, -1))
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,h,kv,hd,t", [
    (torch.bfloat16, 8, 32, 8, 128, 16),
    (torch.float32, 4, 4, 2, 32, 8),
    (torch.float32, 2, 8, 1, 64, 40),
])
def test_stream_kernel_matches_plain(cuda, dtype, b, h, kv, hd, t):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    w = 8
    q = torch.randn((b, h, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((w, t, kv, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((w, t, kv, hd), generator=gen, device=cuda).to(dtype)
    seq = torch.randint(-1, b, (w,), generator=gen, device=cuda,
                        dtype=torch.int32)
    live = (seq >= 0).to(torch.int32)
    m = torch.randn((b, h), generator=gen, device=cuda)
    l = torch.rand((b, h), generator=gen, device=cuda) + 0.5
    o = torch.randn((b, h, hd), generator=gen, device=cuda)
    got = ba.stream_decode_accumulate(q, k, v, seq, live, m, l, o)
    want = ba.stream_decode_accumulate_plain(q, k, v, seq, live, m, l, o)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,lanes,page", [
    (torch.bfloat16, 8, 8, (16, 8, 128)),
    (torch.float32, 3, 5, (8, 2, 32)),
])
def test_pull_commit_kernel_matches_plain(cuda, dtype, n, lanes, page):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    ppn = 16
    pool = _pool(gen, n * ppn, dtype, cuda, page)
    send = _pool(gen, n * n * lanes, dtype, cuda, page).view(
        (n, n, lanes) + page)
    choice = torch.randint(-1, n + 1, (n, lanes), generator=gen, device=cuda,
                           dtype=torch.int32)
    loop = torch.randint(-1, ppn + 2, (n, lanes), generator=gen, device=cuda,
                         dtype=torch.int32)
    before = bg.pull_commit.launches
    got = bg.pull_commit(pool, send, choice, loop)
    want = bg.pull_commit_plain(pool.view(n * ppn, -1),
                                send.view(n, n, lanes, -1), choice, loop)
    assert bg.pull_commit.launches == before + 1
    assert torch.equal(got.view_as(want), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,channels", [(torch.bfloat16, 1),
                                            (torch.bfloat16, 2),
                                            (torch.float32, 4)])
def test_push_commit_kernel_matches_plain(cuda, dtype, channels):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    n, ppn, budget, d_rows = 8, 6, 8, 10
    cb = -(-budget // channels)
    lanes = channels * cb
    pool = _pool(gen, n * ppn, dtype, cuda)
    # FREE lanes, slots past the node's pool and many duplicates
    slots = torch.randint(-1, ppn + 1, (n, n, lanes), generator=gen,
                          device=cuda, dtype=torch.int32)
    data = _pool(gen, n * d_rows, dtype, cuda).view(
        (n, d_rows) + pool.shape[1:])
    base = torch.randint(0, d_rows, (n,), generator=gen, device=cuda,
                         dtype=torch.int32)
    got = bg.push_commit(pool.clone(), slots, data, base, channels=channels,
                         cb=cb)
    want = pool.clone()
    bg.push_commit_plain(want.view(n * ppn, -1), slots,
                         data.view(n, d_rows, -1), base, channels, cb)
    assert torch.equal(got, want)


# Page rows of the main path (32 KiB) and rows that are 16-byte multiples
# but not 128-byte ones (112 and 144 bytes).
WRITE_PAGES = [(torch.bfloat16, (16, 8, 128)), (torch.bfloat16, (7, 8)),
               (torch.float32, (3, 12))]


def _wide_slots(gen, w, rows, device):
    """W lanes over a pool of ``rows``: about a fifth FREE, a tenth past
    the pool, and many live duplicates (W > rows)."""
    return torch.randint(-(rows // 4), rows + rows // 8, (w,), generator=gen,
                         device=device, dtype=torch.int32).clamp(min=-1)


@pytest.mark.gpu
@pytest.mark.parametrize("w,rows", [(64, 40), (1024, 512)])
@pytest.mark.parametrize("dtype,page", WRITE_PAGES)
def test_scatter_kernel_wide_rounds_match_plain(cuda, w, rows, dtype, page):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    pool = _pool(gen, rows, dtype, cuda, page)
    slots = _wide_slots(gen, w, rows, cuda)
    assert (slots < 0).any() and (slots >= rows).any()
    live = slots[(slots >= 0) & (slots < rows)]
    assert live.unique().numel() < live.numel()
    data = _pool(gen, w, dtype, cuda, page)
    before = bg.scatter_pages.launches
    got = bg.scatter_pages(pool.clone(), slots, data)
    want = pool.clone()
    bg.scatter_pages_plain(want.view(rows, -1), slots, data.view(w, -1))
    assert bg.scatter_pages.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [1, 2, 4])
@pytest.mark.parametrize("dtype,page", WRITE_PAGES)
def test_push_commit_kernel_full_flush_matches_plain(cuda, channels, dtype,
                                                     page):
    """N = 8, budget 8: every home's 8 x 8 grid steps write each of its 64
    slots once, the whole pool."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(9)
    n, ppn, budget = 8, 64, 8
    cb = budget // channels
    pool = _pool(gen, n * ppn, dtype, cuda, page)
    slots = torch.stack([torch.randperm(ppn, generator=gen, device=cuda)
                         for _ in range(n)]).view(n, n, budget).to(torch.int32)
    data = _pool(gen, n * budget, dtype, cuda, page).view((n, budget) + page)
    base = torch.zeros((n,), dtype=torch.int32, device=cuda)
    before = bg.push_commit.launches
    got = bg.push_commit(pool.clone(), slots, data, base, channels=channels,
                         cb=cb)
    want = pool.clone()
    bg.push_commit_plain(want.view(n * ppn, -1), slots,
                         data.view(n, budget, -1), base, channels, cb)
    assert bg.push_commit.launches == before + 1
    assert torch.equal(got, want)
    assert not (got == pool).view(n * ppn, -1).all(1).any()


def _write_operands(cuda):
    """A scatter and a push round on the main path's page rows."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(10)
    n, ppn, lanes, page = 8, 8, 4, (16, 8, 128)
    pool = _pool(gen, n * ppn, torch.bfloat16, cuda, page)
    slots = torch.randint(-1, n * ppn, (lanes,), generator=gen, device=cuda,
                          dtype=torch.int32)
    data = _pool(gen, lanes, torch.bfloat16, cuda, page)
    pslots = torch.randint(-1, ppn, (n, n, lanes), generator=gen,
                           device=cuda, dtype=torch.int32)
    pdata = _pool(gen, n * lanes, torch.bfloat16, cuda, page).view(
        (n, lanes) + page)
    base = torch.zeros((n,), dtype=torch.int32, device=cuda)
    return pool, slots, data, pslots, pdata, base


def _misaligned(x):
    """x's values in a view that starts 2 bytes into a bf16 buffer."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def _strided(x):
    """x's values in a view that is not contiguous."""
    return torch.stack([x, x], -1)[..., 0]


@pytest.mark.gpu
@pytest.mark.parametrize("fault,match", [
    ("int64 ids", "int32"), ("misaligned data", "16-byte"),
    ("not contiguous", "contiguous"), ("cpu operand", "one device")])
def test_write_kernels_refuse_what_they_cannot_take(cuda, fault, match):
    pool, slots, data, pslots, pdata, base = _write_operands(cuda)
    bad = {"int64 ids": lambda ids, d: (ids.long(), d),
           "misaligned data": lambda ids, d: (ids, _misaligned(d)),
           "not contiguous": lambda ids, d: (_strided(ids), _strided(d)),
           "cpu operand": lambda ids, d: (ids.cpu(), d)}[fault]
    before = (bg.scatter_pages.launches, bg.push_commit.launches)
    s_ids, s_data = bad(slots, data)
    with pytest.raises(ValueError, match=match):
        bg.scatter_pages(pool, s_ids, s_data)
    p_ids, p_data = bad(pslots, pdata)
    with pytest.raises(ValueError, match=match):
        bg.push_commit(pool, p_ids, p_data, base, channels=1, cb=4)
    assert (bg.scatter_pages.launches, bg.push_commit.launches) == before


@pytest.mark.gpu
def test_write_kernels_replay_in_a_cuda_graph(cuda):
    """Ten scatters and ten push rounds recorded in one CUDA graph and
    replayed give what ten calls of the plain versions give."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    n, ppn, lanes, page, calls = 8, 8, 8, (16, 8, 128), 10
    rows = n * ppn
    pool0 = _pool(gen, rows, torch.bfloat16, cuda, page)
    slots = [_wide_slots(gen, lanes, rows, cuda) for _ in range(calls)]
    data = [_pool(gen, lanes, torch.bfloat16, cuda, page)
            for _ in range(calls)]
    pslots = [torch.randint(-1, ppn + 1, (n, n, lanes), generator=gen,
                            device=cuda, dtype=torch.int32)
              for _ in range(calls)]
    pdata = _pool(gen, n * 2 * lanes, torch.bfloat16, cuda, page).view(
        (n, 2 * lanes) + page)
    bases = [torch.randint(0, 2 * lanes, (n,), generator=gen, device=cuda,
                           dtype=torch.int32) for _ in range(calls)]
    pool_s, pool_p = pool0.clone(), pool0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up: build, load, bind
        bg.scatter_pages(pool_s.clone(), slots[0], data[0])
        bg.push_commit(pool_p.clone(), pslots[0], pdata, bases[0],
                       channels=2, cb=4)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            bg.scatter_pages(pool_s, slots[i], data[i])
            bg.push_commit(pool_p, pslots[i], pdata, bases[i], channels=2,
                           cb=4)
    pool_s.copy_(pool0)
    pool_p.copy_(pool0)
    graph.replay()
    torch.cuda.synchronize()
    want_s, want_p = pool0.clone(), pool0.clone()
    for i in range(calls):
        bg.scatter_pages_plain(want_s.view(rows, -1), slots[i],
                               data[i].view(lanes, -1))
        bg.push_commit_plain(want_p.view(rows, -1), pslots[i],
                             pdata.view(n, 2 * lanes, -1), bases[i], 2, 4)
    assert torch.equal(pool_s, want_s)
    assert torch.equal(pool_p, want_p)
    assert not torch.equal(pool_p, pool0)


# flash: (B, Sq, Sk, H, kv, hd, causal, window, q_offset)
FLASH = [
    (2, 256, 256, 32, 8, 128, True, 0, 0),
    (1, 200, 200, 4, 2, 64, False, 0, 0),
    (1, 300, 300, 4, 2, 64, True, 100, 0),
    (1, 128, 384, 4, 4, 64, True, 0, 256),
    (1, 77, 130, 4, 1, 120, True, 0, 0),
    (1, 96, 96, 4, 1, 256, True, 0, 0),
    (1, 40, 40, 6, 3, 8, True, 0, -3),
    (1, 96, 130, 4, 1, 192, True, 0, 34),        # hd 192
    (1, 1000, 1000, 8, 8, 128, True, 0, 0),      # ragged tiles, g = 1
    (1, 200, 200, 64, 8, 128, True, 0, 0),       # g = 8
    (1, 64, 64, 4, 2, 64, True, 16, -40),        # 40 rows see no key
    (8, 1024, 1024, 32, 8, 128, True, 0, 0),     # the sequence forward's
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal,window,q_offset", FLASH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, dtype, b, sq, sk, h, kv, hd, causal,
                                    window, q_offset):
    """bf16 launches the wgmma kernel and float32 the three-term TF32
    one, once each call; rows that see no key are exact zeros."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, sk, kv, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, sk, kv, hd), generator=gen, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    kernel = fa.WGMMA if dtype == torch.bfloat16 else fa.TF32X3
    before = fa.flash_attention.launches
    by_kernel = dict(fa.flash_attention.launches_by_kernel)
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.flash_attention.launches == before + 1
    by_kernel[kernel] += 1
    assert fa.flash_attention.launches_by_kernel == by_kernel
    want = attention_ref(q, k, v, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    q_pos = torch.arange(sq, device=cuda)[:, None] + q_offset
    k_pos = torch.arange(sk, device=cuda)[None, :]
    seen = (k_pos <= q_pos) if causal else torch.ones_like(q_pos - k_pos,
                                                           dtype=torch.bool)
    if window > 0:
        seen &= q_pos - k_pos < window
    assert not got[:, ~seen.any(1)].any()


def _attention_f64(q, k, v):
    """Causal attention in float64 on the card, one batch at a time."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for i in range(b):
        qg = q[i].double().view(s, kv, h // kv, hd)
        sc = torch.einsum("qkgd,skd->kgqs", qg, k[i].double()) * hd ** -0.5
        p = torch.softmax(sc.masked_fill(~keep, float("-inf")), dim=-1)
        out[i] = torch.einsum("kgqs,skd->qkgd", p, v[i].double()).reshape(
            s, h, hd)
    return out


@pytest.mark.gpu
def test_flash_float32_holds_at_large_scores(cuda):
    """The sequence forward's shape in float32 with q scaled by 4 (scores
    of standard deviation 4): the three-term TF32 kernel stays within 2e-5
    of the plain version, and within 2e-5 of attention in float64 (the
    plain version's own float32 rounding is of the same order there)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(9)
    b, s, h, kv, hd = 8, 1024, 32, 8, 128
    q = 4 * torch.randn((b, s, h, hd), generator=gen, device=cuda)
    k = torch.randn((b, s, kv, hd), generator=gen, device=cuda)
    v = torch.randn((b, s, kv, hd), generator=gen, device=cuda)
    before = fa.flash_attention.launches_by_kernel[fa.TF32X3]
    got = fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches_by_kernel[fa.TF32X3] == before + 1
    torch.testing.assert_close(got, attention_ref(q, k, v), rtol=0,
                               atol=2e-5)
    torch.testing.assert_close(got.double(), _attention_f64(q, k, v), rtol=0,
                               atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h,kv,hd,t", [
    (torch.bfloat16, 32, 8, 128, 16),
    (torch.float32, 8, 2, 64, 16),
    (torch.float32, 4, 1, 128, 8),
])
def test_paged_kernel_matches_plain(cuda, dtype, h, kv, hd, t):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6)
    b, mp = 8, 16
    slots = b * mp + 5
    kp = torch.randn((slots, t, kv, hd), generator=gen, device=cuda).to(dtype)
    vp = torch.randn((slots, t, kv, hd), generator=gen, device=cuda).to(dtype)
    table = torch.randperm(slots, generator=gen, device=cuda)[:b * mp].view(
        b, mp).to(torch.int32)
    table[2, 1] = -1                       # reads slot 0
    table[4, 0] = slots + 9                # reads the last slot
    lengths = torch.tensor([mp * t, 0, 3 * t + 5, t - 1, 2 * t, 7 * t + 1,
                            mp * t + 40, 5], dtype=torch.int32, device=cuda)
    q = torch.randn((b, h, hd), generator=gen, device=cuda).to(dtype)
    got = pa.paged_attention(q, kp, vp, table, lengths, max_pages=mp)
    want = pa.paged_attention_plain(q, kp, vp, table, lengths, max_pages=mp)
    tol = 3e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert not got[1].any() and not got[3].any() and not got[7].any()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 1003, 128 * 1000 + 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_kernels_bit_exact(cuda, dtype, n):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    a, b, c = (torch.randn((n,), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    pairs = [(st.stream_copy(c), st.stream_copy_plain(c)),
             (st.stream_scale(c, 3.0), st.stream_scale_plain(c, 3.0)),
             (st.stream_add(a, b), st.stream_add_plain(a, b)),
             (st.stream_triad(b, c, 3.0), st.stream_triad_plain(b, c, 3.0))]
    # an unaligned view takes the kernel's scalar loop
    pairs.append((st.stream_triad(b[1:], c[1:], 0.7),
                  st.stream_triad_plain(b[1:], c[1:], 0.7)))
    for got, want in pairs:
        assert torch.equal(got, want)


# csrc/stream.cu: a block is kThreads = 256 threads, each holding kBatch = 2
# 16-byte vectors of each input, and the grid is one block a tile.
STREAM_THREADS, STREAM_BATCH = 256, 2


def _stream_lengths(dtype):
    """Lengths on either side of a vector, of one vector a thread of a
    block, of a tile, of 1 to 8 full waves of blocks (one tile a block on
    every SM), and of three times 8 waves with a ragged tail."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    tile = STREAM_THREADS * STREAM_BATCH * vec
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    edges = [vec, STREAM_THREADS * vec, tile] + [r * sms * tile
                                                 for r in (1, 2, 4, 8)]
    return sorted({n + d for n in edges for d in (-1, 1)}
                  | {3 * 8 * sms * tile + vec + 1})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_kernels_straddle_the_batch_and_the_grid(cuda, dtype):
    """Bit-exact at every length of ``_stream_lengths``, aligned (the
    vector loop and its scalar tail) and one element in (the scalar
    loop)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(14)
    lengths = _stream_lengths(dtype)
    a, b, c = (torch.randn((lengths[-1] + 1,), generator=gen,
                           device=cuda).to(dtype) for _ in range(3))
    for n in lengths:
        for off in (0, 1):
            x, y, z = (t[off:off + n] for t in (a, b, c))
            pairs = [(st.stream_copy(z), st.stream_copy_plain(z)),
                     (st.stream_scale(z, 3.0), st.stream_scale_plain(z, 3.0)),
                     (st.stream_add(x, y), st.stream_add_plain(x, y)),
                     (st.stream_triad(y, z, 0.7),
                      st.stream_triad_plain(y, z, 0.7))]
            for got, want in pairs:
                assert torch.equal(got, want), (n, off)


@pytest.mark.gpu
def test_new_wrappers_reject_device_mix_and_grad(cuda):
    q = torch.randn((1, 16, 4, 64), device=cuda)
    k = torch.randn((1, 16, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention(q, k.cpu(), k)
    with pytest.raises(RuntimeError, match="backward"):
        fa.flash_attention(q.requires_grad_(), k, k)
    with pytest.raises(ValueError, match="one device"):
        st.stream_add(torch.zeros(8, device=cuda), torch.zeros(8))
    pool = torch.zeros((4, 8, 2, 64), device=cuda)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one device"):
        pa.paged_attention(q[:, 0], pool, pool, table,
                           torch.zeros((1,), dtype=torch.int32), max_pages=2)


# The decode-attention fold's rounds: B, then each lane's sequence (-1 a
# FREE lane) and the lanes whose live flag is 0 while they keep their id.
FOLD_ROUNDS = {
    "all FREE, W 8": (8, [-1] * 8, []),
    "one sequence, W 8": (8, [5] * 8, []),
    "8-node round, W 64": (8, [i // 8 for i in range(64)], [3, 17, 40]),
    "8 interleaved, W 64": (8, [i % 8 for i in range(64)], [9, 10]),
    "one sequence scattered, W 16": (
        4, [2, -1, 0, 2, 2, 3, -1, 2, 1, 2, 0, 2, -1, 3, 2, 2], [4]),
    "W 256, 28 lanes a sequence past 8 warps": (
        8, [(i * 5) % 9 - 1 for i in range(256)], [7, 100]),
}
# (H, kv, hd, T): g = 1, 4 and 8, hd 64 and 128, T 8 and 16
FOLD_HEADS = [(8, 8, 128, 16), (32, 8, 128, 16), (16, 2, 64, 8)]


def _fold_round(gen, dev, dtype, b, seq, dead, h, kv, hd, t):
    w = len(seq)
    seq = torch.tensor(seq, dtype=torch.int32, device=dev)
    live = (seq >= 0).to(torch.int32)
    live[dead] = 0
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((w, t, kv, hd), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    m = torch.randn((b, h), generator=gen, device=dev)
    m[0] = -1e30                     # a sequence that has folded nothing yet
    l = torch.rand((b, h), generator=gen, device=dev) + 0.5
    l[0] = 0
    o = torch.randn((b, h, hd), generator=gen, device=dev)
    o[0] = 0
    return q, k, v, seq, live, m, l, o


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,kv,hd,t", FOLD_HEADS)
@pytest.mark.parametrize("round_", list(FOLD_ROUNDS))
def test_stream_kernel_round_shapes_match_plain(cuda, round_, h, kv, hd, t,
                                                dtype):
    """The fold at the rounds its block design makes hard, within 1e-5 of
    the plain version, and bit-identical from call to call; a sequence
    with no live lane keeps its state bit for bit."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(21)
    b, seq, dead = FOLD_ROUNDS[round_]
    args = _fold_round(gen, cuda, dtype, b, seq, dead, h, kv, hd, t)
    got = ba.stream_decode_accumulate(*args)
    again = ba.stream_decode_accumulate(*args)
    want = ba.stream_decode_accumulate_plain(*args)
    for g_, a_, w_ in zip(got, again, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)
        assert torch.equal(g_, a_)
    seq, live = args[3], args[4]
    idle = [i for i in range(b)
            if not bool(((seq == i) & (live != 0)).any())]
    for g_, before in zip(got, args[5:]):
        assert torch.equal(g_[idle], before[idle])


@pytest.mark.gpu
@pytest.mark.parametrize("mp", [20, 76])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,kv,hd,t", FOLD_HEADS)
def test_paged_kernel_split_edges_match_plain(cuda, h, kv, hd, t, dtype, mp):
    """Paged attention where its splits are hard: lengths of 0, under a
    page, exactly max_pages pages, past them, on a split's edge and inside
    the last (ragged) split; max_pages 20 and 76 are not multiples of the
    split, and 76 gives more splits than one merge takes; -1 entries and
    slots past the pool.  Within the reference suite's limits of the plain
    version, bit-identical from call to call."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(22)
    b = 8
    assert mp % pa.SPLIT_PAGES
    slots = b * mp + 3
    kp, vp = (torch.randn((slots, t, kv, hd), generator=gen,
                          device=cuda).to(dtype) for _ in range(2))
    table = torch.randperm(slots, generator=gen, device=cuda)[:b * mp].view(
        b, mp).to(torch.int32)
    table[2, 0] = -1
    table[2, 19] = -1
    table[4, 8] = slots + 7
    sp = pa.SPLIT_PAGES
    lengths = torch.tensor([0, t - 1, mp * t, mp * t + 3 * t, sp * t,
                            (sp + 1) * t + 2, 2 * sp * t + 1, t],
                           dtype=torch.int32, device=cuda)
    q = torch.randn((b, h, hd), generator=gen, device=cuda).to(dtype)
    got = pa.paged_attention(q, kp, vp, table, lengths, max_pages=mp)
    again = pa.paged_attention(q, kp, vp, table, lengths, max_pages=mp)
    want = pa.paged_attention_plain(q, kp, vp, table, lengths, max_pages=mp)
    tol = 3e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert torch.equal(got, again)
    assert not got[0].any() and not got[1].any()


@pytest.mark.gpu
def test_decode_kernels_replay_in_a_cuda_graph(cuda):
    """One fold round and one paged call recorded in a CUDA graph, then
    replayed on new values written into the same inputs (new ids, lengths
    and table among them): what the plain versions give on the new values."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(23)
    fold = _fold_round(gen, cuda, torch.bfloat16, 8, [i // 8 for i in
                                                      range(64)], [5],
                       32, 8, 128, 16)
    b, mp, t = 8, 64, 16
    slots = b * mp + 8
    kp, vp = (torch.randn((slots, t, 8, 128), generator=gen,
                          device=cuda).bfloat16() for _ in range(2))
    q = torch.randn((b, 32, 128), generator=gen, device=cuda).bfloat16()
    table = torch.randperm(slots, generator=gen, device=cuda)[:b * mp].view(
        b, mp).to(torch.int32)
    lengths = torch.tensor([1024, 0, 17, 500, 1023, 16, 777, 64],
                           dtype=torch.int32, device=cuda)
    paged = (q, kp, vp, table, lengths)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up: build, load, bind
        ba.stream_decode_accumulate(*fold)
        pa.paged_attention(*paged, max_pages=mp)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        state = ba.stream_decode_accumulate(*fold)
        out = pa.paged_attention(*paged, max_pages=mp)
    new_fold = _fold_round(gen, cuda, torch.bfloat16, 8,
                           [i % 8 for i in range(64)], [1, 2], 32, 8, 128, 16)
    for x, y in zip(fold, new_fold):
        x.copy_(y)
    q.copy_(torch.randn(q.shape, generator=gen, device=cuda))
    table.copy_(torch.randperm(slots, generator=gen, device=cuda)[:b * mp]
                .view(b, mp))
    lengths.copy_(torch.tensor([3, 1024, 600, 0, 16, 33, 64, 900],
                               device=cuda))
    graph.replay()
    torch.cuda.synchronize()
    for g_, w_ in zip(state, ba.stream_decode_accumulate_plain(*fold)):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)
    want = pa.paged_attention_plain(*paged, max_pages=mp)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=3e-2)
    assert not out[3].any() and out[1].any()


@pytest.mark.gpu
def test_loopback_table_nodes_pull_matches_cpu(cuda):
    """A loopback pull and push over 4 logical memory nodes (a control
    plane's table, its hierarchical program, a throttled budget, counters
    on) give on the card what they give on the CPU: one gather and one
    scatter launch."""
    from repro_torch.core import bridge
    from repro_torch.core.control_plane import ControlPlane
    from repro_torch.core.topology import Topology
    from repro_torch.telemetry.aggregate import to_host

    topo = Topology.boards(2, 2)
    results = {}
    for dev in ("cpu", cuda):
        cp = ControlPlane(4, 16, 48, seed=3, topology=topo, device=dev)
        for policy in ("striped", "hashed", "affinity"):
            cp.allocate(12, policy=policy, affinity=2)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(9)
        pool = torch.randn((64, 16, 8, 128), generator=gen).bfloat16().to(dev)
        want = torch.randint(-1, 48, (4, 20), generator=gen,
                             dtype=torch.int32).to(dev)
        payload = torch.randn((4, 20, 16, 8, 128),
                              generator=gen).bfloat16().to(dev)
        kw = dict(budget=8, table_nodes=4, program=cp.route_program(),
                  active_budget=torch.tensor([2], device=dev), topology=topo,
                  collect_telemetry=True)
        before = (bg.gather_pages.launches, bg.scatter_pages.launches)
        pages, pull_t = bridge.pull_pages(pool, want, cp.table(), **kw)
        pool, push_t = bridge.push_pages(pool, want, payload, cp.table(),
                                         **kw)
        launched = (bg.gather_pages.launches - before[0],
                    bg.scatter_pages.launches - before[1])
        results[str(dev)] = (pages.cpu(), pool.cpu(), to_host(pull_t),
                             to_host(push_t), launched)
    cpu, card = results["cpu"], results[str(cuda)]
    assert card[4] == (1, 1)
    assert torch.equal(card[0], cpu[0]) and torch.equal(card[1], cpu[1])
    for got, want in ((card[2], cpu[2]), (card[3], cpu[3])):
        for f in dataclasses.fields(got):
            assert (getattr(got, f.name) == getattr(want, f.name)).all(), f


# The decode shapes of the dense configs, T 16 in bf16: (H, kv, hd) of
# gemma3-12b (hd 256, g 2), h2o-danube-3-4b (hd 120, g 4) and starcoder2-7b
# (hd 128, g 9).  None is fold_page16's (hd 128, g 4): the general fold runs.
DENSE_HEADS = [(16, 8, 256), (32, 8, 120), (36, 4, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv,hd", DENSE_HEADS)
@pytest.mark.parametrize("round_", ["one sequence, W 8", "8-node round, W 64",
                                    "W 256, 28 lanes a sequence past 8 warps"])
def test_stream_kernel_dense_config_shapes_match_plain(cuda, round_, h, kv,
                                                       hd):
    """The fold at the dense configs' heads within 1e-5 of the plain
    version, bit-identical from call to call."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(23)
    b, seq, dead = FOLD_ROUNDS[round_]
    args = _fold_round(gen, cuda, torch.bfloat16, b, seq, dead, h, kv, hd, 16)
    got = ba.stream_decode_accumulate(*args)
    again = ba.stream_decode_accumulate(*args)
    want = ba.stream_decode_accumulate_plain(*args)
    for g_, a_, w_ in zip(got, again, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)
        assert torch.equal(g_, a_)


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv,hd", DENSE_HEADS)
def test_paged_kernel_dense_config_shapes_match_plain(cuda, h, kv, hd):
    """Paged attention at the dense configs' heads (bf16, T 16) within the
    reference suite's 3e-2 of the plain version, over lengths of 0, under
    a page, ragged and past max_pages."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(24)
    b, mp, t = 8, 20, 16
    slots = b * mp + 3
    kp, vp = (torch.randn((slots, t, kv, hd), generator=gen,
                          device=cuda).to(torch.bfloat16) for _ in range(2))
    table = torch.randperm(slots, generator=gen, device=cuda)[:b * mp].view(
        b, mp).to(torch.int32)
    table[3, 2] = -1
    lengths = torch.tensor([0, t - 1, mp * t, mp * t + 40, 3 * t + 5,
                            9 * t, 17 * t + 1, t], dtype=torch.int32,
                           device=cuda)
    q = torch.randn((b, h, hd), generator=gen, device=cuda).to(torch.bfloat16)
    got = pa.paged_attention(q, kp, vp, table, lengths, max_pages=mp)
    again = pa.paged_attention(q, kp, vp, table, lengths, max_pages=mp)
    want = pa.paged_attention_plain(q, kp, vp, table, lengths, max_pages=mp)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=3e-2)
    assert torch.equal(got, again)
    assert not got[0].any()


# flash backward: (B, Sq, Sk, H, kv, hd, causal, window, q_offset)
FLASH_BWD = [
    (2, 256, 256, 32, 8, 128, True, 0, 0),       # granite's heads
    (1, 200, 230, 8, 2, 64, True, 50, -20),      # window, dead rows, ragged
    (1, 128, 384, 32, 8, 128, True, 0, 256),     # q_offset > 0, ragged
    (1, 200, 260, 32, 8, 120, True, 0, 60),      # hd 120 (h2o-danube-3-4b)
    (1, 192, 192, 8, 8, 128, True, 0, -30),      # g 1, dead rows
    (1, 100, 100, 36, 4, 128, True, 0, 0),       # g 9: a padding row a tile
    (1, 130, 70, 8, 2, 64, False, 0, 0),         # bidirectional, Sq > Sk
    (1, 128, 160, 16, 8, 256, True, 0, 0),       # hd 256 (gemma3-12b)
    (1, 64, 64, 4, 4, 8, True, 0, 0),            # hd 8
    (4, 64, 64, 4, 2, 32, True, 0, 0),           # the reduced configs' heads
    (1, 300, 300, 12, 4, 96, True, 100, 0),      # g 3, window, hd 96
    (1, 160, 160, 8, 4, 192, True, 0, 0),        # hd 192: three 64-column
                                                 # blocks split 2 / 1
    (1, 100, 300, 6, 2, 64, False, 50, 120),     # a window, not causal
    (1, 200, 260, 8, 2, 136, True, 0, 60),       # hd 136 padded to 192
    (1, 150, 150, 18, 2, 192, True, 40, -20),    # hd 192, g 9, window, dead
]


def _bwd_inputs(gen, dtype, b, sq, sk, h, kv, hd, device):
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd),
                          (b, sq, h, hd))]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal,window,q_offset", FLASH_BWD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, b, sq, sk, h, kv, hd,
                                        causal, window, q_offset):
    """dq, dk and dv within 2e-4 (float32) or 2e-2 of the largest (bf16)
    of the plain version, one launch a call of the kernel the (dtype, hd)
    table names (bf16: the wgmma kernel up to hd 128 and the split-hd one
    above; float32: the TF32 one up to hd 128 and the split-hd one above),
    bit-identical between calls (no atomics), zero for rows that see no
    key."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(31)
    q, k, v, do = _bwd_inputs(gen, dtype, b, sq, sk, h, kv, hd, cuda)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    kernel = fa.bwd_variant(dtype, hd).kernel
    assert (kernel == fa.BWD_WGMMA) == (dtype == torch.bfloat16 and hd <= 128)
    assert (kernel == fa.BWD_WGMMA256) == (dtype == torch.bfloat16
                                           and hd > 128)
    assert (kernel == fa.BWD_TF32X3) == (dtype == torch.float32 and hd <= 128)
    assert (kernel == fa.BWD_TF32X3_256) == (dtype == torch.float32
                                             and hd > 128)
    before = fa.flash_attention_bwd.launches
    by_kernel = fa.flash_attention_bwd.launches_by_kernel[kernel]
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert fa.flash_attention_bwd.launches == before + 2
    assert fa.flash_attention_bwd.launches_by_kernel[kernel] == by_kernel + 2
    want = tflash.flash_bwd_ref(q, k, v, o, do, lse, **kw)
    for g_, a_, w_ in zip(got, again, want):
        assert g_.dtype == dtype and torch.equal(g_, a_)
        err = float((g_.float() - w_.float()).abs().max())
        limit = 2e-4 if dtype == torch.float32 else \
            2e-2 * float(w_.float().abs().max())
        assert err <= limit, err
    if q_offset < 0:
        assert not got[0][:, :-q_offset].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_lse_leaves_the_output_unchanged(cuda, dtype):
    """Asking for the log-sum-exp changes no bit of the output; the lse is
    the plain version's within float32 rounding, -1e30 on dead rows."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(32)
    for b, sq, sk, h, kv, hd, causal, window, q_offset in FLASH:
        q, k, v, _ = _bwd_inputs(gen, dtype, b, sq, sk, h, kv, hd, cuda)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        plain = fa.flash_attention(q, k, v, **kw)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        assert torch.equal(o, plain)
        _, want = tflash.attention_lse_ref(q, k, v, **kw)
        torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_flash_bwd_kernel_replays_in_a_cuda_graph(cuda):
    """The bf16 wgmma backward (its wrapper allocates only the outputs and
    the statistics scratch and never syncs) recorded in a CUDA graph."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(33)
    q, k, v, do = _bwd_inputs(gen, torch.bfloat16, 1, 128, 128, 8, 2, 128,
                              cuda)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    assert fa.bwd_variant(q.dtype, 128).kernel == fa.BWD_WGMMA
    want = fa.flash_attention_bwd(q, k, v, o, do, lse)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_attention_bwd(q, k, v, o, do, lse)
    for x in out:
        x.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for g_, w_ in zip(out, want):
        assert torch.equal(g_, w_)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [136, 256])
def test_flash_bwd_wgmma256_kernel_one_launch_and_replays(cuda, hd):
    """The bf16 backward above hd 128 at gemma3-12b's 16/8 heads: one
    launch of the split-hd kernel a call, two calls bit-identical, and the
    same bits replayed from a CUDA graph (its wrapper allocates only the
    outputs and the statistics scratch and never syncs)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(36)
    q, k, v, do = _bwd_inputs(gen, torch.bfloat16, 2, 256, 256, 16, 8, hd,
                              cuda)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    assert fa.bwd_variant(q.dtype, hd).kernel == fa.BWD_WGMMA256
    before = fa.flash_attention_bwd.launches_by_kernel[fa.BWD_WGMMA256]
    want = fa.flash_attention_bwd(q, k, v, o, do, lse)
    again = fa.flash_attention_bwd(q, k, v, o, do, lse)
    assert (fa.flash_attention_bwd.launches_by_kernel[fa.BWD_WGMMA256]
            == before + 2)
    assert all(torch.equal(x, y) for x, y in zip(want, again))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_attention_bwd(q, k, v, o, do, lse)
    for x in out:
        x.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for g_, w_ in zip(out, want):
        assert torch.equal(g_, w_)


@pytest.mark.gpu
def test_flash_bwd_tf32_kernel_replays_in_a_cuda_graph(cuda):
    """The float32 TF32 backward (its wrapper allocates only the outputs
    and the delta scratch and never syncs) recorded in a CUDA graph."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(35)
    q, k, v, do = _bwd_inputs(gen, torch.float32, 1, 200, 200, 8, 2, 120,
                              cuda)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    assert fa.bwd_variant(q.dtype, 120).kernel == fa.BWD_TF32X3
    want = fa.flash_attention_bwd(q, k, v, o, do, lse)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_attention_bwd(q, k, v, o, do, lse)
    for x in out:
        x.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for g_, w_ in zip(out, want):
        assert torch.equal(g_, w_)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_launches_both_kernels(cuda, dtype):
    """The autograd function on CUDA tensors: one forward and one backward
    launch, the gradients the backward wrapper gives."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(34)
    q, k, v, do = _bwd_inputs(gen, dtype, 1, 96, 96, 4, 2, 64, cuda)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    out = tflash.flash_attention(*leaves, causal=True, window=0, q_offset=0)
    out.backward(do)
    assert fa.flash_attention.launches == fwd + 1
    assert fa.flash_attention_bwd.launches == bwd + 1
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    for got, want in zip((x.grad for x in leaves),
                         fa.flash_attention_bwd(q, k, v, o, do, lse)):
        assert torch.equal(got, want)
