"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA device and ``nvcc`` (the kernels build at first launch);
without a card they skip.  Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import pytest
import torch

from repro_torch.kernels import bridge_attention as ba
from repro_torch.kernels import bridge_gather as bg


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
