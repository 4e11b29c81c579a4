"""The float32 flash backward above hd 128 on the card.

``csrc/flash_attention_bwd_tf32_256.cu`` (the split-hd TF32 kernel, three
TF32 products a product) against the plain version, ``flash_bwd_ref``, at
hd 136 (padded to 192), 192 and 256, causal, windowed, bidirectional and
with rows that see no key.  These need a CUDA device and ``nvcc`` (the
kernel builds at first launch); without a card they skip.  Run them on a
GPU machine with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_flash_bwd_tf32_256.py

``tests/test_torch_flash_bwd_tf32.py`` holds the kernel's arithmetic and
tiles, transcribed in plain PyTorch, to the reference on the CPU.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.models import flash as tflash

TOL = 2e-4

# (B, Sq, Sk, H, kv, hd, causal, window, q_offset)
CASES = [
    (2, 256, 256, 16, 8, 256, True, 0, 0),       # gemma3-12b's heads
    (1, 192, 192, 16, 8, 256, True, 0, -30),     # rows that see no key
    (1, 70, 90, 4, 1, 256, True, 16, -40),       # g 4, window, dead rows
    (1, 130, 70, 8, 2, 256, False, 0, 0),        # bidirectional, Sq > Sk
    (1, 160, 160, 8, 4, 192, True, 0, 0),        # hd 192: columns 128 / 64
    (1, 150, 150, 18, 2, 192, True, 40, -20),    # g 9, window, dead rows
    (1, 200, 260, 8, 2, 136, True, 0, 60),       # hd 136 padded, ragged
    (1, 100, 300, 6, 2, 136, False, 50, 120),    # a window, not causal
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal,window,q_offset", CASES)
def test_split_hd_tf32_backward_matches_plain(cuda, b, sq, sk, h, kv, hd,
                                              causal, window, q_offset):
    """dq, dk and dv within 2e-4 of the plain version, one launch of
    ``BWD_TF32X3_256`` a call, two calls bit-identical (no atomics), zero
    dq on rows that see no key and zero dk, dv on keys no row sees."""
    assert fa.bwd_variant(torch.float32, hd).kernel == fa.BWD_TF32X3_256
    gen = torch.Generator(device=cuda)
    gen.manual_seed(hd + sq)
    q, k, v, do = (torch.randn(shape, generator=gen, device=cuda)
                   for shape in ((b, sq, h, hd), (b, sk, kv, hd),
                                 (b, sk, kv, hd), (b, sq, h, hd)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    before = (fa.flash_attention_bwd.launches,
              fa.flash_attention_bwd.launches_by_kernel[fa.BWD_TF32X3_256])
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert (fa.flash_attention_bwd.launches,
            fa.flash_attention_bwd.launches_by_kernel[fa.BWD_TF32X3_256]) == (
                before[0] + 2, before[1] + 2)
    want = tflash.flash_bwd_ref(q, k, v, o, do, lse, **kw)
    for name, g_, a_, w_ in zip(("dq", "dk", "dv"), got, again, want):
        assert g_.dtype == torch.float32 and torch.equal(g_, a_), name
        err = float((g_ - w_).abs().max())
        assert err <= TOL, (name, err)
    seen = tflash._mask(torch.arange(sq) + q_offset, torch.arange(sk),
                        causal, window).to(cuda)
    dead_rows, dead_keys = ~seen.any(1), ~seen.any(0)
    assert not got[0][:, dead_rows].any()
    assert not got[1][:, dead_keys].any() and not got[2][:, dead_keys].any()
    if q_offset < 0:
        assert dead_rows.any()


@pytest.mark.gpu
def test_split_hd_tf32_entry_refuses_hd_128(cuda):
    """The entry point takes hd 136 to 256 only: hd 128 (the other float32
    kernel's) is refused with an error code, which the wrapper raises."""
    fn = fa._bind(fa.BWD_TF32X3_256)
    x = torch.zeros(1, 16, 1, 128, device=cuda)
    lse = torch.zeros(1, 1, 16, device=cuda)
    ptrs = [t.data_ptr() for t in (x, x, x, x, x, lse, lse, x, x, x)]
    err = fn(*ptrs, 1, 16, 16, 1, 1, 128, 128, 0, 1, 0, 0, 128 ** -0.5,
             torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError):
        fa._build.check(err, "flash_attention_bwd")
