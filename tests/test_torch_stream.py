"""Port parity: the STREAM kernels (copy, scale, add, triad).

The same numpy arrays go through the JAX package's ``ops.stream_*`` (its
Pallas kernels in interpret mode), its oracles ``ref.stream_*_ref`` and the
port's kernel API, which on CPU tensors runs the plain versions.  The
tolerances are the reference suite's (1e-6 in float32, 5e-2 in bfloat16),
not 0: XLA may contract the triad's ``b + q * c`` into one fused
multiply-add and may round a bfloat16 sum at another place, where the port
rounds after every float32 operation.  The port's kernel is held bit for bit
to its own plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.configs import paper_stream
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stream as tstream

TOL = {"float32": dict(atol=1e-6), "bfloat16": dict(atol=5e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def arrays(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n,)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", [128, 1024, 128 * 256, 128 * 1000, 1003])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_matches_reference(n, dtype):
    a, b, c = arrays(n)
    ja, jb, jc = (jnp.asarray(x, JDT[dtype]) for x in (a, b, c))
    ta, tb, tc = (torch.from_numpy(x).to(TDT[dtype]) for x in (a, b, c))
    cases = [
        (tops.stream_copy(tc), jops.stream_copy(jc), jref.stream_copy_ref(jc)),
        (tops.stream_scale(tc), jops.stream_scale(jc, 3.0),
         jref.stream_scale_ref(jc, 3.0)),
        (tops.stream_add(ta, tb), jops.stream_add(ja, jb),
         jref.stream_add_ref(ja, jb)),
        (tops.stream_triad(tb, tc), jops.stream_triad(jb, jc, 3.0),
         jref.stream_triad_ref(jb, jc, 3.0)),
    ]
    for got, kernel, oracle in cases:
        assert got.dtype == TDT[dtype] and got.shape == (n,)
        got = got.float().numpy()
        np.testing.assert_allclose(got, np.asarray(kernel, np.float32),
                                   **TOL[dtype])
        np.testing.assert_allclose(got, np.asarray(oracle, np.float32),
                                   **TOL[dtype])


def test_stream_ref_names_the_plain_versions():
    a, b, c = (torch.from_numpy(x).bfloat16() for x in arrays(1003, seed=1))
    assert torch.equal(tref.stream_copy_ref(c), c)
    assert torch.equal(tops.stream_scale(c, 2.5),
                       tref.stream_scale_ref(c, 2.5))
    assert torch.equal(tops.stream_add(a, b), tref.stream_add_ref(a, b))
    assert torch.equal(tops.stream_triad(b, c, 0.5),
                       tref.stream_triad_ref(b, c, 0.5))
    # the plain versions compute in float32 and round once to bfloat16
    want = (b.float() + 0.5 * c.float()).bfloat16()
    assert torch.equal(tstream.stream_triad_plain(b, c, 0.5), want)


def test_stream_raises_on_bad_operands():
    a, b, _ = (torch.from_numpy(x) for x in arrays(16))
    with pytest.raises(ValueError, match="1-D"):
        tstream.stream_add(a, b[:8])
    with pytest.raises(ValueError, match="share"):
        tstream.stream_add(a, b.bfloat16())
    with pytest.raises(ValueError, match="1-D"):
        tstream.stream_copy(a.view(4, 4))
    for fn in (tstream.stream_copy, tstream.stream_scale, tstream.stream_add,
               tstream.stream_triad):
        assert fn.launches == 0


def test_paper_stream_case_study_matches_reference():
    from repro.configs import paper_stream as jpaper
    assert paper_stream.CONFIG == paper_stream.StreamCaseStudy()
    assert vars(paper_stream.CONFIG) == vars(jpaper.CONFIG)


def test_stream_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU reaches the kernel or an exception:
    here (no CUDA) every pass raises on meta tensors."""
    x = torch.empty((64,), device="meta")
    for call in (lambda: tstream.stream_copy(x),
                 lambda: tstream.stream_scale(x, 3.0),
                 lambda: tstream.stream_add(x, x),
                 lambda: tstream.stream_triad(x, x, 3.0)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="one device"):
        tstream.stream_add(torch.zeros(64), x)
