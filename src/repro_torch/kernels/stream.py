"""STREAM copy / scale / add / triad (the paper's evaluation kernels).

Each pass takes 1-D float32 or bfloat16 tensors of any length, computes in
float32 and stores in the input's dtype.  A CPU tensor runs the plain
version beside the kernel; a CUDA tensor launches ``csrc/stream.cu`` (or
raises), which rounds as the plain version does, so the two agree bit for
bit.  Each wrapper counts its launches in ``<fn>.launches``.  scale and
triad take ``q=3.0`` by default, the default of the reference's ``ops``
wrappers, so ``kernels.ops`` exports these functions as they are.  The
reference's ``block_rows`` and ``interpret`` choose the TPU's tiling and
interpreter and change no result; they do not exist here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# dtype, pass, x, y, out, n, q, stream (csrc/stream.cu), packed
_FIELDS = "6qdq"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_stream_c = None          # the kernel's C function, bound at its first launch
_COPY, _SCALE, _ADD, _TRIAD = range(4)


def stream_copy_plain(c):
    return c.clone()


def stream_scale_plain(c, q):
    return (q * c.float()).to(c.dtype)


def stream_add_plain(a, b):
    return (a.float() + b.float()).to(a.dtype)


def stream_triad_plain(b, c, q):
    return (b.float() + q * c.float()).to(b.dtype)


def _refuse(what: str, x: torch.Tensor, y) -> None:
    """Raise the error that names why :func:`_run` refused its operands."""
    xs = (x,) if y is None else (x, y)
    if x.dim() != 1 or (y is not None and y.shape != x.shape):
        raise ValueError(f"{what}: operands must be 1-D of one length, got "
                         f"{[list(t.shape) for t in xs]}")
    raise ValueError(f"{what}: operands must share float32 or bfloat16, "
                     f"got {[t.dtype for t in xs]}")


def _run(fn, what: str, pass_: int, x: torch.Tensor, y=None,
         q: float = 0.0) -> torch.Tensor:
    """Check the operands and launch one pass; None when they lie on the
    CPU (the caller runs the plain version).  The kernel's case is one
    pass of compares; only a refusal works out which rule broke."""
    code = _DTYPE_CODE.get(x.dtype)
    if code is None or x.dim() != 1 or (
            y is not None and (y.shape != x.shape or y.dtype != x.dtype)):
        _refuse(what, x, y)
    # Unaligned operands take the kernel's scalar loop.
    if (_build.on_cpu(what, x, aligned=False) if y is None
            else _build.on_cpu(what, x, y, aligned=False)):
        return None
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    global _stream_c
    if _stream_c is None:
        _stream_c = _build.bind("stream", "repro_stream", _FIELDS)
    _build.check(_stream_c(code, pass_, x.data_ptr(),
                           0 if y is None else y.data_ptr(), out.data_ptr(),
                           n, q, _build.stream_of(x)), what)
    fn.launches += 1
    return out


def stream_copy(c: torch.Tensor) -> torch.Tensor:
    """a[i] = c[i] (STREAM 'copy')."""
    out = _run(stream_copy, "stream_copy", _COPY, c)
    return stream_copy_plain(c) if out is None else out


def stream_scale(c: torch.Tensor, q: float = 3.0) -> torch.Tensor:
    """b[i] = q * c[i] (STREAM 'scale')."""
    out = _run(stream_scale, "stream_scale", _SCALE, c, q=q)
    return stream_scale_plain(c, q) if out is None else out


def stream_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c[i] = a[i] + b[i] (STREAM 'add')."""
    out = _run(stream_add, "stream_add", _ADD, a, b)
    return stream_add_plain(a, b) if out is None else out


def stream_triad(b: torch.Tensor, c: torch.Tensor,
                 q: float = 3.0) -> torch.Tensor:
    """a[i] = b[i] + q * c[i] (STREAM 'triad')."""
    out = _run(stream_triad, "stream_triad", _TRIAD, b, c, q=q)
    return stream_triad_plain(b, c, q) if out is None else out


for _fn in (stream_copy, stream_scale, stream_add, stream_triad):
    _fn.launches = 0
del _fn
