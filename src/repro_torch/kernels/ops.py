"""Public wrappers of the port's kernels, under the reference's names.

Ports ``repro.kernels.ops``: the STREAM passes, flash attention and paged
decode attention, with the reference's defaults (``q=3.0`` for scale and
triad, ``causal=True``; the STREAM functions carry theirs, so they are
exported as they are, without a frame of their own).  The reference jits
each wrapper and resolves its Pallas interpreter here; the port runs
eagerly, and each call takes its kernel for CUDA tensors and its plain
version for CPU tensors.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.stream import (stream_add, stream_copy, stream_scale,
                                        stream_triad)

__all__ = ["stream_copy", "stream_scale", "stream_add", "stream_triad",
           "flash_attention", "paged_attention"]
