"""Plain PyTorch oracles of the kernel API, under the reference's names.

Ports ``repro.kernels.ref``: each is the plain version that the kernel's
wrapper runs for CPU tensors, the target the kernels are held to.
"""
from __future__ import annotations

from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.kernels.stream import (stream_add_plain, stream_copy_plain,
                                        stream_scale_plain,
                                        stream_triad_plain)
from repro_torch.models.flash import attention_ref

# -- STREAM -------------------------------------------------------------------

stream_copy_ref = stream_copy_plain
stream_scale_ref = stream_scale_plain
stream_add_ref = stream_add_plain
stream_triad_ref = stream_triad_plain


# -- flash attention ----------------------------------------------------------

def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)


# -- paged decode attention ---------------------------------------------------

paged_attention_ref = paged_attention_plain
