"""Streaming decode attention over bridge-pulled KV page rounds.

:func:`stream_decode_accumulate` folds one round of landed pages
``[W, T, kv, hd]`` into the running float32 flash-decode state
``(m, l, acc)``, so decode attention never materializes more than one round
of pulled pages.  A CPU tensor runs the plain PyTorch version beside the
kernel; a CUDA tensor launches ``csrc/bridge_attention.cu`` (or raises; the
kernel takes 16-byte aligned q, pages and o, and a head of a multiple of 16
bytes).  The wrapper counts its kernel launches in
``stream_decode_accumulate.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

# dtype, 11 pointers, 6 sizes, scale, stream (csrc/bridge_attention.cu),
# packed
_FIELDS = "18qdq"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_stream_c = None          # the kernel's C function, bound at its first launch


def stream_decode_accumulate_plain(q, k_pages, v_pages, seq_ids, live,
                                   m, l, o):
    """Plain version: the same online-softmax update, lane by lane in
    landing order, each lane applied to the one sequence it belongs to."""
    b, h, hd = q.shape
    w, t, kv, _ = k_pages.shape
    g = h // kv
    qg = q.float().reshape(b, kv, g, hd)
    bs = torch.arange(b, device=q.device)
    m, l, o = m.float(), l.float(), o.float()
    for i in range(w):
        k = k_pages[i].float()                               # [T, kv, hd]
        v = v_pages[i].float()
        s = torch.einsum("bkgd,tkd->bkgt", qg, k).reshape(b, h, t)
        s = s * (hd ** -0.5)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgt,tkd->bkgd", p.reshape(b, kv, g, t), v)
        o_new = o * alpha[..., None] + pv.reshape(b, h, hd)
        sel = ((seq_ids[i] == bs) & (live[i] != 0))[:, None]
        m = torch.where(sel, m_new, m)
        l = torch.where(sel, l_new, l)
        o = torch.where(sel[..., None], o_new, o)
    return m, l, o


def new_state(b: int, h: int, hd: int, device):
    """Uninitialized float32 ``(m [b, h], l [b, h], o [b, h, hd])``, views
    of one buffer: o first, so it keeps the buffer's 16-byte alignment, and
    l four-float aligned after m."""
    n = b * h
    pad = -(-n // 4) * 4
    buf = torch.empty(n * hd + 2 * pad, dtype=torch.float32, device=device)
    return (buf.as_strided((b, h), (h, 1), n * hd),
            buf.as_strided((b, h), (h, 1), n * hd + pad),
            buf.as_strided((b, h, hd), (h * hd, hd, 1), 0))


def stream_decode_accumulate(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, seq_ids: torch.Tensor,
                             live: torch.Tensor, m: torch.Tensor,
                             l: torch.Tensor, o: torch.Tensor):
    """Fold one landed page round into the flash-decode accumulators.

    q: [B, H, hd] decode queries; k_pages/v_pages: [W, T, kv, hd] this
    round's landed flits (q's dtype); seq_ids: i32[W] owning sequence per
    lane; live: i32[W] nonzero where the lane carries a real page;
    m, l: f32[B, H]; o: f32[B, H, hd] running (max, denom, weighted-sum)
    state.  Returns the updated ``(m, l, o)`` as new tensors.  Replaces
    ``repro.kernels.bridge_attention.stream_decode_accumulate``.
    """
    b, h, hd = q.shape
    w, t, kv, hd_k = k_pages.shape
    if (hd_k != hd or h % kv or tuple(v_pages.shape) != (w, t, kv, hd)
            or tuple(seq_ids.shape) != (w,) or tuple(live.shape) != (w,)
            or tuple(m.shape) != (b, h) or tuple(l.shape) != (b, h)
            or tuple(o.shape) != (b, h, hd)):
        raise ValueError("stream_decode_accumulate: shapes do not match "
                         "q [B,H,hd], pages [W,T,kv,hd], ids [W], m,l [B,H], "
                         "o [B,H,hd]")
    what = "stream_decode_accumulate"
    if _build.on_cpu(what, q, k_pages, v_pages, m, l, o, ids=(seq_ids, live),
                     aligned=False):
        return stream_decode_accumulate_plain(q, k_pages, v_pages, seq_ids,
                                              live, m, l, o)
    if (q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype
            or v_pages.dtype != q.dtype):
        raise ValueError(f"{what}: q, k and v must share float32 or bfloat16,"
                         f" got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if (m.dtype != torch.float32 or l.dtype != torch.float32
            or o.dtype != torch.float32):
        raise ValueError(f"{what}: m, l and o must be float32")
    if ((q.data_ptr() | k_pages.data_ptr() | v_pages.data_ptr()
         | o.data_ptr()) % 16 or hd * q.element_size() % 16):
        raise ValueError(f"{what}: q, the pages and o must be 16-byte aligned"
                         f" and head_dim x the element size a multiple of 16"
                         f" bytes, got head_dim {hd}")
    m2, l2, o2 = new_state(b, h, hd, q.device)
    if b == 0:
        return m2, l2, o2
    global _stream_c
    if _stream_c is None:
        _stream_c = _build.bind("bridge_attention",
                                "repro_stream_decode_accumulate", _FIELDS)
    _build.check(_stream_c(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), seq_ids.data_ptr(), live.data_ptr(), m.data_ptr(),
        l.data_ptr(), o.data_ptr(), m2.data_ptr(), l2.data_ptr(),
        o2.data_ptr(), b, h, kv, w, t, hd, hd ** -0.5, _build.stream_of(q)),
        what)
    stream_decode_accumulate.launches += 1
    return m2, l2, o2


stream_decode_accumulate.launches = 0
