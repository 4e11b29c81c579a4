"""Synthetic deterministic data pipeline with host-side prefetch.

The port's own copy of ``repro.data.pipeline`` (numpy, no JAX): batch ``i``
is a pure function of (seed, i) — restart-safe (resume from any step
reproduces the stream) and the same numpy arrays, bit for bit, as the
reference's.  A background thread keeps a bounded queue of ready batches.
:func:`to_device` moves a batch onto the card without waiting for it.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.config import ModelConfig


class SyntheticLM:
    """Markov-ish synthetic token stream (not iid: next-token structure
    exists, so training losses actually fall)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, enc_len: int = 64):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.enc_len = enc_len

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        v = self.cfg.vocab_size
        b, s = self.batch, self.seq_len
        # structured stream: tok_{t+1} = (a * tok_t + drift) % v with noise
        a = 6364136223846793005
        start = rng.integers(0, v, size=(b, 1))
        drift = rng.integers(1, 97, size=(b, 1))
        idx = np.arange(s + 1)[None, :]
        toks = (start + drift * idx + (a * idx ** 2) % 31) % v
        noise = rng.integers(0, v, size=(b, s + 1))
        flip = rng.random((b, s + 1)) < 0.05
        toks = np.where(flip, noise, toks).astype(np.int32)
        out: dict[str, np.ndarray] = {"labels": toks[:, 1:]}
        if self.cfg.embed_inputs:
            emb_rng = np.random.default_rng((self.seed, step, 7))
            out["embeds"] = emb_rng.normal(
                size=(b, s, self.cfg.d_model)).astype(np.float32)
        else:
            out["tokens"] = toks[:, :-1]
        if self.cfg.num_encoder_layers > 0:
            enc_rng = np.random.default_rng((self.seed, step, 11))
            out["enc_embeds"] = enc_rng.normal(
                size=(b, self.enc_len, self.cfg.d_model)).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Bounded background prefetch queue over any batch iterator."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def to_device(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (the reference's
    ``jnp.asarray`` of each array), copied without a host sync."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, non_blocking=True) for k, v in batch.items()}
