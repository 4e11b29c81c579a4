"""Synthetic request-level traffic: seeded arrivals with heavy tails (the
port's copy of ``repro.serve.traffic``, draw for draw).

The ROADMAP's "millions of users" scenario needs demand the orchestrator
can believe in: requests arrive *over time* (not one fixed batch), per
tenant, with the length statistics real serving fleets see — most prompts
short, a heavy Pareto tail of huge ones, and output lengths with the same
shape.  This module generates that demand deterministically:

* **Poisson arrivals** per tenant per step (``rate`` = expected requests
  per step), optionally windowed (``start_step`` / ``stop_step``) so a
  batch tenant can *flood* the queue mid-run — the noisy-neighbour
  scenario the QoS batcher must survive;
* **bounded-Pareto (Lomax) lengths**: ``mean`` sets the body, ``tail``
  the Pareto shape (smaller = heavier tail), ``max`` the hard cap —
  plus an optional fixed burst of oversized "whale" requests to exercise
  admission shedding;
* **full determinism**: every draw comes from a generator seeded by
  ``(seed, tenant_id, step)``, so the trace for a step is a pure function
  of the config — two runs (or the solo/QoS/naive comparison runs of the
  serve bench) see byte-identical request streams regardless of how many
  other tenants are mixed in.

Requests carry concrete prompt *token ids* so the same stream can drive
the real-model decode engine (bit-exactness fidelity runs) or the
host-side simulation (fleet-scale latency runs) unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np


@dataclass(frozen=True)
class Request:
    """One serving request: a prompt to prefill, a length to decode."""

    req_id: int
    tenant_id: int
    arrive_step: int
    prompt: tuple            # token ids, length >= 1
    output_len: int          # tokens to generate (>= 1)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + self.output_len

    def num_pages(self, page_tokens: int) -> int:
        """Pooled pages the sequence pins for its whole lifetime."""
        if page_tokens <= 0:
            return 0
        return -(-self.total_tokens // page_tokens)


@dataclass(frozen=True)
class TenantTraffic:
    """One tenant's offered load (all knobs of the synthetic generator).

    Attributes:
      rate: expected arrivals per step (Poisson).
      prompt_mean / output_mean: body of the length distributions.
      tail: Pareto shape of both length tails (> 1; smaller = heavier).
      prompt_max / output_max: hard caps (bounded Pareto).
      start_step / stop_step: arrival window (stop < 0 = never stops) —
        a late ``start_step`` with a huge ``rate`` is a flood.
      vocab: prompt token ids draw uniformly from [1, vocab).
    """

    tenant_id: int
    rate: float
    prompt_mean: int = 32
    output_mean: int = 16
    tail: float = 2.5
    prompt_max: int = 512
    output_max: int = 256
    start_step: int = 0
    stop_step: int = -1
    vocab: int = 32000

    def __post_init__(self) -> None:
        if self.rate < 0:
            raise ValueError(f"rate must be >= 0, got {self.rate}")
        if self.tail <= 1.0:
            raise ValueError(f"tail must be > 1 (finite mean), "
                             f"got {self.tail}")
        if min(self.prompt_mean, self.output_mean) < 1:
            raise ValueError("prompt_mean/output_mean must be >= 1")


def _heavy_len(rng: np.random.Generator, mean: int, tail: float,
               cap: int) -> int:
    """Bounded Lomax draw with expectation ~``mean``: 1 + Pareto body."""
    body = mean * (tail - 1.0) * rng.pareto(tail)
    return int(np.clip(1 + np.floor(body), 1, max(cap, 1)))


class TrafficGenerator:
    """Deterministic per-step arrival stream over a tenant mix.

    ``arrivals(step)`` must be called with non-decreasing steps (request
    ids are minted monotonically); the *content* of a step's arrivals is
    a pure function of ``(seed, tenant_id, step)``.
    """

    def __init__(self, traffic: Sequence[TenantTraffic], seed: int = 0):
        ids = [t.tenant_id for t in traffic]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate tenant ids in traffic mix: {ids}")
        self.traffic = tuple(traffic)
        self.seed = seed
        self._next_req = 0
        self.generated: Dict[int, int] = {t.tenant_id: 0 for t in traffic}

    def _step_rng(self, tenant_id: int, step: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, tenant_id, step])

    def arrivals(self, step: int) -> List[Request]:
        """All requests arriving at ``step``, tenant-id order."""
        out: List[Request] = []
        for t in sorted(self.traffic, key=lambda t: t.tenant_id):
            if step < t.start_step:
                continue
            if 0 <= t.stop_step <= step:
                continue
            rng = self._step_rng(t.tenant_id, step)
            for _ in range(int(rng.poisson(t.rate))):
                plen = _heavy_len(rng, t.prompt_mean, t.tail, t.prompt_max)
                olen = _heavy_len(rng, t.output_mean, t.tail, t.output_max)
                prompt = tuple(
                    int(x) for x in rng.integers(1, t.vocab, size=plen))
                out.append(Request(req_id=self._next_req,
                                   tenant_id=t.tenant_id,
                                   arrive_step=step, prompt=prompt,
                                   output_len=olen))
                self._next_req += 1
                self.generated[t.tenant_id] += 1
        return out

    def total_generated(self) -> int:
        return self._next_req


def make_request(req_id: int, tenant_id: int, *, prompt_len: int,
                 output_len: int, arrive_step: int = 0, seed: int = 0,
                 vocab: int = 32000) -> Request:
    """One explicit request with a seeded prompt (tests, whale requests)."""
    rng = np.random.default_rng([seed, req_id])
    prompt = tuple(int(x) for x in rng.integers(1, vocab,
                                                size=max(prompt_len, 1)))
    return Request(req_id=req_id, tenant_id=tenant_id,
                   arrive_step=arrive_step, prompt=prompt,
                   output_len=max(output_len, 1))
