"""Host-side telemetry aggregation (the measure half of the control loop).

The port's copy of ``repro.telemetry.aggregate``.  The datapath emits one
:class:`~repro_torch.telemetry.counters.BridgeTelemetry` per transfer; the
aggregator folds them into exponentially-weighted moving averages that the
control plane reads.  Everything here is plain numpy on the host:
:meth:`TelemetryAggregator.update` copies one step's counters off the
device in one transfer.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Dict

import numpy as np
import torch

from repro_torch.telemetry.counters import (BridgeTelemetry,
                                            DEFAULT_MAX_TENANTS,
                                            num_epoch_bins)


def dominant_requester(traffic: np.ndarray, home: int) -> tuple[int, float]:
    """(remote requester moving the most pages from ``home``, its share of
    all traffic homed there) for a raw ``[N, N]`` requester->home matrix.
    Share is 0 when the home is idle."""
    col = np.asarray(traffic, float)[:, home].copy()
    total = col.sum()
    col[home] = -1.0
    r = int(col.argmax())
    share = float(traffic[r][home] / total) if total > 0 else 0.0
    return r, share


def to_host(telem: BridgeTelemetry) -> BridgeTelemetry:
    """``telem`` with every field an int64 numpy array, copied off the
    device in one transfer; a copy already on the host as given."""
    if not torch.is_tensor(telem.traffic):
        return telem
    names = [f.name for f in fields(telem)]
    parts = [getattr(telem, n) for n in names]
    flat = torch.cat([p.reshape(-1).to(torch.int64) for p in parts]).cpu()
    out, at = {}, 0
    for name, p in zip(names, parts):
        out[name] = flat[at:at + p.numel()].numpy().reshape(tuple(p.shape))
        at += p.numel()
    return BridgeTelemetry(**out)


class TelemetryAggregator:
    """EWMA aggregation of bridge counters across steps.

    Keeps, per step (EWMA with factor ``alpha``; the first update seeds the
    averages directly):

    * the ``[N, N]`` requester->home **traffic matrix** (pages),
    * the per-ring-distance **load histogram** (pages over all requesters),
    * per-direction / per-epoch **wire occupancy** (link utilization),
    * per-node **drop counters**: rate-limiter spills and pruned-circuit
      drops, plus served totals to turn them into rates,
    * per-**tenant** served/spill/prune histograms (summed over requesters)
      — the orchestrator's QoS scheduler re-fits budget shares from the
      measured per-tenant demand.

    ``update`` accepts telemetry whose leading dim is the requester: row i
    is ring node i (N-device path) or logical requester i (loopback path).
    """

    def __init__(self, num_nodes: int, page_bytes: int = 0,
                 alpha: float = 0.25,
                 max_tenants: int = DEFAULT_MAX_TENANTS):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.num_nodes = num_nodes
        self.page_bytes = page_bytes
        self.alpha = alpha
        self.max_tenants = max_tenants
        self.steps = 0
        n, s = num_nodes, max(num_nodes - 1, 0)
        e = num_epoch_bins(n)
        self.traffic = np.zeros((n, n))
        self.dist_pages = np.zeros((s,))
        self.dist_intra = np.zeros((s,))
        self.epoch_cw = np.zeros((e,))
        self.epoch_ccw = np.zeros((e,))
        self.tier_hop_pages = np.zeros((2,))   # (board, rack) page-hops/step
        self.loopback = np.zeros((n,))
        self.served = np.zeros((n,))
        self.spilled = np.zeros((n,))
        self.pruned = np.zeros((n,))
        self.tenant_served = np.zeros((max_tenants,))
        self.tenant_spilled = np.zeros((max_tenants,))
        self.tenant_pruned = np.zeros((max_tenants,))
        # Raw drops of the most recent update (not EWMA-smoothed): the
        # control plane's censorship guard needs "was the LAST measurement
        # clean", which a decaying average can never answer with zero.
        self.last_spilled = np.zeros((n,))
        self.last_pruned = np.zeros((n,))
        # Raw per-tenant counters of the most recent update: the scheduler's
        # work-conserving re-fit keys on the LAST step's demand (served +
        # spilled), which the EWMA would smear across share changes.
        self.last_tenant_served = np.zeros((max_tenants,))
        self.last_tenant_spilled = np.zeros((max_tenants,))

    # -- folding --------------------------------------------------------------
    def _fold(self, avg: np.ndarray, new: np.ndarray) -> None:
        if self.steps == 0:
            avg[...] = new
        else:
            avg *= 1.0 - self.alpha
            avg += self.alpha * new

    def update(self, telem: BridgeTelemetry) -> None:
        """Fold one step's telemetry (leading dim = requester) in."""
        telem = to_host(telem)
        rows = np.atleast_1d(telem.loopback_served).shape[0]
        if rows > self.num_nodes:
            raise ValueError(f"telemetry has {rows} requester rows for a "
                             f"{self.num_nodes}-node aggregator")

        def rowed(x, trailing):
            out = np.zeros((self.num_nodes,) + trailing)
            out[:rows] = np.asarray(x, np.int64).reshape((rows,) + trailing)
            return out

        n, s = self.num_nodes, max(self.num_nodes - 1, 0)
        e = num_epoch_bins(n)
        traffic = rowed(telem.traffic, (telem.traffic.shape[-1],))
        if traffic.shape[1] != n:
            raise ValueError(f"telemetry spans {traffic.shape[1]} homes for "
                             f"a {n}-node aggregator")
        slot = rowed(telem.slot_served, (s,))
        self._fold(self.traffic, traffic)
        self._fold(self.dist_pages, slot.sum(0))
        self._fold(self.dist_intra, rowed(telem.slot_intra, (s,)).sum(0))
        self._fold(self.epoch_cw, rowed(telem.epoch_cw, (e,)).sum(0))
        self._fold(self.epoch_ccw, rowed(telem.epoch_ccw, (e,)).sum(0))
        self._fold(self.tier_hop_pages, rowed(telem.tier_hops, (2,)).sum(0))
        self._fold(self.loopback, rowed(telem.loopback_served, ()))
        self._fold(self.served,
                   rowed(telem.loopback_served, ()) + slot.sum(1))
        self._fold(self.spilled, rowed(telem.spilled, ()))
        self._fold(self.pruned, rowed(telem.pruned, ()))
        t = telem.tenant_served.shape[-1]
        if t != self.max_tenants:
            raise ValueError(f"telemetry attributes {t} tenants for a "
                             f"max_tenants={self.max_tenants} aggregator")
        ten_served = rowed(telem.tenant_served, (t,)).sum(0)
        ten_spilled = rowed(telem.tenant_spilled, (t,)).sum(0)
        self._fold(self.tenant_served, ten_served)
        self._fold(self.tenant_spilled, ten_spilled)
        self._fold(self.tenant_pruned,
                   rowed(telem.tenant_pruned, (t,)).sum(0))
        self.last_tenant_served = ten_served
        self.last_tenant_spilled = ten_spilled
        self.last_spilled = rowed(telem.spilled, ())
        self.last_pruned = rowed(telem.pruned, ())
        self.steps += 1

    # -- views the control plane consumes -------------------------------------
    def traffic_matrix(self) -> np.ndarray:
        """EWMA requester->home pages per step, [N, N]."""
        return self.traffic.copy()

    def traffic_bytes(self) -> np.ndarray:
        return self.traffic * self.page_bytes

    def distance_pages(self) -> np.ndarray:
        """EWMA pages per step carried at each ring distance, [N-1]."""
        return self.dist_pages.copy()

    def distance_bytes(self) -> np.ndarray:
        return self.dist_pages * self.page_bytes

    def live_distances(self) -> list[int]:
        """Ring distances that measurably carried traffic."""
        return (np.nonzero(self.dist_pages > 0)[0] + 1).tolist()

    def link_pages(self) -> Dict[str, float]:
        """EWMA pages per step moved over each ring direction."""
        return {"cw": float(self.epoch_cw.sum()),
                "ccw": float(self.epoch_ccw.sum())}

    def link_utilization(self) -> Dict[str, float]:
        """Each direction's share of circuit-wire pages (0 when idle)."""
        lp = self.link_pages()
        total = lp["cw"] + lp["ccw"]
        if total <= 0:
            return {"cw": 0.0, "ccw": 0.0}
        return {k: v / total for k, v in lp.items()}

    def epoch_occupancy(self) -> tuple[np.ndarray, np.ndarray]:
        """(cw, ccw) EWMA wire pages per circuit epoch."""
        return self.epoch_cw.copy(), self.epoch_ccw.copy()

    # -- the hierarchical (board + rack) views --------------------------------
    def distance_intra_pages(self) -> np.ndarray:
        """EWMA intra-board pages per step at each ring distance, [N-1].

        ``distance_pages() - distance_intra_pages()`` is the board-crossing
        share — the split
        :func:`repro_torch.core.perfmodel.predict_round_latency_us` consumes
        as ``slot_intra_pages``.
        """
        return self.dist_intra.copy()

    def tier_pages(self) -> Dict[str, float]:
        """EWMA circuit pages per step on each fabric tier."""
        intra = float(self.dist_intra.sum())
        return {"board": intra, "rack": float(self.dist_pages.sum()) - intra}

    def tier_hops(self) -> Dict[str, float]:
        """EWMA page-hops per step over each tier's links (wire occupancy)."""
        return {"board": float(self.tier_hop_pages[0]),
                "rack": float(self.tier_hop_pages[1])}

    def tier_utilization(self) -> Dict[str, float]:
        """Each tier's share of page-hops (0 when idle)."""
        th = self.tier_hops()
        total = th["board"] + th["rack"]
        if total <= 0:
            return {"board": 0.0, "rack": 0.0}
        return {k: v / total for k, v in th.items()}

    # -- the multi-tenant views (orchestration plane) --------------------------
    def tenant_pages(self) -> np.ndarray:
        """EWMA pages served per tenant per step, [max_tenants]."""
        return self.tenant_served.copy()

    def tenant_bytes(self) -> np.ndarray:
        return self.tenant_served * self.page_bytes

    def tenant_demand(self) -> np.ndarray:
        """LAST step's offered load per tenant (served + spilled pages).

        Raw, not EWMA: the scheduler's work-conserving re-fit needs the
        demand under the *current* share split — a smoothed average would
        keep crediting a tenant for traffic it stopped offering.
        """
        return self.last_tenant_served + self.last_tenant_spilled

    def tenant_spill_rate(self) -> np.ndarray:
        """Per-tenant fraction of offered pages the rate limiter dropped."""
        total = self.tenant_served + self.tenant_spilled
        return np.divide(self.tenant_spilled, total,
                         out=np.zeros_like(total), where=total > 0)

    def spill_rate(self) -> np.ndarray:
        """Per-node fraction of live requests the rate limiter dropped."""
        total = self.served + self.spilled
        return np.divide(self.spilled, total, out=np.zeros_like(total),
                         where=total > 0)

    def drop_rate(self) -> np.ndarray:
        """Per-node fraction of live requests dropped (spill + prune)."""
        drops = self.spilled + self.pruned
        total = self.served + drops
        return np.divide(drops, total, out=np.zeros_like(drops),
                         where=total > 0)

    def dominant_requester(self, home: int) -> tuple[int, float]:
        """(remote requester moving the most pages from ``home``, its share
        of all traffic homed there).  Share is 0 when the home is idle."""
        return dominant_requester(self.traffic, home)

    def describe(self) -> str:
        util = self.link_utilization()
        tier = self.tier_utilization()
        lines = [f"telemetry: {self.steps} steps folded "
                 f"(alpha={self.alpha}, page_bytes={self.page_bytes})",
                 f"  wire share: cw={util['cw']:.2f} ccw={util['ccw']:.2f}",
                 f"  tier share: board={tier['board']:.2f} "
                 f"rack={tier['rack']:.2f}",
                 "  dist pages: " + " ".join(
                     f"d{d}={p:.1f}" for d, p in
                     enumerate(self.dist_pages, start=1) if p > 0)]
        if self.tenant_served.sum() + self.tenant_spilled.sum() > 0:
            lines.append("  tenants: " + " ".join(
                f"t{t}={s:.1f}/{sp:.1f}sp" for t, (s, sp) in
                enumerate(zip(self.tenant_served, self.tenant_spilled))
                if s + sp > 0))
        for i in range(self.num_nodes):
            lines.append(
                f"  node {i}: served={self.served[i]:.1f} "
                f"loopback={self.loopback[i]:.1f} "
                f"spilled={self.spilled[i]:.1f} pruned={self.pruned[i]:.1f}")
        return "\n".join(lines)

