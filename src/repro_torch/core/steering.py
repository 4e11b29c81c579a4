"""Request preparation & steering (paper Fig. 1, dotted box).

The port's copy of ``repro.core.steering``:

* ring distances (which request is served by which circuit),
* round/budget splitting (the software rate limiter),
* **route programs** — runtime-reprogrammable circuit schedules (which ring
  offset is wired at which circuit epoch, and in which direction).

A :class:`RouteProgram` is four device tensors of static shape: the control
plane can swap unidirectional, bidirectional, pruned, load-balanced,
link-avoiding and hierarchical programs between steps, and the bridge reads
them on the device, so a swap builds nothing and synchronises nothing.
The constructors compute in numpy on the host and place the result on
``device``.

Key identity the programs exploit: on an N-ring the permutation
``rank -> rank + d (mod N)`` is the same permutation as
``rank -> rank - (N - d) (mod N)``.  Slot ``k`` of the datapath (serving
ring distance ``k + 1``) therefore has two physical realisations: a
clockwise circuit of ``k + 1`` hops or a counter-clockwise circuit of
``N - k - 1`` hops.  The program picks, per slot, the signed offset driven
and the circuit epoch at which the slot is wired.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.memport import FREE
from repro_torch.core.topology import Topology


def ring_distance(home: torch.Tensor, my_rank, num_nodes: int) -> torch.Tensor:
    """Epoch (ring hop count) at which a request to ``home`` is served;
    -1 for a FREE request."""
    d = torch.remainder(home - my_rank, num_nodes)
    return torch.where(home == FREE, -1, d)


def num_rounds(num_requests: int, budget: int, overprovision: int = 1) -> int:
    """Static round count for ``num_requests`` at ``budget`` pages/round,
    times ``overprovision`` (extra rounds that let a throttled rate
    limiter still serve every request)."""
    if num_requests == 0:
        return 0
    return -(-num_requests // max(budget, 1)) * max(overprovision, 1)


def default_route_schedule(num_nodes: int) -> list[int]:
    """Distances wired per slot: one full ring rotation (1 .. N-1).

    Epoch 0 (distance 0) is the local loopback fast path and never uses the
    circuit network.  The runtime schedule — which slot is live, in which
    direction, at which epoch — is a :class:`RouteProgram`.
    """
    return list(range(1, num_nodes))


# ---------------------------------------------------------------------------
# Route programs (runtime circuit schedules)
# ---------------------------------------------------------------------------

def to_device(a, device) -> torch.Tensor:
    """A host array (or sequence) as a tensor on ``device``.  On a CUDA
    device the copy starts without waiting for the work queued on the
    card (an asynchronous copy from pageable memory stages the bytes before
    it returns), so an upload between steps does not synchronise the host
    with the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type == "cpu":
        return t.clone()
    return t.to(device, non_blocking=True)


def to_numpy(x) -> np.ndarray:
    """A tensor on any device (copied to the host), or an array, as a
    numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass(frozen=True)
class RouteProgram:
    """A runtime circuit schedule for an N-node ring bridge.

    All fields have static shapes (one entry per datapath slot; slot ``k``
    serves ring distance ``k + 1``), so swapping programs never changes a
    shape.

    Attributes:
      offsets: i32[N-1]  signed ring offset driven for slot k
        (``offsets[k] % N == k + 1`` when live; sign = direction, magnitude
        = hop count on a flat ring).  0 on dead slots.
      epoch:   i32[N-1]  base circuit epoch of slot k; -1 on dead slots.
      live:    bool[N-1] dead slots carry no traffic: the datapath
        FREE-masks their requests.
      rank_epoch: i32[N-1, N]  the group mask: the epoch at which slot k
        serves requester rank r, or -1 when that pairing is masked off.
    """

    offsets: torch.Tensor
    epoch: torch.Tensor
    live: torch.Tensor
    rank_epoch: torch.Tensor

    @property
    def num_slots(self) -> int:
        return self.offsets.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.num_slots + 1

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def to(self, device) -> "RouteProgram":
        return RouteProgram(*(t.to(device) for t in (
            self.offsets, self.epoch, self.live, self.rank_epoch)))

    # -- host-side accounting (benchmarks / tests) ---------------------------
    def num_epochs(self) -> int:
        """Circuit epochs the program occupies (max served epoch + 1)."""
        served = self.rank_served()
        re = to_numpy(self.rank_epoch)
        return int(re[served].max()) + 1 if served.any() else 0

    def live_distances(self) -> np.ndarray:
        """Ring distances with a wired circuit (sorted)."""
        return np.nonzero(to_numpy(self.live))[0] + 1

    def hops(self) -> np.ndarray:
        """Flat-ring hop count per slot (0 on dead slots)."""
        return np.abs(to_numpy(self.offsets))

    def rank_served(self) -> np.ndarray:
        """bool[N-1, N]: does slot k carry requester rank r's traffic."""
        return to_numpy(self.live)[:, None] & (to_numpy(self.rank_epoch) >= 0)

    def validate(self) -> None:
        """Raise on incongruent offsets or an inconsistent group mask."""
        n = self.num_nodes
        off, lv = to_numpy(self.offsets), to_numpy(self.live)
        d = np.arange(1, n)
        bad = lv & ((off % n) != d)
        if bad.any():
            raise ValueError(
                f"slots {np.nonzero(bad)[0].tolist()} drive offsets "
                f"{off[bad].tolist()} incongruent with their distances")
        re = to_numpy(self.rank_epoch)
        if re.shape != (n - 1, n):
            raise ValueError(f"rank_epoch has shape {re.shape}; expected "
                             f"{(n - 1, n)}")
        ghost = (~lv) & (re >= 0).any(1)
        if ghost.any():
            raise ValueError(f"dead slots {np.nonzero(ghost)[0].tolist()} "
                             "still carry rank epochs")
        idle = lv & ~(re >= 0).any(1)
        if idle.any():
            raise ValueError(f"live slots {np.nonzero(idle)[0].tolist()} "
                             "serve no rank")


def _rank_epoch_from(epoch: np.ndarray, live: np.ndarray) -> np.ndarray:
    """Flat broadcast: slot k serves every rank at its single epoch."""
    n = live.shape[0] + 1
    col = np.where(live, epoch, -1).astype(np.int64)
    return np.repeat(col[:, None], n, axis=1)


def _program(off, epoch, live, rank_epoch=None, *, device) -> RouteProgram:
    if rank_epoch is None:
        rank_epoch = _rank_epoch_from(np.asarray(epoch, np.int64),
                                      np.asarray(live, bool))
    def i32(a):
        return to_device(np.asarray(a, np.int64).astype(np.int32), device)

    return RouteProgram(offsets=i32(off), epoch=i32(epoch),
                        live=to_device(np.asarray(live, bool), device),
                        rank_epoch=i32(rank_epoch))


def unidirectional_program(num_nodes: int, direction: int = 1, *,
                           device="cuda") -> RouteProgram:
    """One full ring rotation in one direction: N-1 circuit epochs.

    ``direction=+1`` drives every circuit clockwise; ``-1`` drives every
    circuit the other way round.
    """
    d = np.arange(1, num_nodes)
    off = d if direction >= 0 else -(num_nodes - d)
    hops = np.abs(off)
    return _program(off, hops - 1, np.ones_like(d, bool), device=device)


def bidirectional_program(num_nodes: int, *, device="cuda") -> RouteProgram:
    """Shortest-way routing: distance d drives min(d, N-d) hops, all N-1
    distances in ⌊N/2⌋ epochs (one circuit per direction per epoch)."""
    d = np.arange(1, num_nodes)
    back = num_nodes - d
    off = np.where(d <= back, d, -back)
    return _program(off, np.abs(off) - 1, np.ones_like(d, bool),
                    device=device)


def pruned_program(base: RouteProgram, live_distances) -> RouteProgram:
    """Keep only ``live_distances``; compact epochs per direction.

    Dead slots are FREE-masked by the datapath (their pages come back as
    zeros).  Surviving flat circuits re-pack into consecutive epochs,
    shortest hop count first, one circuit per direction per epoch.  A
    hierarchical base keeps its group mask instead.  The result lies on
    ``base``'s device.
    """
    n = base.num_nodes
    keep = np.zeros((n - 1,), bool)
    for d in np.asarray(list(live_distances), np.int64).ravel():
        if not 0 < d < n:
            raise ValueError(f"distance {d} out of range for {n} nodes")
        keep[d - 1] = True
    re = to_numpy(base.rank_epoch)
    flat = (re == re[:, :1]).all()  # every row uniform = no group mask
    if not flat:
        return masked_ranks_program(base, np.broadcast_to(keep[:, None],
                                                          re.shape))
    off = to_numpy(base.offsets).copy()
    live = to_numpy(base.live) & keep
    off = np.where(live, off, 0)
    epoch = np.full((n - 1,), -1, np.int64)
    for sign in (1, -1):
        idx = np.nonzero(live & (np.sign(off) == sign))[0]
        order = np.argsort(np.abs(off[idx]), kind="stable")
        epoch[idx[order]] = np.arange(len(idx))
    return _program(off, epoch, live, device=base.device)


def load_balanced_program(num_nodes: int, dist_weight, prune: bool = True, *,
                          device="cuda") -> RouteProgram:
    """Direction assignment minimizing the bottleneck direction's load.

    ``dist_weight[k]`` is the measured traffic carried at ring distance
    ``k + 1``.  Distances are partitioned greedily — heaviest first, each
    onto the currently lighter direction (ties prefer fewer hops).
    Zero-weight distances are pruned (``prune=True``) or kept on their
    shortest-way direction.  Epochs compact per direction, shortest hop
    count first.  Greedy is not optimal: the output is the reference's,
    including where its bottleneck exceeds the bidirectional split's.
    """
    n = num_nodes
    w = np.asarray(dist_weight, float).reshape(-1)
    if w.shape[0] != n - 1:
        raise ValueError(f"dist_weight has {w.shape[0]} entries; a {n}-node "
                         f"ring has {n - 1} distances")
    if (w < 0).any():
        raise ValueError("dist_weight must be non-negative")
    live = (w > 0) if prune else np.ones((n - 1,), bool)
    off = np.zeros((n - 1,), np.int64)
    loads = {1: 0.0, -1: 0.0}
    order = sorted(np.nonzero(live & (w > 0))[0].tolist(),
                   key=lambda k: (-w[k], k))
    for k in order:
        d = k + 1
        if loads[1] < loads[-1]:
            sign = 1
        elif loads[-1] < loads[1]:
            sign = -1
        else:
            sign = 1 if d <= n - d else -1
        off[k] = d if sign == 1 else -(n - d)
        loads[sign] += w[k]
    for k in np.nonzero(live & (w == 0))[0]:
        d = k + 1
        off[k] = d if d <= n - d else -(n - d)
    epoch = np.full((n - 1,), -1, np.int64)
    for sign in (1, -1):
        idx = np.nonzero(live & (np.sign(off) == sign))[0]
        order2 = np.argsort(np.abs(off[idx]), kind="stable")
        epoch[idx[order2]] = np.arange(len(idx))
    return _program(off, epoch, live, device=device)


def link_avoiding_program(num_nodes: int, failed_direction: int, *,
                          device="cuda") -> RouteProgram:
    """Route every circuit away from a failed directed ring link.

    A d-hop circuit in one direction occupies every link of that direction,
    so one failed directed link takes the whole direction down; the other
    direction still reaches every distance.  ``failed_direction`` is +1 (a
    clockwise link died) or -1.
    """
    if failed_direction not in (1, -1):
        raise ValueError("failed_direction must be +1 or -1")
    return unidirectional_program(num_nodes, direction=-failed_direction,
                                  device=device)


# ---------------------------------------------------------------------------
# Hierarchical programs (board + rack tiers)
# ---------------------------------------------------------------------------

def hierarchical_program(topo: Topology, dist_weight=None, prune: bool = False,
                         live_distances=None, intra_weight=None, *,
                         device="cuda") -> RouteProgram:
    """Compile a two-tier circuit schedule for a board + rack fabric.

    Per slot (global ring offset d): its intra-board pairs travel each
    board's local ring concurrently, scheduled like a bidirectional flat
    program (one circuit per direction per epoch, ordered by local hop
    count); its inter-board pairs funnel through the gateways, each such
    slot on an exclusive epoch after the intra phase, ordered by rack hop
    count.  ``rank_epoch[k, r]`` carries the intra epoch for same-board
    requesters and the gateway epoch for board-crossing ones.  Directions
    minimize the latency-weighted hop count over all pairs (or over the
    measured ``dist_weight`` / ``intra_weight`` pages when given).  On a
    flat topology this is :func:`bidirectional_program`'s schedule.

    Args:
      dist_weight: optional measured per-distance loads ([N-1]); with
        ``prune=True``, zero-weight distances are cut.
      live_distances: explicit distance whitelist; overrides the
        weight-based pruning.
      intra_weight: optional measured intra-board share of ``dist_weight``.
    """
    n = topo.num_nodes
    if n < 2:
        raise ValueError("hierarchical programs need at least 2 nodes")
    s = n - 1
    live = np.ones((s,), bool)
    if live_distances is not None:
        live[:] = False
        for d in np.asarray(list(live_distances), np.int64).ravel():
            if not 0 < d < n:
                raise ValueError(f"distance {d} out of range for {n} nodes")
            live[d - 1] = True
    elif dist_weight is not None and prune:
        w = np.asarray(dist_weight, float).reshape(-1)
        if w.shape[0] != s:
            raise ValueError(f"dist_weight has {w.shape[0]} entries; a "
                             f"{n}-node ring has {s} distances")
        if (w < 0).any():
            raise ValueError("dist_weight must be non-negative")
        live = w > 0

    wi = wx = None
    if intra_weight is not None:
        wi = np.asarray(intra_weight, float).reshape(-1)
        if wi.shape[0] != s:
            raise ValueError(f"intra_weight has {wi.shape[0]} entries; a "
                             f"{n}-node ring has {s} distances")
        total = (np.asarray(dist_weight, float).reshape(-1)
                 if dist_weight is not None else wi)
        wx = np.maximum(total - wi, 0.0)

    r = np.arange(n)
    off = np.zeros((s,), np.int64)
    intra_mask = np.zeros((s, n), bool)
    local_hops = np.zeros((s,), np.int64)   # deepest intra circuit per slot
    rack_hops = np.zeros((s,), np.int64)    # deepest rack leg per slot
    for k in np.nonzero(live)[0]:
        d = k + 1
        h = (r + d) % n
        intra = topo.pair_intra(r, h)
        w_intra = float(wi[k]) if wi is not None else float(intra.sum())
        w_inter = float(wx[k]) if wx is not None else float((~intra).sum())
        costs = {}
        for sign in (1, -1):
            bh, rh = topo.pair_hops(r, h, sign)
            us = bh * topo.board_hop_us + rh * topo.rack_hop_us
            cost = 0.0
            if intra.any():
                cost += w_intra * float(us[intra].mean())
            if (~intra).any():
                cost += w_inter * float(us[~intra].mean())
            costs[sign] = cost
        if costs[1] < costs[-1]:
            sign = 1
        elif costs[-1] < costs[1]:
            sign = -1
        else:
            sign = 1 if d <= n - d else -1
        off[k] = d if sign == 1 else -(n - d)
        intra_mask[k] = intra
        bh, rh = topo.pair_hops(r, h, sign)
        local_hops[k] = bh[intra].max() if intra.any() else 0
        rack_hops[k] = rh[~intra].max() if (~intra).any() else 0

    # Intra phase: one circuit per direction per epoch, shallow rings first.
    intra_epoch = np.full((s,), -1, np.int64)
    n_intra = 0
    for sign in (1, -1):
        idx = np.nonzero(live & intra_mask.any(1) & (np.sign(off) == sign))[0]
        order = idx[np.argsort(local_hops[idx], kind="stable")]
        intra_epoch[order] = np.arange(len(order))
        n_intra = max(n_intra, len(order))
    # Gateway phase: one board-crossing slot per epoch, short rack legs first.
    inter_epoch = np.full((s,), -1, np.int64)
    idx = np.nonzero(live & (~intra_mask).any(1))[0]
    order = idx[np.argsort(rack_hops[idx], kind="stable")]
    inter_epoch[order] = n_intra + np.arange(len(order))

    rank_epoch = np.full((s, n), -1, np.int64)
    for k in np.nonzero(live)[0]:
        if intra_epoch[k] >= 0:
            rank_epoch[k, intra_mask[k]] = intra_epoch[k]
        if inter_epoch[k] >= 0:
            rank_epoch[k, ~intra_mask[k]] = inter_epoch[k]
    epoch = np.where(live & (rank_epoch >= 0).any(1),
                     np.where(rank_epoch >= 0, rank_epoch, np.iinfo(np.int64).max
                              ).min(1), -1)
    live = live & (rank_epoch >= 0).any(1)
    off = np.where(live, off, 0)
    return _program(off, epoch, live, rank_epoch, device=device)


def masked_ranks_program(base: RouteProgram, rank_live) -> RouteProgram:
    """Group-mask a program: drop the (slot, requester) pairings where
    ``rank_live`` ([N-1, N] bool) is False.

    The datapath FREE-masks exactly the dropped pairings; slots left serving
    nobody die entirely.  The result lies on ``base``'s device.
    """
    rank_live = np.asarray(rank_live, bool)
    # int64: the int64 max sentinel below would wrap in int32.
    re = to_numpy(base.rank_epoch).astype(np.int64)
    if rank_live.shape != re.shape:
        raise ValueError(f"rank_live has shape {rank_live.shape}; program "
                         f"has {re.shape}")
    re = np.where(rank_live, re, -1)
    live = to_numpy(base.live) & (re >= 0).any(1)
    off = np.where(live, to_numpy(base.offsets), 0)
    epoch = np.where(live,
                     np.where(re >= 0, re, np.iinfo(np.int64).max).min(1), -1)
    return _program(off, epoch, live, re, device=base.device)


def validate_hierarchical(program: RouteProgram, topo: Topology) -> None:
    """Raise unless ``program`` is a sound schedule for ``topo``.

    Beyond :meth:`RouteProgram.validate`: in any epoch at most one slot may
    carry board-crossing traffic, and per direction at most one slot may
    carry intra-board traffic.
    """
    program.validate()
    n = program.num_nodes
    if topo.num_nodes != n:
        raise ValueError(f"topology has {topo.num_nodes} nodes; program has "
                         f"{n}")
    re = to_numpy(program.rank_epoch)
    off = to_numpy(program.offsets)
    served = program.rank_served()
    for e in np.unique(re[served]):
        inter_at_e, intra_cw, intra_ccw = [], [], []
        for k in range(n - 1):
            ranks = np.nonzero(served[k] & (re[k] == e))[0]
            if ranks.size == 0:
                continue
            homes = (ranks + k + 1) % n
            intra = topo.pair_intra(ranks, homes)
            if (~intra).any():
                inter_at_e.append(k)
            if intra.any():
                (intra_cw if off[k] > 0 else intra_ccw).append(k)
        if len(inter_at_e) > 1:
            raise ValueError(
                f"epoch {e}: slots {inter_at_e} all cross boards — they "
                "contend for the gateways")
        for name, group in (("cw", intra_cw), ("ccw", intra_ccw)):
            if len(group) > 1:
                raise ValueError(
                    f"epoch {e}: slots {group} share the {name} board-ring "
                    "links")


def pad_requests(want: np.ndarray, rounds: int, budget: int) -> np.ndarray:
    """Pad a request list to [rounds * budget] with FREE sentinels."""
    out = np.full((rounds * budget,), FREE, dtype=np.int32)
    out[: len(want)] = want
    return out
