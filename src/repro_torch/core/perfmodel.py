"""Analytical model of the bridge datapath.

The port's copy of ``repro.core.perfmodel``.  Two uses:

1. **Paper validation** — reproduce the published prototype numbers from
   first principles: 134-cycle / 800 ns flit round trip, the 1280 MiB/s
   transceiver ceiling of Fig. 3 (the paper computes 10 Gb/s with binary
   prefixes: 10·2^30 b/s ÷ 8 = 1280 MiB/s), STREAM remote *copy* at
   ~562 MiB/s on one core (−47 % vs. local), saturation beyond 2 cores and
   the −25 % penalty for the FLOP-carrying kernels.  These are the paper
   prototype's constants (:data:`PAPER_HW`), kept verbatim.

2. **Device projection** — the same pipeline model with the card's
   constants (:data:`DEVICE_HW`): HBM bandwidth and the bf16 peak from the
   data sheet, and the node axis's link rate and per-hop latency fitted
   from timed transfers on the card (``chip_smoke.py``, phase ``control``)
   — to price bridge rounds for the control plane.

Model: a STREAM-like loop iterates { move B bytes, do F flops } on each of C
masters.  Memory time and compute time do **not** overlap on the in-order A53
prototype (the paper's penalty shrinking from 47 % to 25 % with added FLOPs
pins this), so

    t_iter(location) = B / bw_mem(location, C)  +  F * t_flop
    bw_app = B / t_iter

Remote memory behind the bridge sustains ``outstanding`` cache lines in
flight per master (edge buffering) against an ``rtt`` pipeline, capped by the
serial link:

    bw_mem(remote, C) = min(C * outstanding * line / rtt, link_payload_bw)

Route programs and topologies are the port's; their tensors are read on
the host.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict

import numpy as np

from repro_torch.core import steering
from repro_torch.core.steering import to_numpy

# STREAM kernels: name -> (bytes per iteration, flops per iteration)
STREAM_KERNELS: Dict[str, tuple[int, int]] = {
    "copy": (16, 0),
    "scale": (16, 1),
    "add": (24, 1),
    "triad": (24, 2),
}

MIB = float(1 << 20)




@dataclass(frozen=True)
class BridgeHW:
    """Hardware constants for the pipeline model."""

    clock_mhz: float = 167.5          # bridge clock (134 cyc == 800 ns)
    rtt_cycles: int = 134             # paper: data-flit round trip
    link_gbps_binary: float = 10.0    # serial link, binary-prefix Gb/s
    line_bytes: int = 64              # transfer granule (cache line)
    outstanding: float = 7.37         # in-flight lines/master (edge buffer
                                      # depth; calibrated: 562 MiB/s copy)
    local_bw_per_core_mibps: float = 1060.0  # calibrated: copy −47 % penalty
    local_bw_cap_mibps: float = 3600.0       # DDR ceiling (4 cores)
    flop_time_ns: float = 23.9        # scalar FP chain on the in-order A53
                                      # (calibrated: −25 % scale penalty)

    @property
    def rtt_ns(self) -> float:
        return self.rtt_cycles / self.clock_mhz * 1e3

    @property
    def link_payload_mibps(self) -> float:
        # The paper quotes 10 Gb/s as 10 * 2^30 / 8 bytes/s = 1280 MiB/s.
        return self.link_gbps_binary * 1024.0 / 8.0


PAPER_HW = BridgeHW()


def mem_bandwidth_mibps(hw: BridgeHW, cores: int, remote: bool) -> float:
    """Raw memory-system bandwidth seen by ``cores`` concurrent masters."""
    if remote:
        per_core = hw.outstanding * hw.line_bytes / (hw.rtt_ns * 1e-9) / MIB
        return min(cores * per_core, hw.link_payload_mibps)
    return min(cores * hw.local_bw_per_core_mibps, hw.local_bw_cap_mibps)


def stream_bandwidth_mibps(kernel: str, cores: int, remote: bool,
                           hw: BridgeHW = PAPER_HW) -> float:
    """Application-perceived STREAM bandwidth (the bars of Fig. 3)."""
    bytes_per_iter, flops = STREAM_KERNELS[kernel]
    bw_mem = mem_bandwidth_mibps(hw, cores, remote) * MIB  # B/s, aggregate
    t_mem = bytes_per_iter / (bw_mem / cores)              # per-core share
    t_iter = t_mem + flops * hw.flop_time_ns * 1e-9        # serial (in-order)
    return cores * bytes_per_iter / t_iter / MIB


def stream_table(hw: BridgeHW = PAPER_HW,
                 max_cores: int = 4) -> Dict[str, Dict[str, list[float]]]:
    """Fig. 3 reproduction: kernel -> {local: [c1..c4], remote: [...]}."""
    out: Dict[str, Dict[str, list[float]]] = {}
    for kernel in STREAM_KERNELS:
        out[kernel] = {
            "local": [stream_bandwidth_mibps(kernel, c, False, hw)
                      for c in range(1, max_cores + 1)],
            "remote": [stream_bandwidth_mibps(kernel, c, True, hw)
                       for c in range(1, max_cores + 1)],
        }
    return out


def penalty(kernel: str, cores: int, hw: BridgeHW = PAPER_HW) -> float:
    """Remote-vs-local application penalty (paper: 47 % copy, ~25 % scale)."""
    loc = stream_bandwidth_mibps(kernel, cores, False, hw)
    rem = stream_bandwidth_mibps(kernel, cores, True, hw)
    return 1.0 - rem / loc


# ---------------------------------------------------------------------------
# Latency pipeline breakdown (paper: 134 cycles round trip)
# ---------------------------------------------------------------------------

#: Stage budget for one data-flit round trip, in bridge cycles.  The paper
#: publishes only the total (134); the split below is the prototype's design
#: partition used for the breakdown table in ``benchmarks/bridge_latency.py``.
RTT_PIPELINE_CYCLES: Dict[str, int] = {
    "master mux / edge buffer in": 8,
    "request preparation & steering (memport)": 10,
    "serdes TX (clock-domain cross + 66b encode)": 24,
    "circuit network flight": 12,
    "remote demux / arbiter": 8,
    "remote slave access (DDR)": 30,
    "serdes RX (return path)": 24,
    "reorder / edge buffer out": 10,
    "master channel demux": 8,
}
assert sum(RTT_PIPELINE_CYCLES.values()) == 134


# ---------------------------------------------------------------------------
# Device projection
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DeviceHW:
    """The card's constants for the route model.

    The N memory nodes of the port's bridge are an axis of one device, so
    the "link" and the "hop" are the node axis's: what one circuit moves
    per second and what one ring hop adds to a round trip, as fitted from
    timed transfers.
    """

    # NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core peak and HBM3
    # bandwidth, at the card's 700 W limit.
    peak_bf16_tflops: float = 989.0
    hbm_gbps: float = 3350.0          # GB/s per card
    # The node axis's circuit rate and per-hop latency: the Calibrator's
    # fit of 8-node pulls of 8 x 256 pages timed on the card
    # (chip_smoke.py, phase ``control``; NVIDIA H100 80GB HBM3, 700.00 W).
    # The fit puts 0.9-1.0 ms a round in the per-chunk term (the host's
    # dispatch of a round); beside it these two are not identifiable, and
    # a refit in another call gave other values (PERF.md §6).
    link_gbps: float = 39.697778      # GB/s per circuit per direction
    links: int = 1                    # node-axis paths usable for one
                                      # transfer (one device: one)
    hop_latency_us: float = 6.342474
    outstanding_pages: int = 8        # pages in flight a round (the bridge's
                                      # default round budget)


DEVICE_HW = DeviceHW()


def remote_page_bandwidth_gbps(page_bytes: int, hops: int = 1,
                               hw: DeviceHW = DEVICE_HW) -> float:
    """Pull-mode sustained GB/s per node pair through the bridge."""
    rtt_s = 2 * hops * hw.hop_latency_us * 1e-6
    wire = hw.link_gbps * 1e9  # one circuit = one link direction
    t_page = page_bytes / wire
    # ``outstanding_pages`` in flight against the RTT (edge buffering):
    eff = hw.outstanding_pages * page_bytes / (rtt_s + hw.outstanding_pages * t_page)
    return min(eff, wire) / 1e9


def route_epoch_stats(program) -> Dict[str, int]:
    """Accounting view of a :class:`~repro_torch.core.steering.RouteProgram`.

    ``num_epochs`` is the circuit-switching depth (bidirectional programs
    pair a clockwise and a counter-clockwise circuit per epoch, so it drops
    from N-1 to ⌊N/2⌋); ``total_hops`` drives latency, ``live_slots`` the
    wired-circuit count after pruning.
    """
    live = to_numpy(program.live)
    off = to_numpy(program.offsets)
    hops = np.abs(off)
    return {
        "num_nodes": int(program.num_nodes),
        "num_epochs": int(program.num_epochs()),
        "live_slots": int(live.sum()),
        "cw_slots": int((live & (off > 0)).sum()),
        "ccw_slots": int((live & (off < 0)).sum()),
        "total_hops": int(hops[live].sum()) if live.any() else 0,
        "max_hops": int(hops[live].max()) if live.any() else 0,
    }


def hierarchical_route_stats(program, topology) -> Dict[str, int]:
    """Tier-aware accounting of a program on a board + rack fabric.

    Hop counts follow the :mod:`repro_torch.core.topology` realization contract
    (per served (rank, slot) pairing), so a flat program's topology-blind
    direction choices show up as extra board hops here.
    """
    served = program.rank_served()
    off = to_numpy(program.offsets)
    n = program.num_nodes
    board = rack = 0
    max_board = max_rack = 0
    inter_slots = 0
    for k in range(n - 1):
        ranks = np.nonzero(served[k])[0]
        if ranks.size == 0:
            continue
        homes = (ranks + k + 1) % n
        sign = 1 if off[k] > 0 else -1
        bh, rh = topology.pair_hops(ranks, homes, sign)
        board += int(bh.sum())
        rack += int(rh.sum())
        max_board = max(max_board, int(bh.max()))
        max_rack = max(max_rack, int(rh.max()))
        if (~topology.pair_intra(ranks, homes)).any():
            inter_slots += 1
    return {
        "num_groups": int(topology.num_groups),
        "num_epochs": int(program.num_epochs()),
        "board_hops": board,
        "rack_hops": rack,
        "max_board_hops": max_board,
        "max_rack_hops": max_rack,
        "gateway_slots": inter_slots,
    }


def predict_round_bytes(program, page_bytes: int, budget: int,
                        slot_pages=None) -> float:
    """Wire bytes one bridge round moves under a route program.

    Worst case (every live slot moves ``budget`` pages) or, with
    ``slot_pages``, the measured/intended per-slot loads.  The ref oracle's
    summed ``slot_bytes`` must equal this exactly whenever the request load
    matches ``slot_pages`` — the byte-conservation invariant pinned by
    ``tests/test_perfmodel.py``.
    """
    return float(_slot_loads(program, budget, slot_pages).sum() * page_bytes)


def _slot_loads(program, budget: int, slot_pages):
    live = to_numpy(program.live)
    if slot_pages is None:
        return np.where(live, float(budget), 0.0)
    pages = to_numpy(slot_pages).astype(float).reshape(-1)
    if pages.shape != live.shape:
        raise ValueError(f"slot_pages has shape {pages.shape}; program "
                         f"has {live.shape[0]} slots")
    return np.where(live, pages, 0.0)


def _overlap_round_us(wire_us: float, rtt_us: float, channels: int) -> float:
    """The pipelined round engine's overlap term.

    The serial engine (``channels == 1``) exposes the full wire time *plus*
    the deepest circuit's RTT: the wire idles while the round's last data
    flits fly home, and the RTT idles while the wire drains.  Splitting the
    round into ``channels`` chunks overlaps chunk g+1's request flits with
    chunk g's data flits, so the smaller of (wire, RTT) hides behind the
    larger — except the pipeline's fill and drain, which expose 1/channels
    of the hidden term:

        t(C) = max(wire, rtt) + min(wire, rtt) / C

    ``C=1`` degenerates to ``wire + rtt`` exactly (the classic serial
    model); ``C -> inf`` approaches the fully-overlapped ``max(wire, rtt)``.
    """
    return max(wire_us, rtt_us) + min(wire_us, rtt_us) / max(channels, 1)


def predict_round_latency_us(program, page_bytes: int, budget: int,
                             hw: DeviceHW = DEVICE_HW, edge_buffer: bool = True,
                             slot_pages=None, topology=None,
                             slot_intra_pages=None,
                             channels: int = 1) -> float:
    """Predicted latency of one bridge round under a route program.

    Each live slot is one circuit: RTT = 2 * hops * hop latency, payload =
    ``budget`` pages over one link direction.  Bufferless bridges serialize
    circuits end to end; edge-buffered bridges overlap them, bounded by the
    busier direction's wire occupancy (circuits of one direction share that
    direction's links) plus the deepest circuit's RTT.

    ``channels > 1`` prices the pipelined multi-channel round engine
    (:func:`repro_torch.core.bridge.pull_pages` ``channels=``): the round's RTT
    exposure shrinks by the :func:`_overlap_round_us` overlap term, since
    chunk g+1's request flits fly while chunk g's data flits are still in
    the air.  ``channels=1`` degenerates bit-for-bit to the classic serial
    model, and a bufferless bridge never overlaps (the engine runs serial
    there), so ``edge_buffer=False`` ignores ``channels``.

    ``slot_pages`` switches from the worst-case assumption (every live slot
    moves a full ``budget`` of pages) to *measured* per-slot loads — e.g.
    ``TelemetryAggregator.distance_pages()`` normalized to one round — which
    is what makes a telemetry-compiled
    :func:`~repro_torch.core.steering.load_balanced_program` comparable against
    the static bidirectional split under the observed traffic matrix.

    With a multi-board ``topology`` the model becomes tier-aware (the
    :mod:`repro_torch.core.topology` realization contract):

    * a slot's **intra-board** pages ride that board's local ring — boards
      transfer concurrently, so their wire time divides by the board count
      and is paid at the board-tier link rate;
    * its **board-crossing** pages funnel through the single-ported
      gateways at the rack-tier link rate — their wire time serializes
      across slots;
    * RTTs weight board and rack hops by their own per-hop latencies.

    ``slot_intra_pages`` (e.g. ``TelemetryAggregator.distance_intra_pages``
    normalized like ``slot_pages``) pins the measured tier split; without
    it each slot's load is split by the fraction of its served requester
    ranks whose pair stays on-board.  A flat (single-board) topology —
    or ``topology=None`` — reproduces the classic flat model.
    """
    live = to_numpy(program.live)
    off = to_numpy(program.offsets)
    hops = np.abs(off)
    if not live.any():
        return 0.0
    pages = _slot_loads(program, budget, slot_pages)
    if topology is None or topology.num_groups == 1:
        wire_us = pages * page_bytes / (hw.link_gbps * 1e9) * 1e6
        rtt_us = 2.0 * hops * hw.hop_latency_us
        if not edge_buffer:
            return float((rtt_us[live] + wire_us[live]).sum())
        cw_us = float(wire_us[live & (off > 0)].sum())
        ccw_us = float(wire_us[live & (off < 0)].sum())
        if channels <= 1:
            return float(max(cw_us, ccw_us) + rtt_us[live].max())
        return float(_overlap_round_us(max(cw_us, ccw_us),
                                       float(rtt_us[live].max()), channels))

    n = program.num_nodes
    served = program.rank_served()
    s = n - 1
    if slot_intra_pages is None:
        frac = np.zeros((s,))
        for k in range(s):
            ranks = np.nonzero(served[k])[0]
            if ranks.size:
                frac[k] = topology.pair_intra(
                    ranks, (ranks + k + 1) % n).mean()
        intra_pages = pages * frac
    else:
        intra_pages = np.minimum(
            _slot_loads(program, budget, slot_intra_pages), pages)
    inter_pages = pages - intra_pages
    board_wire = (intra_pages / topology.num_groups * page_bytes
                  / (topology.board_link_gbps * 1e9) * 1e6)
    rack_wire = (inter_pages * page_bytes
                 / (topology.rack_link_gbps * 1e9) * 1e6)
    rtt_us = np.zeros((s,))
    for k in np.nonzero(live)[0]:
        ranks = np.nonzero(served[k])[0]
        if ranks.size == 0:
            continue
        homes = (ranks + k + 1) % n
        sign = 1 if off[k] > 0 else -1
        bh, rh = topology.pair_hops(ranks, homes, sign)
        pair_rtt = bh * topology.board_hop_us + rh * topology.rack_hop_us
        # Only tiers that actually move pages pin the slot's circuit depth
        # (an unloaded gateway pairing costs nothing this round).
        intra = topology.pair_intra(ranks, homes)
        depth = 0.0
        if intra.any() and intra_pages[k] > 0:
            depth = float(pair_rtt[intra].max())
        if (~intra).any() and inter_pages[k] > 0:
            depth = max(depth, float(pair_rtt[~intra].max()))
        rtt_us[k] = 2.0 * depth
    if not edge_buffer:
        return float((rtt_us[live] + board_wire[live]
                      + rack_wire[live]).sum())
    cw_us = float(board_wire[live & (off > 0)].sum())
    ccw_us = float(board_wire[live & (off < 0)].sum())
    if channels <= 1:
        return float(max(cw_us, ccw_us) + rack_wire[live].sum()
                     + rtt_us[live].max())
    # Both tiers' wire occupancy pipelines against the deepest RTT alike.
    return float(_overlap_round_us(
        max(cw_us, ccw_us) + float(rack_wire[live].sum()),
        float(rtt_us[live].max()), channels))


def predict_transfer_latency_us(program, page_bytes: int, budget: int,
                                num_requests: int, hw: DeviceHW = DEVICE_HW,
                                edge_buffer: bool = True, slot_pages=None,
                                topology=None, slot_intra_pages=None,
                                channels: int = 1,
                                overprovision: int = 1) -> float:
    """Predicted completion latency of a whole transfer (all its rounds).

    The bridge serves ``num_requests`` pages per requester in
    ``steering.num_rounds`` rounds of ``budget`` lanes; each round costs
    :func:`predict_round_latency_us` under the given loads.  This is the
    admission-control currency of the orchestrator: a tenant's SLO bounds
    the completion latency of its per-step window, and co-located windows
    shift ``slot_pages``/``num_requests`` — the model prices the shift
    without touching the datapath.
    """
    rounds = steering.num_rounds(num_requests, budget, overprovision)
    if rounds == 0:
        return 0.0
    return rounds * predict_round_latency_us(
        program, page_bytes, budget, hw=hw, edge_buffer=edge_buffer,
        slot_pages=slot_pages, topology=topology,
        slot_intra_pages=slot_intra_pages, channels=channels)


# ---------------------------------------------------------------------------
# Online calibration (measured spans -> fitted constants)
# ---------------------------------------------------------------------------

#: Feature order of :func:`route_features` / :class:`Calibrator.theta`:
#: each coefficient is a physical constant in microseconds (per hop RTT,
#: per wire MiB, per channel chunk, per transfer call).
FEATURE_NAMES = ("board_hop_rtts", "rack_hop_rtts", "wire_mib", "chunks",
                 "transfers")


def route_features(program, page_bytes: int, budget: int, *,
                   rounds: int = 1, channels: int = 1, slot_pages=None,
                   topology=None, slot_intra_pages=None):
    """Linearized route-stats feature vector for one whole transfer.

    The serial analytic model is linear in its hardware constants:
    ``t = hop_latency * (2 * deepest_hops) + (us/MiB) * busier_wire_MiB``.
    This extracts exactly those multiplicities — per tier — plus the two
    software terms the analytic model omits and measurement exposes
    (per channel-chunk dispatch cost, per-call fixed cost):

        x = [ rounds * 2 * deepest board hops,
              rounds * 2 * deepest rack hops,
              rounds * busier-direction wire MiB (board/groups + rack),
              rounds * channels,
              1 ]

    so ``theta . x`` with ``theta = [board_hop_us, rack_hop_us, us_per_mib,
    chunk_us, base_us]`` prices the transfer.  With the static-constant
    prior (:meth:`Calibrator.static_theta`) and ``channels=1`` on a flat
    topology this reproduces ``rounds * predict_round_latency_us`` bit for
    bit — the calibrator *starts* at the static model and RLS walks it to
    the measured one.
    """
    live = to_numpy(program.live)
    off = to_numpy(program.offsets)
    x = np.zeros(len(FEATURE_NAMES))
    x[3] = float(rounds * max(channels, 1))
    x[4] = 1.0
    if not live.any() or rounds == 0:
        x[3] = x[4] = 0.0
        return x
    pages = _slot_loads(program, budget, slot_pages)
    if topology is None or topology.num_groups == 1:
        hops = np.abs(off)
        x[0] = rounds * 2.0 * float(hops[live].max())
        cw = float(pages[live & (off > 0)].sum())
        ccw = float(pages[live & (off < 0)].sum())
        x[2] = rounds * max(cw, ccw) * page_bytes / MIB
        return x
    n = program.num_nodes
    served = program.rank_served()
    s = n - 1
    if slot_intra_pages is None:
        frac = np.zeros((s,))
        for k in range(s):
            ranks = np.nonzero(served[k])[0]
            if ranks.size:
                frac[k] = topology.pair_intra(
                    ranks, (ranks + k + 1) % n).mean()
        intra_pages = pages * frac
    else:
        intra_pages = np.minimum(
            _slot_loads(program, budget, slot_intra_pages), pages)
    inter_pages = pages - intra_pages
    board_deep = rack_deep = 0.0
    for k in np.nonzero(live)[0]:
        ranks = np.nonzero(served[k])[0]
        if ranks.size == 0 or pages[k] == 0:
            continue
        homes = (ranks + k + 1) % n
        sign = 1 if off[k] > 0 else -1
        bh, rh = topology.pair_hops(ranks, homes, sign)
        board_deep = max(board_deep, float(bh.max()))
        rack_deep = max(rack_deep, float(rh.max()))
    x[0] = rounds * 2.0 * board_deep
    x[1] = rounds * 2.0 * rack_deep
    bw = intra_pages / topology.num_groups * page_bytes / MIB
    cw = float(bw[live & (off > 0)].sum())
    ccw = float(bw[live & (off < 0)].sum())
    x[2] = rounds * (max(cw, ccw)
                     + float(inter_pages[live].sum()) * page_bytes / MIB)
    return x


class Calibrator:
    """Recursive-least-squares fit of the bridge's latency constants.

    Observes ``(route_features, measured span latency)`` pairs — the
    tracing plane's fenced wall-clock spans — and maintains
    ``theta = [board_hop_us, rack_hop_us, us_per_wire_MiB, chunk_us,
    base_us]`` with a standard RLS update (optional forgetting factor for
    drift).  ``theta`` starts at the **static** constants of ``hw`` (zero
    software overhead), so an unfitted calibrator degenerates to the
    static model; each observation moves it toward what the fabric
    actually does.

    ``hw()`` repackages the fitted hop latency / payload bandwidth as a
    :class:`DeviceHW`, so the *full* analytic model (tier pricing, overlap
    term) runs with fitted constants — that is what
    ``ControlPlane.select_channels`` and the orchestrator's window refits
    consume each control period, alongside ``chunk_overhead_us`` for the
    dispatch cost the static model never knew about.
    """

    def __init__(self, hw: DeviceHW = DEVICE_HW, *, forgetting: float = 1.0,
                 p0: float = 1e8, min_samples: int = 3):
        self.base_hw = hw
        self.forgetting = float(forgetting)
        self.min_samples = int(min_samples)
        self.theta = self.static_theta(hw)
        self._P = np.eye(len(FEATURE_NAMES)) * float(p0)
        self.samples = 0
        self.last_error_us = 0.0

    @staticmethod
    def static_theta(hw: DeviceHW = DEVICE_HW):
        us_per_mib = MIB / (hw.link_gbps * 1e9) * 1e6
        return np.array([hw.hop_latency_us, hw.hop_latency_us,
                         us_per_mib, 0.0, 0.0])

    # ------------------------------------------------------------------ fit
    def observe(self, features, measured_us: float) -> float:
        """One RLS step; returns the pre-update prediction error (us)."""
        x = np.asarray(features, float).reshape(-1)
        if x.shape[0] != len(FEATURE_NAMES):
            raise ValueError(f"expected {len(FEATURE_NAMES)} features, "
                             f"got {x.shape[0]}")
        lam = self.forgetting
        Px = self._P @ x
        k = Px / (lam + float(x @ Px))
        err = float(measured_us) - float(self.theta @ x)
        self.theta = self.theta + k * err
        self._P = (self._P - np.outer(k, Px)) / lam
        self.samples += 1
        self.last_error_us = err
        return err

    def reset_covariance(self, p0: float = 1e8) -> None:
        """Re-open the RLS gain after detected drift.

        Keeps ``theta`` (the current best fit) but re-inflates the
        covariance, so the next observations move the fit as fast as a
        cold start — a drift sentinel calls this when the windowed
        residual shows the fabric no longer matches the fitted
        constants.
        """
        self._P = np.eye(len(FEATURE_NAMES)) * float(p0)

    @property
    def fitted(self) -> bool:
        return self.samples >= self.min_samples

    # -------------------------------------------------------------- predict
    def predict_us(self, features) -> float:
        return max(float(self.theta @ np.asarray(features, float)), 0.0)

    def static_predict_us(self, features) -> float:
        """Same linear basis priced with the static prior constants."""
        return max(float(self.static_theta(self.base_hw)
                         @ np.asarray(features, float)), 0.0)

    def predict_round_latency_us(self, program, page_bytes: int,
                                 budget: int, **kw) -> float:
        return self.predict_us(route_features(
            program, page_bytes, budget, rounds=1, **kw))

    def predict_transfer_latency_us(self, program, page_bytes: int,
                                    budget: int, num_requests: int,
                                    overprovision: int = 1, **kw) -> float:
        rounds = steering.num_rounds(num_requests, budget, overprovision)
        return self.predict_us(route_features(
            program, page_bytes, budget, rounds=rounds, **kw))

    # ------------------------------------------------------------ constants
    @property
    def chunk_overhead_us(self) -> float:
        return max(float(self.theta[3]), 0.0)

    @property
    def base_overhead_us(self) -> float:
        return max(float(self.theta[4]), 0.0)

    def link_payload_gbps(self) -> float:
        us_per_mib = max(float(self.theta[2]), 1e-9)
        return MIB / (us_per_mib * 1e-6) / 1e9

    def hw(self) -> DeviceHW:
        """Fitted constants as a DeviceHW for the full analytic model."""
        return replace(
            self.base_hw,
            hop_latency_us=max(float(self.theta[0]), 1e-6),
            link_gbps=max(self.link_payload_gbps(), 1e-6))

    def constants(self) -> Dict[str, float]:
        vals = {n: round(float(v), 6)
                for n, v in zip(FEATURE_NAMES, self.theta)}
        vals["link_payload_gbps"] = round(self.link_payload_gbps(), 6)
        vals["samples"] = self.samples
        return vals


def device_stream_penalty(kernel: str, page_bytes: int = 1 << 18,
                          hw: DeviceHW = DEVICE_HW) -> float:
    """Paper Fig. 3 analogue on the card: HBM-local vs bridge-remote
    STREAM."""
    bytes_per_iter, flops = STREAM_KERNELS[kernel]
    local_bw = hw.hbm_gbps * 1e9
    remote_bw = remote_page_bandwidth_gbps(page_bytes, hw=hw) * 1e9
    # Flop time is negligible at STREAM intensity; memory dominates both.
    t_loc = bytes_per_iter / local_bw + flops / (hw.peak_bf16_tflops * 1e12)
    t_rem = bytes_per_iter / remote_bw + flops / (hw.peak_bf16_tflops * 1e12)
    return 1.0 - t_loc / t_rem
