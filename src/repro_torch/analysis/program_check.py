"""Pure-static verifier for RouteProgram / Topology pairs.

The port's copy of ``repro.analysis.program_check``: it proves, without
running the datapath, that a route program is a sound circuit schedule.
Every invariant here is one the runtime oracle
(:func:`repro_torch.core.ref.expected_transfer_telemetry`) or the bridge
would otherwise only reveal as silently dropped pages, double-served
pairs, gateway contention, or an out-of-range telemetry bin.

A port :class:`~repro_torch.core.steering.RouteProgram` holds device
tensors: each check copies its four arrays (``offsets``, ``epoch``,
``live``, ``rank_epoch``) to the host once, then works in plain numpy
with the static topology.

Rule catalog (the reference's ids and messages):

  PC101  rank-epoch-shape      group mask is not [N-1, N]
  PC102  offset-incongruent    live slot drives an offset whose permutation
                               is not its ring distance
  PC103  offset-range          live slot offset 0 or |offset| outside 1..N-1
  PC104  dead-slot-residue     dead slot still carries offset/epoch/ranks
  PC105  idle-live-slot        live slot serves no rank (FREE-mask vs live
                               mask inconsistent)
  PC106  epoch-mismatch        slot's base epoch is not its earliest served
                               rank epoch
  PC107  epoch-out-of-range    a served rank epoch outside [0, 2(N-1)) —
                               the telemetry histograms would clip
  PC108  gateway-contention    two slots carry board-crossing pairs in one
                               epoch (gateways are single-ported)
  PC109  ring-link-contention  two same-direction slots carry intra-board
                               pairs in one epoch (they share the ring links)
  PC110  coverage-gap          a required (requester, distance) pair is not
                               wired (exactly-once coverage)
  PC111  budget-window         transfer window insane (budget < 1,
                               active_budget outside [0, budget], ...)

:func:`coverage` is the static analogue of
:func:`repro_torch.core.ref.served_mask`: the two agree on every program,
which is what makes a clean :func:`check_program` verdict a *proof* that
the runtime oracle cannot prune a covered pair.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.analysis.findings import (WARNING, Finding,
                                           ProgramVerificationError, errors)
from repro_torch.core.steering import to_numpy

__all__ = ["check_program", "check_transfer_window", "coverage",
           "verify_program"]


def _epoch_bins(num_nodes: int) -> int:
    """Static epoch-histogram length.  Mirrors
    ``repro_torch.telemetry.counters.num_epoch_bins``."""
    return 2 * max(num_nodes - 1, 0)


def _fields(program):
    """The program's four arrays on the host (one copy each)."""
    off = to_numpy(program.offsets).astype(np.int64)
    epoch = to_numpy(program.epoch).astype(np.int64)
    live = to_numpy(program.live).astype(bool)
    rank_epoch = to_numpy(program.rank_epoch).astype(np.int64)
    return off, epoch, live, rank_epoch


def coverage(program) -> np.ndarray:
    """bool[N-1, N]: does slot k carry requester rank r's traffic.

    The static serve set — exactly what
    :func:`repro_torch.core.ref.served_mask` answers per request at run
    time: a remote (requester r, distance k+1)
    pair is served iff ``live[k] & rank_epoch[k, r] >= 0``.  (Distance 0,
    the loopback fast path, never touches the program.)
    """
    off, epoch, live, rank_epoch = _fields(program)
    n = off.shape[0] + 1
    if rank_epoch.shape != (n - 1, n):
        # shape is itself a finding (PC101); report no coverage rather
        # than index out of bounds here.
        return np.zeros((n - 1, n), bool)
    return live[:, None] & (rank_epoch >= 0)


def check_program(program, topology=None, *,
                  required_pairs: Optional[np.ndarray] = None
                  ) -> List[Finding]:
    """Statically verify a route program against a fabric.

    Args:
      program: any :class:`~repro_torch.core.steering.RouteProgram`-shaped
        object (tensors on any device, or numpy arrays — duck-typed).
      topology: the :class:`~repro_torch.core.topology.Topology` the
        program will drive; ``None`` means the flat single-board ring
        (every pair intra-board, no gateways).
      required_pairs: optional bool[N-1, N] — the (slot, rank) pairs that
        *must* be wired (e.g. from placement reachability).  Uncovered
        required pairs are PC110 findings; ``None`` skips the coverage
        check (pruned/masked programs drop pairs by design).

    Returns a list of :class:`Finding`; empty = verified sound.
    """
    out: List[Finding] = []
    off, epoch, live, rank_epoch = _fields(program)
    s = off.shape[0]
    n = s + 1
    where = "program"

    if rank_epoch.shape != (s, n):
        out.append(Finding(
            "PC101", f"rank_epoch has shape {rank_epoch.shape}; a {n}-node "
            f"ring needs {(s, n)}", path=where))
        return out  # every later check indexes the group mask

    d = np.arange(1, n)
    # PC103 first: congruence (PC102) is meaningless for out-of-range
    # offsets, so report each bad slot under exactly one rule.
    bad_range = live & ((off == 0) | (np.abs(off) > s))
    for k in np.nonzero(bad_range)[0]:
        out.append(Finding(
            "PC103", f"live slot {k} drives offset {off[k]}; a {n}-node "
            f"ring only realizes 1 <= |offset| <= {s}", path=where))
    bad_cong = live & ~bad_range & ((off % n) != d)
    for k in np.nonzero(bad_cong)[0]:
        out.append(Finding(
            "PC102", f"slot {k} serves ring distance {k + 1} but drives "
            f"offset {off[k]} (permutation rank->rank{off[k]:+d} is "
            f"distance {off[k] % n})", path=where))

    # FREE-mask conservation: dead slots must be fully FREE (the datapath
    # masks their requests; leftover state would leak into telemetry),
    # live slots must serve somebody.
    ghost = ~live & ((off != 0) | (epoch != -1) | (rank_epoch >= 0).any(1))
    for k in np.nonzero(ghost)[0]:
        out.append(Finding(
            "PC104", f"dead slot {k} still carries state (offset {off[k]}, "
            f"epoch {epoch[k]}, "
            f"{int((rank_epoch[k] >= 0).sum())} rank pairings)", path=where))
    idle = live & ~(rank_epoch >= 0).any(1)
    for k in np.nonzero(idle)[0]:
        out.append(Finding(
            "PC105", f"live slot {k} serves no rank (every pairing is "
            "FREE-masked); it should be dead", path=where))

    served = live[:, None] & (rank_epoch >= 0)
    # Base epoch must be the slot's earliest served epoch (the datapath
    # and the perfmodel order circuits by it).
    for k in np.nonzero(live & served.any(1))[0]:
        lo = int(rank_epoch[k][served[k]].min())
        if int(epoch[k]) != lo:
            out.append(Finding(
                "PC106", f"slot {k} base epoch {int(epoch[k])} != earliest "
                f"served rank epoch {lo}", path=where))

    # Epoch bin range: the telemetry histograms are statically sized to
    # 2(N-1) bins; a larger epoch IndexErrors the oracle and silently
    # clips on the device.
    bins = _epoch_bins(n)
    over = served & (rank_epoch >= bins)
    for k in np.nonzero(over.any(1))[0]:
        out.append(Finding(
            "PC107", f"slot {k} schedules epochs "
            f"{sorted(set(rank_epoch[k][over[k]].tolist()))} beyond the "
            f"static {bins}-bin telemetry range", path=where))
    under = live[:, None] & (rank_epoch < -1)
    for k in np.nonzero(under.any(1))[0]:
        out.append(Finding(
            "PC107", f"slot {k} carries rank epochs < -1 "
            f"({sorted(set(rank_epoch[k][under[k]].tolist()))}); -1 is the "
            "only FREE sentinel", path=where))

    # Epoch exclusivity on the physical fabric: per epoch, at most one
    # board-crossing slot (gateway is single-ported) and at most one
    # intra-board slot per direction (same-direction circuits share every
    # directed board-ring link).  topology=None is the flat ring: every
    # pair is intra-board, so PC109 alone enforces the flat
    # one-circuit-per-direction-per-epoch rule.
    r = np.arange(n)
    valid_epochs = rank_epoch[served & (rank_epoch < bins) & (rank_epoch >= 0)]
    for e in np.unique(valid_epochs):
        inter_at_e, intra_cw, intra_ccw = [], [], []
        for k in range(s):
            ranks = np.nonzero(served[k] & (rank_epoch[k] == e))[0]
            if ranks.size == 0:
                continue
            homes = (ranks + k + 1) % n
            if topology is None:
                intra = np.ones(ranks.shape, bool)
            else:
                intra = np.asarray(topology.pair_intra(ranks, homes), bool)
            if (~intra).any():
                inter_at_e.append(k)
            if intra.any():
                (intra_cw if off[k] > 0 else intra_ccw).append(k)
        if len(inter_at_e) > 1:
            out.append(Finding(
                "PC108", f"epoch {int(e)}: slots {inter_at_e} all carry "
                "board-crossing pairs — they contend for the gateways",
                path=where))
        for name, group in (("cw", intra_cw), ("ccw", intra_ccw)):
            if len(group) > 1:
                out.append(Finding(
                    "PC109", f"epoch {int(e)}: slots {group} share the "
                    f"{name} board-ring links", path=where))

    # Exactly-once pair coverage against a required serve set.  "At most
    # once" is structural (one epoch per (slot, rank) cell); this closes
    # the "at least once" half.
    if required_pairs is not None:
        req = np.asarray(required_pairs, bool)
        if req.shape != (s, n):
            out.append(Finding(
                "PC101", f"required_pairs has shape {req.shape}; expected "
                f"{(s, n)}", path=where))
        else:
            gap = req & ~served
            for k in np.nonzero(gap.any(1))[0]:
                out.append(Finding(
                    "PC110", f"slot {k} (distance {k + 1}) does not serve "
                    f"required requesters "
                    f"{np.nonzero(gap[k])[0].tolist()}", path=where))

    if topology is not None and getattr(topology, "num_nodes", n) != n:
        out.append(Finding(
            "PC101", f"topology has {topology.num_nodes} nodes; program "
            f"has {n}", path=where))
    return out


def check_transfer_window(num_requests: int, budget: int,
                          active_budget=None, overprovision: int = 1
                          ) -> List[Finding]:
    """Budget-window sanity for one transfer call (PC111).

    The datapath clamps everything into range at runtime; these findings
    catch callers whose *intent* cannot be honoured — a raised
    ``active_budget`` that silently clips back to ``budget``, a window
    that guarantees spill, a zero-lane budget.
    """
    out: List[Finding] = []
    where = "transfer-window"
    if budget < 1:
        out.append(Finding(
            "PC111", f"budget {budget} < 1: every request spills", path=where))
        return out
    if overprovision < 1:
        out.append(Finding(
            "PC111", f"overprovision {overprovision} < 1 (clamps to 1)",
            path=where, severity=WARNING))
    if active_budget is not None:
        ab = to_numpy(active_budget).astype(np.int64).reshape(-1)
        if (ab < 0).any():
            out.append(Finding(
                "PC111", f"active_budget {ab.tolist()} negative (clamps "
                "to 0: the node transfers nothing)", path=where))
        if (ab > budget).any():
            out.append(Finding(
                "PC111", f"active_budget {ab.tolist()} above the static "
                f"budget {budget}: the datapath clamps it back — raising "
                "throughput needs a recompile with a larger budget",
                path=where))
        # Guaranteed spill is a warning: the rate limiter throttles by
        # design, but a caller should know the window cannot fit.
        rounds = -(-num_requests // budget) * max(overprovision, 1)
        short = ab[(ab >= 0) & (ab <= budget)]
        if num_requests > 0 and short.size and \
                int(short.min()) * rounds < num_requests:
            out.append(Finding(
                "PC111", f"window rounds({rounds}) x active_budget"
                f"({int(short.min())}) < {num_requests} requests: the tail "
                "spills every round", path=where, severity=WARNING))
    return out


def verify_program(program, topology=None, *,
                   required_pairs: Optional[np.ndarray] = None) -> None:
    """Raise :class:`ProgramVerificationError` unless the program checks
    clean (warnings do not gate)."""
    bad = errors(check_program(program, topology,
                               required_pairs=required_pairs))
    if bad:
        raise ProgramVerificationError(bad)

