"""In-band datapath counters for the bridge (the measurement plane).

The port's copy of ``repro.telemetry.counters``.  A
:class:`BridgeTelemetry` holds masked integer sums computed from the masks
the transfer engine already builds (request liveness, the rate-limiter
window, the ring distance, the route program's liveness and its per-rank
group mask), so collecting it launches none of the port's kernels, has
static shapes (``N-1`` slots, ``N`` homes, ``2(N-1)`` epochs), and is
exactly reproducible by the host oracle
(:func:`repro_torch.core.ref.expected_transfer_telemetry`).

Counter semantics for one requester's (padded) request list:

* a request is **live** if its id is non-FREE and its page is mapped;
* live requests past the rate-limiter window (``rounds * active_budget``
  round lanes) are **spilled**;
* in-window live requests at ring distance 0 are **loopback** hits;
* remote requests whose distance has no wired circuit, or whose (rank,
  slot) pairing the program's group mask cut, are **pruned** drops;
* everything else is **served** by its circuit slot: the per-slot counts,
  the requester->home traffic row, the per-epoch cw/ccw wire occupancy (at
  the epoch the program assigns this requester) and the per-tier
  occupancy under the :mod:`repro_torch.core.topology` realization
  contract.

Each outcome (served, spilled, pruned) is also binned per tenant from a
tenant-id lane aligned with the requests (ids clip into ``[0,
max_tenants)``; no lane means every request is tenant 0), so the tenant
sums always reconcile with the untagged counters.

:func:`transfer_telemetry` serves every requester row of a transfer with
one set of tensor ops (the reference maps it over requesters): every
``.at[i].add(1, mode="drop")`` of the reference is a ``scatter_add_`` into
a ``[rows, n + 1]`` int32 buffer whose last bin is dropped.  Nothing reads
a value back to the host (no ``bincount``, no boolean-mask indexing).
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import InitVar, dataclass, fields
from typing import Optional

import torch

from repro_torch.core.memport import MemPortTable
from repro_torch.core.steering import RouteProgram


def num_epoch_bins(num_nodes: int) -> int:
    """Static epoch-histogram length: a hierarchical schedule uses at most
    (G-1) intra epochs + (N-1) gateway epochs <= 2(N-1)."""
    return 2 * max(num_nodes - 1, 0)


#: Default static width of the per-tenant attribution histograms.
DEFAULT_MAX_TENANTS = 4


def _sum_last(x):
    """Sum over the last axis: int32 on a tensor, the array's own integer
    type on a host copy (:func:`~repro_torch.telemetry.aggregate.to_host`),
    so the methods below serve both."""
    if torch.is_tensor(x):
        return x.sum(-1, dtype=torch.int32)
    return x.sum(-1)


@dataclass(frozen=True)
class BridgeTelemetry:
    """Per-requester bridge counters, int32 tensors with static trailing
    shapes for an N-node ring; the leading dims identify the requester
    (``[N, ...]`` from the N-node path, ``[rows, ...]`` from the loopback
    path).  Counts are pages.  Field meanings as in the reference."""

    slot_served: torch.Tensor      # i32[..., N-1]
    loopback_served: torch.Tensor  # i32[...]
    spilled: torch.Tensor          # i32[...]
    pruned: torch.Tensor           # i32[...]
    traffic: torch.Tensor          # i32[..., N]
    epoch_cw: torch.Tensor         # i32[..., 2(N-1)]
    epoch_ccw: torch.Tensor        # i32[..., 2(N-1)]
    slot_intra: torch.Tensor       # i32[..., N-1]
    tier_hops: torch.Tensor        # i32[..., 2]
    tenant_served: torch.Tensor    # i32[..., max_tenants]
    tenant_spilled: torch.Tensor   # i32[..., max_tenants]
    tenant_pruned: torch.Tensor    # i32[..., max_tenants]
    # (buffer, layout) when the fields are views of one flat buffer (not a
    # field: what the counters are does not depend on it)
    flat: InitVar[Optional[tuple]] = None

    def __post_init__(self, flat):
        object.__setattr__(self, "_flat", flat)

    @property
    def num_nodes(self) -> int:
        return self.traffic.shape[-1]

    @property
    def max_tenants(self) -> int:
        return self.tenant_served.shape[-1]

    def served_total(self) -> torch.Tensor:
        """Pages served per requester (loopback + all circuit slots)."""
        return self.loopback_served + _sum_last(self.slot_served)

    def wire_pages(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(cw, ccw) pages moved over each ring direction per requester."""
        return _sum_last(self.epoch_cw), _sum_last(self.epoch_ccw)

    def slot_bytes(self, page_bytes: int) -> torch.Tensor:
        """Per-slot wire bytes (static page size x served counts)."""
        return self.slot_served * page_bytes

    def tier_pages(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(intra-board, inter-board) circuit pages per requester."""
        intra = _sum_last(self.slot_intra)
        return intra, _sum_last(self.slot_served) - intra

    def tenant_bytes(self, page_bytes: int) -> torch.Tensor:
        """Per-tenant wire+loopback bytes (static page size x served)."""
        return self.tenant_served * page_bytes


@functools.lru_cache(maxsize=None)
def _layout(num_nodes: int, max_tenants: int) -> tuple:
    """The fields' widths in the flat ``[..., F]`` buffer that holds one
    telemetry's counters, in field order (None for a per-row scalar), and
    each field's offset by name."""
    s = max(num_nodes - 1, 0)
    e = num_epoch_bins(num_nodes)
    widths = (s, None, None, None, num_nodes, e, e, s, 2, max_tenants,
              max_tenants, max_tenants)
    names = [f.name for f in fields(BridgeTelemetry)]
    offsets = dict(zip(names, itertools.accumulate(
        (1 if w is None else w for w in widths), initial=0)))
    return widths, offsets


def _size(layout: tuple) -> int:
    return layout[1]["tenant_pruned"] + layout[0][-1]


def _unflatten(flat: torch.Tensor, layout: tuple) -> BridgeTelemetry:
    """The counters as views of one flat buffer, which they keep: adding
    two such telemetries is one addition."""
    widths = layout[0]
    parts = flat.split([1 if w is None else w for w in widths], -1)
    return BridgeTelemetry(*(p.squeeze(-1) if w is None else p
                             for p, w in zip(parts, widths)),
                           flat=(flat, layout))


def zeros(num_nodes: int, leading: tuple[int, ...] = (),
          max_tenants: int = DEFAULT_MAX_TENANTS, *,
          device="cuda") -> BridgeTelemetry:
    """All-zero telemetry for an N-node ring (accumulator seed)."""
    layout = _layout(num_nodes, max_tenants)
    return _unflatten(torch.zeros(tuple(leading) + (_size(layout),),
                                  dtype=torch.int32, device=device), layout)


def add(a: BridgeTelemetry, b: BridgeTelemetry) -> BridgeTelemetry:
    """Element-wise sum (counters are additive across transfers/steps)."""
    fa, fb = a._flat, b._flat
    if fa is not None and fb is not None and fa[1] == fb[1]:
        return _unflatten(fa[0] + fb[0], fa[1])
    return BridgeTelemetry(*(getattr(a, f.name) + getattr(b, f.name)
                             for f in fields(a)))


def transfer_telemetry(ids: torch.Tensor, table: MemPortTable,
                       program: Optional[RouteProgram],
                       active_budget: torch.Tensor, *, my: torch.Tensor,
                       num_nodes: int, budget: int, rounds: int,
                       pairs: Optional[torch.Tensor],
                       tenant_ids: Optional[torch.Tensor] = None,
                       max_tenants: int = DEFAULT_MAX_TENANTS,
                       home: Optional[torch.Tensor] = None
                       ) -> BridgeTelemetry:
    """Counters of every requester row of one transfer (pull or push).

    Every request adds one to each counter bin its outcome falls in (and
    its hop counts to ``tier_hops``): the bins of all fields are indices of
    one flat ``[rows, F + 1]`` int32 buffer, filled by one ``scatter_add_``
    whose last column, where masked-off entries land, is dropped.

    Args:
      ids: [rows, L] request ids, row i the list of requester ``my[i]``
        (FREE entries and any round padding count for nothing).
      active_budget: live lanes per round, one value for every row or one
        per row ([rows]), clipped to ``[0, budget]``.
      my: i64[rows] the rows' ring ranks (a loopback row past the last
        rank reads the last rank's program and pair tables).
      rounds: the round count the transfer ran.
      pairs: the topology's :meth:`~repro_torch.core.topology.Topology.
        pair_table`, which classifies each pair's tier (unused, and may be
        None, on a 1-node ring).
      program: the route program (unused, and may be None, on a 1-node
        ring).
      tenant_ids: [rows, L] tenant-id lane aligned with ``ids`` (None = all
        tenant 0); ids clip into ``[0, max_tenants)``.
      home: the home nodes of ``ids`` where the caller has translated them
        already.
    Returns [rows, ...] counters.
    """
    dev = ids.device
    rows, length = ids.shape
    lay = _layout(num_nodes, max_tenants)
    dump = _size(lay)
    at = lay[1]

    tenant = (0 if tenant_ids is None
              else tenant_ids.clamp(0, max_tenants - 1))
    if home is None:
        home, _ = table.translate(ids)
    live = (ids >= 0) & (home >= 0)
    ab = active_budget.clamp(0, budget).reshape(-1, 1)
    in_window = torch.arange(length, device=dev)[None, :] < rounds * ab
    if num_nodes == 1:
        # one node: every live request in the window is a loopback hit
        outcome = torch.where(live, torch.where(
            in_window, at["loopback_served"], at["spilled"]), dump)
        traffic = torch.where(live & in_window & (home == 0), at["traffic"],
                              dump)
        by_tenant = torch.where(live, torch.where(
            in_window, at["tenant_served"], at["tenant_spilled"]) + tenant,
            dump)
        idx = torch.stack([outcome, traffic, by_tenant], -1)
        src = torch.ones_like(idx, dtype=torch.int32)
    else:
        spill = live & ~in_window
        cand = live & in_window
        nslots = num_nodes - 1
        dist = torch.remainder(home - my[:, None], num_nodes)
        is_loop = cand & (dist == 0)
        slot = (dist - 1).clamp(0, nslots - 1)
        remote = cand & (dist > 0)
        # The serve condition mirrors the datapath: the slot must be live
        # AND the program's group mask must wire it for this requester.  A
        # loopback row past the ring's last rank reads that rank's tables,
        # as the reference's clamped gathers do.
        rank = my.clamp(max=num_nodes - 1)
        epoch_of = program.rank_epoch[:, rank].T.gather(1, slot)  # [rows, L]
        slot_wired = program.live[slot] & (epoch_of >= 0)
        wired = remote & slot_wired
        prune = remote & ~slot_wired
        served = is_loop | wired
        outcome = torch.where(
            wired, at["slot_served"] + slot,
            torch.where(is_loop, at["loopback_served"],
                        torch.where(spill, at["spilled"],
                                    torch.where(prune, at["pruned"], dump))))
        traffic = torch.where(served, at["traffic"] + home, dump)
        # Wire occupancy: a served page lands at the epoch the program
        # assigns this requester on its slot, on the direction it drives.
        offset = program.offsets[slot]
        ep = epoch_of.clamp(0, num_epoch_bins(num_nodes) - 1)
        epoch = torch.where(
            wired & (offset > 0), at["epoch_cw"] + ep,
            torch.where(wired & (offset < 0), at["epoch_ccw"] + ep, dump))
        # Per-tier occupancy under the topology's path realization.
        intra, board_hops, rack_hops = pairs[
            (offset <= 0).long(), rank[:, None],
            home.clamp(0, nslots).long()].unbind(-1)
        by_tenant = torch.where(
            served, at["tenant_served"] + tenant,
            torch.where(spill, at["tenant_spilled"] + tenant,
                        torch.where(prune, at["tenant_pruned"] + tenant,
                                    dump)))
        tier = torch.full_like(outcome, at["tier_hops"])
        idx = torch.stack([outcome, traffic, epoch,
                           torch.where(wired & (intra > 0),
                                       at["slot_intra"] + slot, dump),
                           tier, tier + 1, by_tenant], -1)
        one = torch.ones_like(outcome, dtype=torch.int32)
        src = torch.stack([one, one, one, one,
                           torch.where(wired, board_hops, 0),
                           torch.where(wired, rack_hops, 0), one], -1)
    flat = torch.zeros((rows, dump + 1), dtype=torch.int32, device=dev)
    flat.scatter_add_(1, idx.reshape(rows, -1).long(), src.reshape(rows, -1))
    return _unflatten(flat[:, :dump], lay)
