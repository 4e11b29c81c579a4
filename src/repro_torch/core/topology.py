"""Two-tier fabric description: boards of endpoints joined by a rack ring.

The port's copy of ``repro.core.topology.Topology``, host-side numpy only:

* every node of the memory axis belongs to a **board** (group) and has a
  local rank on that board's ring (the board tier);
* local rank 0 of each board is the board's **gateway**; gateways form a
  rack-level ring (the rack tier);
* the two tiers have their own wire constants (hop latency, link bandwidth).

A Topology is static per deployment; :func:`repro_torch.core.steering.
hierarchical_program` compiles route programs *for* it, and those programs
stay runtime inputs.

Path realization contract (the single definition of how many wires a
transfer holds):

* an **intra-board** pair (requester and home on the same board) travels
  the board ring in the direction the route program drives its slot:
  ``sign=+1``: ``(l_home - l_req) mod G`` board hops; ``sign=-1`` the
  mirror.  No rack link is touched;
* an **inter-board** pair routes through the gateways: shortest-way local
  legs ``min(l, G - l)`` on each board, plus the rack ring between the two
  gateways in the program's direction.

The flat single-board topology (:meth:`Topology.flat`) is the plain ring.

:meth:`Topology.tables` is the device-side view of the layout, and
:func:`pair_hops_device` mirrors :meth:`Topology.pair_hops` on it;
:meth:`Topology.pair_table` holds its result for every pair, which the
bridge's in-band telemetry reads.  Both are made once per device and kept,
so a transfer with telemetry copies nothing to the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class TopoTables:
    """Device-side view of a topology (what the telemetry counters read).

    All three are i32[N] indexed by node rank.
    """

    group: torch.Tensor        # board id of each rank
    local_rank: torch.Tensor   # rank within its board
    group_size: torch.Tensor   # size of the rank's board


@dataclass(frozen=True, eq=False)
class Topology:
    """Static two-tier fabric layout + per-tier wire constants.

    Attributes:
      group: i64[N] board id per node (0 .. num_groups-1).
      local_rank: i64[N] rank within the board (0 .. group size - 1); local
        rank 0 is the board's gateway onto the rack ring.
      group_sizes: i64[B] endpoints per board (boards may be ragged).
      board_hop_us / rack_hop_us: per-hop circuit latency of each tier.
      board_link_gbps / rack_link_gbps: per-direction link bandwidth of
        each tier (GB/s).
    """

    group: np.ndarray
    local_rank: np.ndarray
    group_sizes: np.ndarray
    board_hop_us: float = 1.5
    rack_hop_us: float = 4.0
    board_link_gbps: float = 50.0
    rack_link_gbps: float = 25.0
    _tables: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        g = np.asarray(self.group, np.int64)
        l = np.asarray(self.local_rank, np.int64)
        sizes = np.asarray(self.group_sizes, np.int64)
        object.__setattr__(self, "group", g)
        object.__setattr__(self, "local_rank", l)
        object.__setattr__(self, "group_sizes", sizes)
        if g.shape != l.shape or g.ndim != 1:
            raise ValueError("group / local_rank must be matching 1-D arrays")
        b = sizes.shape[0]
        if g.size and (g.min() < 0 or g.max() >= b):
            raise ValueError(f"group ids must lie in [0, {b})")
        for gid in range(b):
            locs = np.sort(l[g == gid])
            if locs.shape[0] != sizes[gid] or not np.array_equal(
                    locs, np.arange(sizes[gid])):
                raise ValueError(
                    f"board {gid}: local ranks must be exactly "
                    f"0..{int(sizes[gid]) - 1}")

    # -- constructors --------------------------------------------------------
    @staticmethod
    def flat(num_nodes: int, **hw) -> "Topology":
        """One board spanning the whole ring."""
        return Topology.from_sizes([num_nodes], **hw)

    @staticmethod
    def boards(num_groups: int, group_size: int, **hw) -> "Topology":
        """Contiguous uniform boards: rank = board * size + local rank."""
        return Topology.from_sizes([group_size] * num_groups, **hw)

    @staticmethod
    def from_sizes(sizes: Sequence[int], **hw) -> "Topology":
        """Contiguous boards of the given (possibly ragged) sizes."""
        sizes = np.asarray(list(sizes), np.int64)
        if sizes.size == 0 or (sizes < 1).any():
            raise ValueError("every board needs at least one endpoint")
        group = np.repeat(np.arange(sizes.shape[0]), sizes)
        local = np.concatenate([np.arange(s) for s in sizes])
        return Topology(group=group, local_rank=local, group_sizes=sizes, **hw)

    # -- shape ----------------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return self.group.shape[0]

    @property
    def num_groups(self) -> int:
        return self.group_sizes.shape[0]

    @property
    def is_flat(self) -> bool:
        return self.num_groups == 1

    def gateway_rank(self, gid: int) -> int:
        """Rank of board ``gid``'s gateway (its local rank 0)."""
        return int(np.nonzero((self.group == gid) & (self.local_rank == 0))[0][0])

    # -- pair classification / hop counting ----------------------------------
    def pair_intra(self, req, home) -> np.ndarray:
        """bool: requester and home share a board (element-wise)."""
        return self.group[np.asarray(req)] == self.group[np.asarray(home)]

    def pair_hops(self, req, home, sign) -> Tuple[np.ndarray, np.ndarray]:
        """(board_hops, rack_hops) of each (req, home) pair.

        ``sign`` (+1/-1, broadcastable) is the direction the pair's slot is
        driven.  Pairs with ``req == home`` are loopback hits and cost 0 on
        both tiers.
        """
        req = np.asarray(req)
        home = np.asarray(home)
        sign = np.broadcast_to(np.asarray(sign), req.shape)
        g_r, g_h = self.group[req], self.group[home]
        l_r, l_h = self.local_rank[req], self.local_rank[home]
        size_r = self.group_sizes[g_r]
        size_h = self.group_sizes[g_h]
        intra = g_r == g_h
        b = self.num_groups
        board = np.where(
            intra,
            np.where(sign > 0, (l_h - l_r) % size_r, (l_r - l_h) % size_r),
            np.minimum(l_r, size_r - l_r) + np.minimum(l_h, size_h - l_h))
        rack = np.where(
            intra, 0,
            np.where(sign > 0, (g_h - g_r) % b, (g_r - g_h) % b))
        loop = req == home
        return np.where(loop, 0, board), np.where(loop, 0, rack)

    # -- device-side view -----------------------------------------------------
    def tables(self, device="cuda") -> TopoTables:
        """The :class:`TopoTables` on ``device``, made on the first call for
        that device and kept (a Topology is static)."""
        key = _device_key(device)
        if key not in self._tables:
            def i32(a):
                return torch.tensor(np.asarray(a).astype(np.int32),
                                    device=device)
            self._tables[key] = TopoTables(
                group=i32(self.group), local_rank=i32(self.local_rank),
                group_size=i32(self.group_sizes[self.group]))
        return self._tables[key]

    def pair_table(self, device="cuda") -> torch.Tensor:
        """i32[2, N, N, 3]: (intra, board hops, rack hops) of requester r
        and home h, index 0 when the pair's slot is driven clockwise and 1
        otherwise, from :func:`pair_hops_device` on :meth:`tables`; made on
        the first call for ``device`` and kept."""
        key = ("pairs", _device_key(device))
        if key not in self._tables:
            n = self.num_nodes
            req = torch.arange(n, device=device)[:, None].expand(n, n)
            home = req.T
            sides = []
            for sign in (1, -1):
                sides.append(torch.stack([x.to(torch.int32) for x in (
                    pair_hops_device(self.tables(device), self.num_groups,
                                     req, home,
                                     torch.full((n, n), sign,
                                                device=device)))], -1))
            self._tables[key] = torch.stack(sides)
        return self._tables[key]

    def describe(self) -> str:
        return (f"topology: {self.num_nodes} endpoints on {self.num_groups} "
                f"board(s) {self.group_sizes.tolist()}; board "
                f"{self.board_hop_us}us/{self.board_link_gbps}GB/s, rack "
                f"{self.rack_hop_us}us/{self.rack_link_gbps}GB/s")


def _device_key(device) -> str:
    """One name per device: ``"cuda"`` and the tensors' ``cuda:0`` (the
    current card) share their tables."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def pair_hops_device(tables: TopoTables, num_groups: int, my, home, sign):
    """Tensor mirror of :meth:`Topology.pair_hops` for the telemetry.

    ``my`` holds the requesters' ranks (a tensor broadcastable against
    ``home``), ``home`` the per-request home ranks (FREE entries must be
    masked by the caller), ``sign`` the per-request drive direction.
    Returns (intra, board_hops, rack_hops).
    """
    safe = home.clamp(0, tables.group.shape[0] - 1).long()
    if not torch.is_tensor(my):
        my = torch.full((), int(my), device=home.device)
    my = my.long()
    g_r, l_r = tables.group[my], tables.local_rank[my]
    size_r = tables.group_size[my]
    g_h, l_h = tables.group[safe], tables.local_rank[safe]
    size_h = tables.group_size[safe]
    intra = g_h == g_r
    board = torch.where(
        intra,
        torch.where(sign > 0, torch.remainder(l_h - l_r, size_r),
                    torch.remainder(l_r - l_h, size_r)),
        torch.minimum(l_r, size_r - l_r) + torch.minimum(l_h, size_h - l_h))
    rack = torch.where(
        intra, 0,
        torch.where(sign > 0, torch.remainder(g_h - g_r, num_groups),
                    torch.remainder(g_r - g_h, num_groups)))
    loop = safe == my
    return intra, torch.where(loop, 0, board), torch.where(loop, 0, rack)
