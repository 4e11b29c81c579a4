"""Disaggregated optimizer state through the bridge (ZeRO-3, paper-style).

The port's copy of ``repro.core.zero_bridge``.  The optimizer state (float32
m and v) lives in the pooled memory of memory nodes and streams through the
bridge once a step:

    pull opt-state pages  ->  apply update  ->  push opt-state pages

Tensors are packed into fixed-size pages (the bridge granule) by a
host-side :class:`TreePacker` that records each leaf's page range, in
``jax.tree``'s leaf order (dict keys sorted), so a dict of arrays packs
into the same pages in both packages; the memport table owns placement,
so the control plane can re-home the state's pages on node failure
without touching the training step.

The reference's memory axis is a mesh axis; the port's is ``num_nodes``:
1 (the default) is the one-card loopback path, whose pool still models the
control plane's ``table_nodes`` logical memory nodes (one ``gather_pages``
launch a pull, one ``scatter_pages`` launch a push), and N > 1 the fused
N-node engine on a node axis of the card.  Every request list is built on
the device, so a pull or a push uploads nothing.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch import tree as _tree
from repro_torch.core import bridge
from repro_torch.core.control_plane import ControlPlane
from repro_torch.core.memport import FREE, MemPortTable
from repro_torch.core.steering import RouteProgram
from repro_torch.core.topology import Topology


@dataclass
class TreePacker:
    """Host-side layout: tree leaves <-> page ranges in one pool."""

    treedef: Any
    shapes: list[tuple[int, ...]]
    dtypes: list[Any]
    offsets: list[int]          # first page of each leaf
    counts: list[int]           # pages per leaf
    page_elems: int
    num_pages: int

    @staticmethod
    def plan(tree: Any, page_elems: int) -> "TreePacker":
        leaves, treedef = _tree.flatten(tree)
        shapes = [tuple(leaf.shape) for leaf in leaves]
        dtypes = [leaf.dtype for leaf in leaves]
        offsets, counts = [], []
        at = 0
        for leaf in leaves:
            n = -(-max(leaf.numel(), 1) // page_elems)
            offsets.append(at)
            counts.append(n)
            at += n
        return TreePacker(treedef, shapes, dtypes, offsets, counts,
                          page_elems, at)

    def pack(self, tree: Any, dtype=torch.float32,
             rows: Optional[int] = None) -> torch.Tensor:
        """-> [rows or num_pages, page_elems] page image of the tree, each
        leaf's tail and the rows past ``num_pages`` zero."""
        leaves = _tree.leaves(tree)
        out = torch.zeros((rows or self.num_pages, self.page_elems),
                          dtype=dtype, device=leaves[0].device)
        flat = out.view(-1)
        for leaf, off in zip(leaves, self.offsets):
            at = off * self.page_elems
            flat[at: at + leaf.numel()].copy_(leaf.reshape(-1))
        return out

    def unpack(self, pages: torch.Tensor) -> Any:
        """The tree of a page image; the leaves are views of ``pages``
        where the dtype is the pages' own."""
        leaves = []
        for shape, dt, off, n in zip(self.shapes, self.dtypes, self.offsets,
                                     self.counts):
            flat = pages[off: off + n].reshape(-1)
            size = 1
            for d in shape:
                size *= d
            leaves.append(flat[:size].view(shape).to(dt))
        return _tree.unflatten(self.treedef, leaves)


@dataclass
class BridgeStore:
    """A packed tree resident in a bridge pool."""

    packer: TreePacker
    table: MemPortTable
    pool: torch.Tensor          # [num_slots, page_elems], node-major
    num_nodes: int              # memory axis (1 = loopback path)
    budget: int
    table_nodes: int = 1        # logical memory nodes of the table
    program: Optional[RouteProgram] = None  # circuit schedule (None = full)
    topology: Optional[Topology] = None     # board + rack fabric (None = flat)
    channels: int = 1           # virtual channels a round
    tenant_id: int = 0          # telemetry attribution of the store's traffic
    max_tenants: int = 0        # per-tenant histogram width (0 = default)


def create_store(tree: Any, *, num_nodes: int = 1, page_elems: int = 16_384,
                 budget: int = 8, channels: int = 1,
                 cp: Optional[ControlPlane] = None, policy: str = "striped",
                 dtype=torch.float32, tenant_id: int = 0,
                 max_tenants: int = 0) -> BridgeStore:
    """Allocate a pooled region for ``tree`` and write its initial image.

    Without ``cp`` a plane of ``num_nodes`` nodes with twice the slots the
    tree needs (room to re-home a failed node's pages) is made on the
    tree's device.  The control plane's topology rides along: on a board +
    rack fabric the store's circuit schedule comes out hierarchical and its
    telemetry carries per-tier occupancy.  ``tenant_id`` tags every
    transfer of the store in the telemetry's per-tenant bins.
    """
    packer = TreePacker.plan(tree, page_elems)
    n = num_nodes
    if cp is None:
        # Headroom so elastic remap has spare slots on survivors.
        cp = ControlPlane(n, 2 * -(-packer.num_pages // n), packer.num_pages,
                          device=_tree.leaves(tree)[0].device)
    if n > 1 and cp.num_nodes != n:
        raise ValueError(f"control plane has {cp.num_nodes} nodes, the "
                         f"memory axis has {n}")
    cp.allocate(packer.num_pages, "zero", policy=policy)
    # Pool geometry MUST match the control plane's slot space: remapped
    # slots index the same rows the bridge scatters into.
    pool = torch.zeros((cp.num_nodes * cp.pages_per_node, page_elems),
                       dtype=dtype, device=cp.device)
    topo = None if cp.topology.is_flat else cp.topology
    store = BridgeStore(packer, cp.table(), pool, n, budget,
                        table_nodes=cp.num_nodes, program=cp.route_program(),
                        topology=topo, channels=channels,
                        tenant_id=tenant_id, max_tenants=max_tenants)
    return push_tree(store, tree)


def _node_requests(num_pages: int, n: int, device) -> torch.Tensor:
    """Page ids 0 .. num_pages - 1 split evenly across the n requesting
    nodes, FREE-padded: i32[n, ceil(num_pages / n)]."""
    per = -(-num_pages // n)
    ids = torch.full((n * per,), FREE, dtype=torch.int32, device=device)
    ids[:num_pages] = torch.arange(num_pages, dtype=torch.int32,
                                   device=device)
    return ids.view(n, per)


def _transfer_kw(store: BridgeStore, ids: torch.Tensor,
                 collect_telemetry: bool) -> dict:
    return dict(num_nodes=store.num_nodes, budget=store.budget,
                channels=store.channels, program=store.program,
                table_nodes=store.table_nodes,
                collect_telemetry=collect_telemetry,
                topology=store.topology,
                tenant_ids=(torch.full_like(ids, store.tenant_id)
                            if collect_telemetry else None),
                max_tenants=store.max_tenants)


def pull_tree(store: BridgeStore, *, collect_telemetry: bool = False) -> Any:
    """Stream the packed tree out of the pool (each node pulls a stripe of
    the pages).  With ``collect_telemetry`` returns ``(tree,
    BridgeTelemetry)`` so the once-a-step optimizer traffic feeds the
    aggregator."""
    want = _node_requests(store.packer.num_pages, store.num_nodes,
                          store.pool.device)
    got = bridge.pull_pages(store.pool, want, store.table,
                            **_transfer_kw(store, want, collect_telemetry))
    telem = None
    if collect_telemetry:
        got, telem = got
    flat = got.reshape(-1, store.packer.page_elems)[: store.packer.num_pages]
    tree = store.packer.unpack(flat)
    if collect_telemetry:
        return tree, telem
    return tree


def push_tree(store: BridgeStore, tree: Any, *,
              collect_telemetry: bool = False):
    """Write a new image of the tree through the bridge (the pool is
    updated in place).  With ``collect_telemetry`` returns ``(store,
    BridgeTelemetry)``."""
    dest = _node_requests(store.packer.num_pages, store.num_nodes,
                          store.pool.device)
    n, per = dest.shape
    pages = store.packer.pack(tree, dtype=store.pool.dtype, rows=n * per)
    pool = bridge.push_pages(store.pool, dest,
                             pages.view(n, per, store.packer.page_elems),
                             store.table,
                             **_transfer_kw(store, dest, collect_telemetry))
    telem = None
    if collect_telemetry:
        pool, telem = pool
    out = dataclasses.replace(store, pool=pool)
    if collect_telemetry:
        return out, telem
    return out


def with_program(store: BridgeStore, program) -> BridgeStore:
    """Swap the store's circuit schedule (a runtime input — e.g. a
    telemetry-compiled ``ControlPlane.route_program(telemetry=...)``)."""
    return dataclasses.replace(store, program=program)


def rehome_after_failure(store: BridgeStore, cp: ControlPlane,
                         failed_node: int, restore_tree: Any) -> BridgeStore:
    """Elastic remap: re-home the failed node's pages and restore their
    contents from a checkpointed tree image (the data on the node is lost)."""
    cp.fail_node(failed_node)
    table = cp.table()
    # Placement changed: recompile the circuit schedule for the new homes.
    program = cp.route_program() if store.program is not None else None
    store = dataclasses.replace(store, table=table, program=program)
    return push_tree(store, restore_tree)
