"""Pooled memory: the disaggregated "slave" side of the bridge.

The port's copy of ``repro.core.pool``.  A :class:`MemoryPool` is a page
array of ``num_nodes`` memory nodes, node-major: each node contributes
``pages_per_node`` slots of ``page_elems`` elements (on one card the nodes
are an axis of one tensor, as the port's bridge keeps them).  Where the
reference's writes return a new pool (donated under jit), the port writes
in place, through the scatter kernel, and returns the pool.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import bridge_gather as _bg


@dataclass(frozen=True)
class MemoryPool:
    """pages: [num_nodes * pages_per_node, page_elems], node-major."""

    pages: torch.Tensor

    def node_view(self, num_nodes: int) -> torch.Tensor:
        """[num_nodes, pages_per_node, page_elems] view."""
        total, elems = self.pages.shape
        return self.pages.view(num_nodes, total // num_nodes, elems)


def make_pool(num_nodes: int, pages_per_node: int, page_elems: int,
              dtype=torch.bfloat16, *, device="cuda") -> MemoryPool:
    return MemoryPool(pages=torch.zeros(
        (num_nodes * pages_per_node, page_elems), dtype=dtype,
        device=device))


def write_local(pool: MemoryPool, flat_slots: torch.Tensor,
                payload: torch.Tensor) -> MemoryPool:
    """Scatter pages into the pool by flat (node-major) slot index, in
    place: FREE (< 0) and out-of-pool slots drop, a later duplicate wins
    (``scatter_pages``)."""
    _bg.scatter_pages(pool.pages, flat_slots.to(torch.int32).contiguous(),
                      payload.to(pool.pages.dtype).contiguous())
    return pool


def read_local(pool: MemoryPool, flat_slots: torch.Tensor) -> torch.Tensor:
    """Pages at flat slots, zeros for FREE (``gather_pages``; a slot past
    the pool reads the last row, as the reference's gather clamps)."""
    return _bg.gather_pages(pool.pages, flat_slots.to(torch.int32).contiguous())
