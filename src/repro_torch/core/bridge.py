"""The bridge transfer engine, one-device loopback path.

Ports ``repro.core.bridge.pull_pages`` / ``push_pages`` for a memory axis of
one device with the fused datapath: requests pad to whole rounds of
``budget`` pages with FREE, the runtime rate limiter ``active_budget`` spills
what lies past ``rounds * active_budget``, each request is translated
through the :class:`~repro_torch.core.memport.MemPortTable` to the flat pool
row ``home * pages_per_node + slot`` (one memory node: ``pages_per_node`` is
the pool's row count), and the page moves through one
:func:`~repro_torch.kernels.bridge_gather.gather_pages` or
:func:`~repro_torch.kernels.bridge_gather.scatter_pages` launch.

``active_budget`` and the table stay device tensors: nothing here copies a
value to the host.  Route programs, in-band telemetry and the N-node engine
(a mesh) come with later slices of the port and raise here.
"""
from __future__ import annotations

import torch

from repro_torch.core import steering
from repro_torch.core.memport import FREE, MemPortTable
from repro_torch.kernels import bridge_gather as _bg


def _unported(mesh, program, collect_telemetry) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the N-node bridge engine (a mesh) comes with a later slice of "
            "the port; this slice runs the one-device loopback path")
    if program is not None:
        raise NotImplementedError(
            "route programs come with the next slice of the port (steering)")
    if collect_telemetry:
        raise NotImplementedError(
            "in-band telemetry comes with a later slice of the port")


def _loopback_rows(ids: torch.Tensor, table: MemPortTable, ppn: int,
                   rounds: int, budget: int, active_budget) -> torch.Tensor:
    """Padded requests [..., rounds*budget] -> flat pool rows i32[N*R]."""
    home, slot = table.translate(ids.reshape(-1))
    flat = torch.where(home >= 0, home * ppn + slot, FREE)
    if active_budget is None:
        return flat
    # Rate-limiter parity with the N-device path: round r serves request
    # indices [r*ab, (r+1)*ab), so anything past rounds*ab spills off the
    # end of the round budget and is dropped.
    ab = torch.as_tensor(active_budget, device=ids.device).reshape(-1)[0]
    ab = ab.clamp(0, budget)
    idx = torch.arange(ids.shape[-1], device=ids.device)
    served = torch.broadcast_to(idx < rounds * ab, ids.shape).reshape(-1)
    return torch.where(served, flat, FREE)


def _pad_requests(ids: torch.Tensor, rounds: int, budget: int):
    pad = rounds * budget - ids.shape[-1]
    if pad:
        ids = torch.cat([ids, ids.new_full(ids.shape[:-1] + (pad,), FREE)], -1)
    return ids, pad


def pull_pages(pool_pages: torch.Tensor, want: torch.Tensor,
               table: MemPortTable, *, mesh=None, budget: int = 8,
               active_budget=None, program=None,
               collect_telemetry: bool = False) -> torch.Tensor:
    """Pull logical pages through the loopback bridge.

    Args:
      pool_pages: [pages_per_node, *page_shape], one memory node.
      want: [num_nodes, R] per-node request lists (logical page ids, FREE
        pad), int32.
      table: memport table.
      budget: pages per round (static).
      active_budget: runtime rate limiter (int or device tensor, clipped to
        ``[0, budget]``); None serves every request.
      mesh, program, collect_telemetry: later slices; must stay unset.
    Returns:
      [num_nodes, R, *page_shape] gathered pages (zeros for FREE, spilled
      and unmapped requests).
    """
    _unported(mesh, program, collect_telemetry)
    r = want.shape[-1]
    rounds = steering.num_rounds(r, budget)
    want, _ = _pad_requests(want, rounds, budget)
    flat = _loopback_rows(want, table, pool_pages.shape[0], rounds, budget,
                          active_budget)
    out = _bg.gather_pages(pool_pages, flat)
    out = out.view(tuple(want.shape) + tuple(pool_pages.shape[1:]))
    # Trim the round padding on the request dim.
    return out.narrow(want.dim() - 1, 0, r)


def push_pages(pool_pages: torch.Tensor, dest: torch.Tensor,
               payload: torch.Tensor, table: MemPortTable, *, mesh=None,
               budget: int = 8, active_budget=None, program=None,
               collect_telemetry: bool = False) -> torch.Tensor:
    """Write pages to their homes through the loopback bridge.

    Args as :func:`pull_pages`, plus dest: [num_nodes, R] logical page ids
    each node writes and payload: [num_nodes, R, *page_shape] (cast to the
    pool's dtype).  Writes past ``rounds * active_budget`` spill and drop;
    among writes to one page the last wins.  Where the reference donates the
    pool buffer, the port updates ``pool_pages`` in place and returns it.
    """
    _unported(mesh, program, collect_telemetry)
    r = dest.shape[-1]
    rounds = steering.num_rounds(r, budget)
    dest, pad = _pad_requests(dest, rounds, budget)
    payload = payload.to(pool_pages.dtype)
    if pad:
        zeros = payload.new_zeros(payload.shape[:1] + (pad,)
                                  + payload.shape[2:])
        payload = torch.cat([payload, zeros], 1)
    flat = _loopback_rows(dest, table, pool_pages.shape[0], rounds, budget,
                          active_budget)
    flat_pay = payload.reshape((-1,) + tuple(payload.shape[2:]))
    return _bg.scatter_pages(pool_pages, flat, flat_pay.contiguous())
