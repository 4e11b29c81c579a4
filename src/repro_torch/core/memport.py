"""The memport construct (paper Fig. 2), adapted to page-granular pools.

The table maps

    logical page id  ->  (home node on the mem axis, slot in that node's pool)

Both columns are int32 tensors on the device and are runtime inputs: the
control plane can re-program them between steps (:meth:`program`,
:meth:`rehome`), and :meth:`translate` reads them on the device without ever
copying a value to the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

FREE = -1  # sentinel for unmapped pages / empty request slots


@dataclass(frozen=True)
class MemPortTable:
    """Steering table: one row per logical page.

    Attributes:
      home:  i32[num_logical]  node id owning the page (FREE if unmapped)
      slot:  i32[num_logical]  slot index within the home node's local pool
    """

    home: torch.Tensor
    slot: torch.Tensor

    @property
    def num_logical(self) -> int:
        return self.home.shape[0]

    @staticmethod
    def empty(num_logical: int, *, device="cuda") -> "MemPortTable":
        """Every logical page unmapped."""
        free = torch.full((num_logical,), FREE, dtype=torch.int32,
                          device=device)
        return MemPortTable(home=free, slot=free.clone())

    @staticmethod
    def striped(num_logical: int, num_nodes: int, pages_per_node: int, *,
                device="cuda") -> "MemPortTable":
        """Round-robin page placement (the default pooled layout)."""
        if num_logical and (num_logical - 1) // num_nodes >= pages_per_node:
            raise ValueError(
                f"pool too small: need {(num_logical - 1) // num_nodes + 1} "
                f"slots/node, have {pages_per_node}")
        pages = torch.arange(num_logical, dtype=torch.int32, device=device)
        return MemPortTable(home=pages % num_nodes, slot=pages // num_nodes)

    @staticmethod
    def blocked(num_logical: int, num_nodes: int, pages_per_node: int, *,
                device="cuda") -> "MemPortTable":
        """Contiguous block placement: page p -> (p // ppn, p % ppn), so the
        node-major flat row equals the logical id (identity layout)."""
        if num_logical and (num_logical - 1) // pages_per_node >= num_nodes:
            raise ValueError("pool too small for blocked layout")
        pages = torch.arange(num_logical, dtype=torch.int32, device=device)
        return MemPortTable(home=pages // pages_per_node,
                            slot=pages % pages_per_node)

    def translate(self, page_ids: torch.Tensor):
        """logical page ids -> (home node, remote slot); FREE passes through."""
        valid = page_ids >= 0
        safe = page_ids.clamp(min=0)
        home = torch.where(valid, self.home[safe], FREE)
        slot = torch.where(valid, self.slot[safe], FREE)
        return home, slot

    # -- runtime reprogramming (control plane) -------------------------------
    def program(self, page_ids, homes, slots) -> "MemPortTable":
        """Return a new table with rows ``page_ids`` rewritten."""
        dev = self.home.device

        def col(a):
            return torch.as_tensor(np.asarray(a), device=dev)

        idx = col(page_ids).long()
        home, slot = self.home.clone(), self.slot.clone()
        home[idx] = col(homes).to(torch.int32)
        slot[idx] = col(slots).to(torch.int32)
        return MemPortTable(home=home, slot=slot)

    def rehome(self, old_home: int, new_homes, new_slots) -> "MemPortTable":
        """Move every page homed at ``old_home`` (node failure path; reads
        the table on the host, as the control plane does)."""
        idx = np.nonzero(self.home.cpu().numpy() == old_home)[0]
        if len(idx) != len(new_homes):
            raise ValueError("rehome plan size mismatch")
        return self.program(idx, new_homes, new_slots)
