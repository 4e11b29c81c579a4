"""The memport construct (paper Fig. 2), adapted to page-granular pools.

The table maps

    logical page id  ->  (home node on the mem axis, slot in that node's pool)

Both columns are int32 tensors on the device and are runtime inputs: the
control plane can re-program them between steps, and :meth:`translate` reads
them on the device without ever copying a value to the host.
"""
from __future__ import annotations

from dataclasses import dataclass

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
    def striped(num_logical: int, num_nodes: int, pages_per_node: int, *,
                device="cuda") -> "MemPortTable":
        """Round-robin page placement (the default pooled layout)."""
        if num_logical and (num_logical - 1) // num_nodes >= pages_per_node:
            raise ValueError(
                f"pool too small: need {(num_logical - 1) // num_nodes + 1} "
                f"slots/node, have {pages_per_node}")
        pages = torch.arange(num_logical, dtype=torch.int32, device=device)
        return MemPortTable(home=pages % num_nodes, slot=pages // num_nodes)

    def translate(self, page_ids: torch.Tensor):
        """logical page ids -> (home node, remote slot); FREE passes through."""
        valid = page_ids >= 0
        safe = page_ids.clamp(min=0)
        home = torch.where(valid, self.home[safe], FREE)
        slot = torch.where(valid, self.slot[safe], FREE)
        return home, slot
