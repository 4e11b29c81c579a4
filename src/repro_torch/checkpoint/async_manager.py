"""Asynchronous checkpointing: snapshot on the step path, serialize off it.

The port's copy of ``repro.checkpoint.async_manager``.  ``save`` copies the
state to the host before it returns (a device-to-host copy, which
waits for the card to finish the step), and hands compression, fsync and
rename to a background thread, so the training loop resumes at once:

  * the snapshot is taken synchronously: a later in-place update of the
    live state (the port's optimizer updates in place, where the reference
    donates) cannot reach the image being written;
  * saves are ordered: a newer save never lands before an older one
    (single worker thread, FIFO queue);
  * ``wait()`` drains the queue (call before shutdown / failover);
  * the LATEST marker only moves after a fully committed directory, so a
    crash mid-save preserves the previous checkpoint.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager


def _host_copy(leaf: Any):
    """A leaf copied to the host: a CPU tensor of its dtype, or an array."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class AsyncCheckpointManager:
    def __init__(self, directory: str, keep: int = 3, depth: int = 2):
        self._sync = CheckpointManager(directory, keep=keep)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._errors: list = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- API -------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        """Snapshot now, write in the background (blocks only if the queue
        is full — backpressure instead of unbounded host memory)."""
        snapshot = tree.tree_map(_host_copy, state)
        self._q.put((step, snapshot, extra))

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def restore(self, target: Any, step: Optional[int] = None):
        self.wait()
        return self._sync.restore(target, step=step)

    def latest_step(self) -> Optional[int]:
        return self._sync.latest_step()

    def steps(self):
        return self._sync.steps()

    # -- worker ------------------------------------------------------------
    def _worker(self):
        while True:
            step, snapshot, extra = self._q.get()
            try:
                self._sync.save(step, snapshot, extra=extra)
            except Exception as e:  # surfaced at wait()
                self._errors.append(e)
            finally:
                self._q.task_done()
