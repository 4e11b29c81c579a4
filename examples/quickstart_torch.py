"""Quickstart of the PyTorch/CUDA port: the software-defined bridge.

The paper's core loop end to end, on the card (``--device cpu`` runs it on
the CPU through the kernels' plain versions):
  1. a control plane allocates a pooled memory region,
  2. a memport table is programmed (software-defined placement),
  3. a master pulls pages through the bridge (one device, ``table_nodes``
     logical memory nodes: the loopback path),
  4. a node fails, its pages are re-homed at run time and the plan is
     executed on the pool; the same pull runs on the new table, which is
     just data: nothing is rebuilt.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import bridge, ref  # noqa: E402
from repro_torch.core.control_plane import (ControlPlane,  # noqa: E402
                                            execute_plan, plan_rows)
from repro_torch.core.memport import FREE  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

NODES, SLOTS, PAGE = 4, 16, 64  # a tiny 4-node pod on one device


def main(device="cuda") -> dict:
    # 1. control plane owns placement
    cp = ControlPlane(num_nodes=NODES, pages_per_node=SLOTS, num_logical=32,
                      device=device)
    cp.allocate(12, "tensor-A", policy="striped")
    print(cp.describe())

    # 2. pool contents (each row = one page of a disaggregated tensor)
    rng = np.random.default_rng(0)
    pool = torch.tensor(rng.normal(size=(NODES * SLOTS, PAGE)).astype(
        np.float32), device=device)

    # 3. a master requests pages 0..11: the bridge translates through the
    #    memport table and pulls them
    table = cp.table()
    want = torch.tensor([[0, 5, 3, FREE, 11, 7]], dtype=torch.int32,
                        device=device)

    def pull(pool, want, table):
        return bridge.pull_pages(pool, want, table, budget=4,
                                 table_nodes=NODES)

    got = pull(pool, want, table)
    exp = ref.pull_pages_ref(pool, want, table, pages_per_node=SLOTS)
    if not torch.equal(got, exp):
        raise AssertionError("pull through the bridge != direct gather")
    print("pull through bridge == direct gather  OK")

    # 4. elastic remap: node 2 dies; pages re-home; the same call, new table
    builds = _build.nvcc_runs
    plan = cp.fail_node(2)
    print(f"node 2 failed: {len(plan)} pages re-homed")
    table2 = cp.table()
    # the executor restores migrated page contents (here: from the old
    # image) with one gather and one scatter for the whole plan
    execute_plan(pool, plan_rows(plan, SLOTS, device))
    got2 = pull(pool, want, table2)
    if not torch.equal(got2, exp):
        raise AssertionError("post-remap pull differs from the direct gather")
    if _build.nvcc_runs != builds:
        raise AssertionError("the remap built a kernel")
    print("post-remap pull identical, nothing rebuilt  OK")
    print(cp.describe())
    return dict(pages=int(want.ge(0).sum()), moved=len(plan))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("--device cuda, but torch finds no CUDA device")
    main(args.device)
