"""End-to-end training run of the PyTorch port: a reduced LM, a few
dozen steps, with checkpointing, a mid-run simulated node failure, and the
AdamW moments held in a disaggregated pool through the bridge.

The port of ``examples/train_lm.py``: by default the ~0.4M-parameter
reduced granite-3-8b for 60 steps (``--full-100m`` for the ~100M model,
same code path).  The moments go into a bridge store over 4 logical memory
nodes (the loopback path of one device); node 2 fails at step 35, the
control plane re-homes its pages and training resumes from the last
checkpoint.  The run checks that the loss falls, that no page is homed on
node 2 afterwards, and that the final moments go through the re-homed
store and back bit for bit.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 60]
      [--device cpu]   (without --device it runs on the card)
"""
import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs, tree  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import OptimConfig, RunConfig, ShapeConfig  # noqa: E402,E501
from repro_torch.core import zero_bridge  # noqa: E402
from repro_torch.core.control_plane import ControlPlane  # noqa: E402
from repro_torch.data.pipeline import (Prefetcher, SyntheticLM,  # noqa: E402
                                       to_device)
from repro_torch.ft.elastic import ElasticTrainer  # noqa: E402
from repro_torch.obs.clock import MonotonicClock  # noqa: E402
from repro_torch.train import step as train_step_mod  # noqa: E402


def build(args):
    cfg = configs.get_reduced("granite-3-8b")
    if args.full_100m:
        cfg = dataclasses.replace(
            cfg, num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32768)
    shape = ShapeConfig("example", args.seq, args.batch, "train")
    return RunConfig(model=cfg, shape=shape,
                     optim=OptimConfig(lr=3e-4, warmup_steps=20,
                                       total_steps=args.steps))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--fail-at", type=int, default=35,
                    help="simulate a node failure at this step (0=off)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("--device cuda, but torch finds no CUDA device")
    device = torch.device(args.device)

    run = build(args)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = train_step_mod.make_train_state(run, gen, device=device)
    n = sum(x.numel() for x in tree.leaves(state.params))
    print(f"model={run.model.name}(reduced) params={n / 1e6:.1f}M "
          f"device={device}")

    # Disaggregated optimizer state: the AdamW moments live in a bridge pool
    # (4 logical memory nodes; the loopback path of one device).
    cp = ControlPlane(num_nodes=4, pages_per_node=4096, num_logical=8192,
                      device=device)
    store = zero_bridge.create_store(state.opt.m, page_elems=4096, cp=cp)
    print("optimizer-moment pool:", cp.occupancy().tolist(), "pages/node")

    step_fn = train_step_mod.build_train_step(run)
    with tempfile.TemporaryDirectory() as ckdir:
        ckpt = CheckpointManager(ckdir, keep=2)
        trainer = ElasticTrainer(step_fn=step_fn, ckpt=ckpt, cp=cp,
                                 ckpt_every=20)
        data = SyntheticLM(run.model, args.batch, args.seq)
        batches = (to_device(b, device)
                   for b in Prefetcher(data.iterate(), depth=2))
        failure = {args.fail_at: 2} if args.fail_at else None

        wall = MonotonicClock()
        t0 = wall.now_us()
        state, history = trainer.run(state, batches, num_steps=args.steps,
                                     failure_schedule=failure)
        dt = (wall.now_us() - t0) / 1e6

    losses = [h["loss"] for h in history]
    head = float(np.mean(losses[:5]))
    tail = float(np.mean(losses[-5:]))
    print(f"steps={len(history)} wall={dt:.1f}s "
          f"loss {head:.3f} -> {tail:.3f}")
    for ev in trainer.events:
        print(f"  event: {ev.kind} node={ev.node} step={ev.at_step}")
    assert tail < head, "loss should decrease"
    # pool placement after the failure excludes the dead node
    assert not (cp.table().home == 2).any()
    # the final moments through the re-homed pool and back, bit for bit
    store = dataclasses.replace(store, table=cp.table(),
                                program=cp.route_program())
    store = zero_bridge.push_tree(store, state.opt.m)
    back = zero_bridge.pull_tree(store)
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(back), tree.leaves(state.opt.m)))
    print("OK: trained through a node failure with elastic remap")
    return history, trainer.events


if __name__ == "__main__":
    main()
