"""Training launcher of the port: real steps on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --layers 4 --steps 20 --batch 4 --seq 1024

trains on the card (``--device cuda``, the default) with random weights
made from seed 0; ``--reduced --device cpu`` runs the small same-family
config on the CPU through the kernels' plain versions.  Composes: config
registry -> data pipeline (``SyntheticLM`` with a prefetch thread) -> train
step (loss, backward through the flash kernels, AdamW) -> checkpointing.
Flags are the reference's (``repro.launch.train``), plus ``--device`` and
``--layers`` (the depth, cut from the config's: one card holds the bf16
weights and float32 moments of granite-3-8b's 40 layers in 96 GB, more
than it has).  Each log line gives the loss, gradient norm, learning rate
and the mean ms a step since the start (the card drained first).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs, tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import OptimConfig, RunConfig, ShapeConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, to_device
from repro_torch.obs.clock import MonotonicClock
from repro_torch.train import step as train_step_mod


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth (0: the config's)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> list[dict]:
    """Run the launcher; returns the logged lines' numbers."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("--device cuda, but torch finds no CUDA device")
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    run = RunConfig(model=cfg, shape=shape,
                    optim=OptimConfig(lr=args.lr, warmup_steps=10,
                                      total_steps=max(args.steps, 2)),
                    microbatch=args.microbatch)
    device = torch.device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(run.seed)
    state = train_step_mod.make_train_state(run, gen, device=device)
    n_params = sum(x.numel() for x in tree.leaves(state.params))
    print(f"arch={cfg.name} layers={cfg.num_layers} "
          f"params={n_params / 1e6:.1f}M device={device}")

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(state)
        start = int(extra.get("step", 0))
        print(f"resumed from step {start}")

    step_fn = train_step_mod.build_train_step(run)
    data = SyntheticLM(cfg, args.batch, args.seq, seed=run.seed)
    it = Prefetcher(data.iterate(start), depth=2)

    logged = []
    wall = MonotonicClock()
    t0 = wall.now_us()
    for i in range(start, args.steps):
        batch = to_device(next(it), device)
        state, metrics = step_fn(state, batch)
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            line = {k: float(v) for k, v in metrics.items()}  # drains the card
            ms = (wall.now_us() - t0) / 1e3 / max(i + 1 - start, 1)
            logged.append(dict(line, step=i + 1, ms_per_step=ms))
            print(f"step {i + 1:5d} loss={line['loss']:.4f} "
                  f"gnorm={line['grad_norm']:.3f} lr={line['lr']:.2e} "
                  f"{ms:.0f} ms/step", flush=True)
        if ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, state, extra={"step": i + 1})
    it.close()
    if ckpt:
        ckpt.save(args.steps, state, extra={"step": args.steps})
        print(f"checkpointed at {args.ckpt_dir}")
    return logged


if __name__ == "__main__":
    main()
