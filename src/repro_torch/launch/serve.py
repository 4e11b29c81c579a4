"""Serving launcher of the port: fixed-batch greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
      --kv bridge_pull

runs the full-width model on the card with random weights made from
seed 0; ``--reduced --device cpu`` runs the small same-family config on
the CPU through the kernels' plain versions.  ``--num-nodes N`` stripes the
KV pool over N memory nodes of the bridge's ring (a node axis of the one
device) and ``--channels`` sets the virtual channels of its rounds.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.config import BridgeConfig, RunConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.models.layers import torch_dtype
from repro_torch.obs.clock import MonotonicClock
from repro_torch.serve import step as serve_step_mod


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--kv", default="local", choices=["local", "bridge_pull"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--channels", type=int, default=1,
                    help="virtual channels per bridge round (1 = serial)")
    ap.add_argument("--num-nodes", type=int, default=1,
                    help="memory nodes the KV pool is striped over "
                         "(bridge_pull; 1 = the loopback bridge)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("--device cuda, but torch finds no CUDA device")

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    shape = ShapeConfig("cli", args.max_len, args.batch, "decode")
    run = RunConfig(model=cfg, shape=shape, kv_placement=args.kv,
                    bridge=BridgeConfig(channels=args.channels))
    device = torch.device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen, device=device)
    cache_ops = serve_step_mod.make_cache_ops(
        run, max_len=args.max_len, page_tokens=args.page_tokens,
        num_nodes=args.num_nodes, dtype=torch_dtype(cfg.dtype), device=device)
    state = serve_step_mod.init_serve_state(run, args.batch, cache_ops)
    step = serve_step_mod.build_serve_step(run, cache_ops)

    tokens = torch.ones((args.batch,), dtype=torch.int32, device=device)
    emitted = []
    wall = MonotonicClock()
    t0 = wall.now_us()
    for _ in range(args.steps):
        tokens, state = step(params, state, tokens)
        emitted.append(tokens)
    out = torch.stack(emitted, 1).cpu()         # waits for the device
    dt = (wall.now_us() - t0) / 1e6
    print(f"arch={cfg.name} kv={args.kv} batch={args.batch} "
          f"steps={args.steps} device={device}")
    if args.kv == "bridge_pull":
        print(f"bridge: num_nodes={args.num_nodes} channels={args.channels}")
    print(f"tokens/s={args.batch * args.steps / dt:.1f} "
          f"({dt / args.steps * 1e3:.1f} ms/step)")
    print("sample:", out[0][:16].tolist())


if __name__ == "__main__":
    main()
