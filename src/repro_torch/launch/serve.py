"""Serving launcher of the port: fixed-batch greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
      --kv bridge_pull

runs the full-width model on the card with random weights made from
seed 0; ``--reduced --device cpu`` runs the small same-family config on
the CPU through the kernels' plain versions.  ``--kv`` picks the KV
placement (``local``, ``ring``, ``bridge_pull``, ``bridge_push``);
``--num-nodes N`` stripes the KV pool over N memory nodes of the bridge's
ring (a node axis of the one device) and ``--channels`` sets the virtual
channels of its rounds.  ``--telemetry`` collects the bridge's in-band
counters and prints their aggregate and the control plane's channel pick
from it; ``--tenants K`` serves the batch as K tenants (sequence b belongs
to tenant b % K), whose pages the counters attribute.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.config import BridgeConfig, RunConfig, ShapeConfig
from repro_torch.core.control_plane import ControlPlane
from repro_torch.models import transformer
from repro_torch.models.layers import torch_dtype
from repro_torch.obs.clock import MonotonicClock
from repro_torch.serve import step as serve_step_mod
from repro_torch.telemetry import TelemetryAggregator


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--kv", default="local",
                    choices=["local", "ring", "bridge_pull", "bridge_push"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--channels", type=int, default=1,
                    help="virtual channels per bridge round (1 = serial)")
    ap.add_argument("--num-nodes", type=int, default=1,
                    help="memory nodes the KV pool is striped over "
                         "(bridge_*; 1 = the loopback bridge)")
    ap.add_argument("--telemetry", action="store_true",
                    help="collect in-band bridge counters (bridge_* "
                         "placements) and print the aggregate")
    ap.add_argument("--tenants", type=int, default=1,
                    help="serve the batch as K tenants (sequence b belongs "
                         "to tenant b %% K); with --telemetry the bridge "
                         "counters attribute traffic per tenant")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("--device cuda, but torch finds no CUDA device")
    if args.tenants < 1:
        ap.error("--tenants must be >= 1")

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    shape = ShapeConfig("cli", args.max_len, args.batch, "decode")
    run = RunConfig(model=cfg, shape=shape, kv_placement=args.kv,
                    bridge=BridgeConfig(channels=args.channels))
    device = torch.device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen, device=device)
    bridged = args.kv in ("bridge_pull", "bridge_push")
    collect = args.telemetry and bridged
    cache_ops = serve_step_mod.make_cache_ops(
        run, max_len=args.max_len, page_tokens=args.page_tokens,
        num_nodes=args.num_nodes, collect_telemetry=collect,
        tenant_of_seq=(np.arange(args.batch) % args.tenants
                       if args.tenants > 1 else None),
        max_tenants=args.tenants if args.tenants > 1 else 0,
        dtype=torch_dtype(cfg.dtype), device=device)
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
    if bridged:
        print(f"bridge: num_nodes={args.num_nodes} channels={args.channels}")
    print(f"tokens/s={args.batch * args.steps / dt:.1f} "
          f"({dt / args.steps * 1e3:.1f} ms/step)")
    print("sample:", out[0][:16].tolist())
    telem = serve_step_mod.collect_state_telemetry(state) if collect else None
    if telem is not None:
        agg = TelemetryAggregator(telem.num_nodes,
                                  max_tenants=telem.max_tenants)
        agg.update(telem)
        print(agg.describe())
        if args.tenants > 1:
            served = telem.tenant_served.sum(0).tolist()
            spilled = telem.tenant_spilled.sum(0).tolist()
            for t in range(args.tenants):
                print(f"tenant {t}: served={served[t]} pages "
                      f"spilled={spilled[t]}")
        # The closed loop's pipeline-depth pick from the measured occupancy
        # (what --channels should be next run).
        cp = ControlPlane(telem.num_nodes, 1, 1, device=device)
        page_bytes = (args.page_tokens * cfg.num_kv_heads * cfg.head_dim
                      * torch_dtype(cfg.dtype).itemsize)
        pick = cp.select_channels(run.bridge.epoch_budget, page_bytes,
                                  telemetry=agg)
        print(f"control plane channels pick: {pick} "
              f"(running with {args.channels})")


if __name__ == "__main__":
    main()
