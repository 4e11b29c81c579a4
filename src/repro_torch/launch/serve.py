"""Serving launcher of the port: fixed-batch greedy decode, or request-level
serving over the same step.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
      --kv bridge_pull

runs the full-width model on the card with random weights made from
seed 0; ``--reduced --device cpu`` runs the small same-family config on
the CPU through the kernels' plain versions.  ``--kv`` picks the KV
placement (``local``, ``ring``, ``bridge_pull``, ``bridge_push``);
``--num-nodes N`` stripes the KV pool over N memory nodes of the bridge's
ring (a node axis of the one device) and ``--channels`` sets the virtual
channels of its rounds; ``--no-fused`` runs the unfused bridge engine in
place of the fused kernel datapath.  ``--telemetry`` collects the bridge's
in-band counters and prints their aggregate and the control plane's
channel pick from it; ``--tenants K`` serves the batch as K tenants
(sequence b belongs to tenant b % K), whose pages the counters attribute.  ``--metrics``
traces every decode step as a fenced span and prints the metrics registry;
``--trace-out PATH`` writes the Chrome trace.

``--traffic`` switches from one fixed batch to request-level serving: a
seeded Poisson arrival stream (two tenants, interactive + batch QoS)
drives the continuous batcher over the same decode step — slots admit from
per-tenant queues as sequences retire, KV pages lease from an orchestrated
pool, and the run reports per-QoS p50/p99 latencies:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
      --traffic --batch 8 --max-len 256 --traffic-steps 24

``--debug-bundle PATH`` then writes the postmortem zip (flight journal,
trace, metrics, ``describe()``).
"""
from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from repro_torch import configs
from repro_torch.config import BridgeConfig, RunConfig, ShapeConfig
from repro_torch.core.control_plane import ControlPlane
from repro_torch.models import transformer
from repro_torch.models.layers import torch_dtype
from repro_torch.obs import MetricsRegistry, TraceRecorder
from repro_torch.obs.clock import MonotonicClock
from repro_torch.orchestrator import Orchestrator, TenantSpec
from repro_torch.serve import step as serve_step_mod
from repro_torch.serve.batcher import (ContinuousBatcher, ModelDecodeEngine,
                                       serve_loop)
from repro_torch.serve.traffic import TenantTraffic, TrafficGenerator
from repro_torch.telemetry import TelemetryAggregator


def build_parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--no-fused", action="store_true",
                    help="escape hatch: run the unfused bridge engine "
                         "instead of the fused kernel datapath (bit-exact "
                         "either way)")
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
    ap.add_argument("--metrics", action="store_true",
                    help="trace every decode step as a fenced span, print "
                         "the metrics registry snapshot (per-step latency "
                         "p50/p99, bridge counter families) and, with "
                         "--trace-out, write the Perfetto trace JSON")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the Chrome-trace/Perfetto JSON of the "
                         "decode loop to PATH")
    ap.add_argument("--traffic", action="store_true",
                    help="request-level serving: continuous batching over "
                         "a seeded two-tenant Poisson arrival stream "
                         "(--batch sets the decode slot count)")
    ap.add_argument("--traffic-steps", type=int, default=32,
                    help="arrival steps to offer load for (the loop then "
                         "drains in-flight sequences)")
    ap.add_argument("--traffic-rate", type=float, default=0.5,
                    help="expected arrivals per step per tenant")
    ap.add_argument("--traffic-seed", type=int, default=0)
    ap.add_argument("--policy", default="qos", choices=["qos", "naive"],
                    help="slot admission: QoS-aware weighted-fair windows "
                         "or a single global FIFO (the noisy-neighbour "
                         "baseline)")
    ap.add_argument("--debug-bundle", default=None, metavar="PATH",
                    help="with --traffic: write a postmortem zip (flight "
                         "journal, Perfetto trace, metrics text, "
                         "describe()) to PATH after the run")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("--device cuda, but torch finds no CUDA device")
    if args.tenants < 1:
        ap.error("--tenants must be >= 1")

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    run = make_run(cfg, args)
    device = torch.device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen, device=device)
    if args.traffic:
        _traffic_mode(run, cfg, params, args, device)
        return
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

    # --metrics wraps every decode step in a span fenced on its tokens: the
    # per-step wait changes the loop's overlap of host and card, so it is
    # opt-in and the untraced loop stays as it was.
    recorder = registry = None
    if args.metrics:
        recorder = TraceRecorder(process_name=f"serve:{args.arch}")
        registry = MetricsRegistry()

    tokens = torch.ones((args.batch,), dtype=torch.int32, device=device)
    emitted = []
    wall = MonotonicClock()
    t0 = wall.now_us()
    for i in range(args.steps):
        if recorder is not None:
            with recorder.span("decode_step", "round", step=i) as sp:
                tokens, state = step(params, state, tokens)
                recorder.fence(tokens)
            registry.observe_span(sp)
        else:
            tokens, state = step(params, state, tokens)
        emitted.append(tokens)
    out = torch.stack(emitted, 1).cpu()         # waits for the device
    dt = (wall.now_us() - t0) / 1e6
    print(f"arch={cfg.name} kv={args.kv} batch={args.batch} "
          f"steps={args.steps} device={device}")
    if bridged:
        print(f"bridge: num_nodes={args.num_nodes} channels={args.channels} "
              f"fused={run.bridge.fused}")
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
        if registry is not None:
            registry.observe_telemetry(telem)
            registry.observe_aggregator(agg)
    if registry is not None:
        print("metrics:")
        for line in registry.to_text().splitlines():
            print(" ", line)
    if recorder is not None and args.trace_out:
        recorder.write(args.trace_out)
        print(f"trace: {args.trace_out} ({len(recorder.spans)} spans; open "
              f"at https://ui.perfetto.dev)")


def make_run(cfg, args) -> RunConfig:
    shape = ShapeConfig("cli", args.max_len, args.batch, "decode")
    return RunConfig(model=cfg, shape=shape, kv_placement=args.kv,
                     bridge=BridgeConfig(channels=args.channels,
                                         fused=not args.no_fused))


def _traffic_mode(run, cfg, params, args, device) -> dict:
    """Request-level serving over the real decode step: an orchestrated pool
    with two tenants (``chat``, interactive, share 3; ``crawl``, batch,
    share 1), the continuous batcher over ``args.batch`` slots on a wall
    clock, the decode engine on ``device`` and a seeded two-tenant arrival
    stream.  With ``--metrics`` or ``--trace-out`` the batcher carries a
    trace recorder on the same clock.  Prints the run's report and returns
    it (``result``) with the ``orc``, ``batcher`` and ``engine`` that ran."""
    slots = args.batch
    pages_per_seq = -(-args.max_len // args.page_tokens)
    # Pool sized for the slot count (plus headroom so admission, not raw
    # capacity, is the governing control).
    cp = ControlPlane(4, slots * pages_per_seq,
                      num_logical=4 * slots * pages_per_seq,
                      seed=args.traffic_seed, device=device)
    orc = Orchestrator(cp, budget=run.bridge.epoch_budget,
                       control_period=4, migrate=False)
    orc.register(TenantSpec(1, "chat", qos="interactive", share=3.0))
    orc.register(TenantSpec(2, "crawl", qos="batch", share=1.0))
    clock = MonotonicClock()
    recorder = (TraceRecorder(clock, process_name=f"serve:{cfg.name}")
                if args.metrics or args.trace_out else None)
    batcher = ContinuousBatcher(orc, num_slots=slots,
                                page_tokens=args.page_tokens,
                                policy=args.policy, clock=clock,
                                recorder=recorder)
    engine = ModelDecodeEngine(run, params, batch=slots,
                               max_len=args.max_len,
                               page_tokens=args.page_tokens,
                               num_nodes=args.num_nodes,
                               dtype=torch_dtype(cfg.dtype), device=device)
    # Lengths cap: a sequence's prompt + output must fit max_len.
    pmax = max(args.max_len // 2, 2)
    omax = max(args.max_len - pmax, 1)
    traffic = TrafficGenerator([
        TenantTraffic(1, rate=args.traffic_rate, prompt_mean=pmax // 4 or 1,
                      output_mean=omax // 4 or 1, prompt_max=pmax,
                      output_max=omax, vocab=cfg.vocab_size),
        TenantTraffic(2, rate=args.traffic_rate,
                      prompt_mean=pmax // 2 or 1, output_mean=omax // 2 or 1,
                      prompt_max=pmax, output_max=omax,
                      vocab=cfg.vocab_size),
    ], seed=args.traffic_seed)

    t0 = clock.now_us()
    result = serve_loop(batcher, engine, traffic, steps=args.traffic_steps)
    dt = (clock.now_us() - t0) / 1e6
    result.update(wall_s=dt, tokens_per_s=result["tokens"] / dt,
                  decode_steps=engine.steps,
                  latency_steps=batcher.registry.family_quantiles(
                      "serve_request_steps"))
    print(f"arch={cfg.name} kv={args.kv} slots={args.batch} "
          f"policy={args.policy} device={device}")
    print(batcher.describe())
    print(f"{result['completed']}/{result['submitted']} requests, "
          f"{result['tokens']} tokens in {result['steps']} steps, "
          f"{engine.steps} decode steps ({dt:.1f}s wall, "
          f"{result['tokens_per_s']:.1f} tokens/s)")
    for qos, lat in result["latency_steps"].items():
        us, ttft = result["latency_us"][qos], result["ttft_us"][qos]
        print(f"  {qos}: {lat['count']} requests, latency p50="
              f"{lat['p50']:.0f} p99={lat['p99']:.0f} steps, p50="
              f"{us['p50']:.0f} p99={us['p99']:.0f} us; ttft p50="
              f"{ttft['p50']:.0f} p99={ttft['p99']:.0f} us")
    if recorder is not None:
        per_step = {name: [s.duration_us for s in recorder.find_all(name)]
                    for name in ("control", "decode_step")}
        result.update(
            control_us=statistics.median(per_step["control"]),
            decode_ms=statistics.median(per_step["decode_step"]) / 1e3)
        print(f"  host us of batcher.control() a step (median of "
              f"{len(per_step['control'])}): {result['control_us']:.1f}; "
              f"ms a decode step (median of {len(per_step['decode_step'])})"
              f": {result['decode_ms']:.2f}")
    print(orc.admission.describe())
    if args.metrics:
        print("metrics:")
        for line in batcher.registry.to_text().splitlines():
            print(" ", line)
    if recorder is not None and args.trace_out:
        recorder.write(args.trace_out)
        print(f"trace: {args.trace_out} ({len(recorder.spans)} spans)")
    if args.debug_bundle:
        path = orc.dump_debug_bundle(args.debug_bundle, trace=recorder)
        print(f"debug bundle: {path} "
              f"({len(orc.flight)} decision records)")
    return dict(orc=orc, batcher=batcher, engine=engine, result=result)


if __name__ == "__main__":
    main()
