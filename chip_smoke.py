#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU (an H100: kernels are sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero and
prints no result):

1. build    — compile every kernel under src/repro_torch/kernels/csrc, one
              nvcc per source, all started together;
2. kernels  — each kernel against its plain PyTorch version at the shapes
              the decode paths give it (page rows of 16 x 8 x 128 bf16):
              the one-node path's W = 8 lanes (gather, scatter, stream) and
              one round of the 8-node path (gather into the [8, 8, 8]-lane
              send buffer, pull_commit, push_commit at channels 1 and 2,
              stream over W = 64 lanes): data movement bit-exact, the
              streaming accumulate within float32 rounding; times of kernel,
              plain version and one equivalent PyTorch call, beside the
              bound;
3. full     — granite-3-8b at full width and depth (40 layers, d_model 4096,
              32/8 heads, vocab 49155) in bf16 with weights from a seeded
              generator: batch 8, max_len 1024, page_tokens 16, budget 8,
              channels 1, 48 decode steps.  ``local`` is fed a 40-token
              random prompt, then decodes greedily; ``bridge_pull`` on one
              memory node and on 8 (the pool striped over a node axis, the
              default bidirectional route program) is fed the same tokens
              and its logits are held to local's.  Each path's kernels must
              launch exactly the counts its shapes give, counted from 0 just
              before the path runs;
4. reduced  — reduced granite-3-8b in float32, a 16-token prompt then
              greedy: ``local`` and ``bridge_pull`` (1 and 8 nodes) emit
              identical tokens and logits within 1e-4;
5. programs — the software-defined check: pull and push on one 8-node pool
              under each of the route-program constructors back to back,
              bit-exact against the plain path on a CPU copy, with no nvcc
              run; then one 8-node pull and push under
              ``torch.cuda.set_sync_debug_mode("error")``;
6. report   — one JSON line listing every ported kernel, the card's name and
              power limit, then the result line.

Phases 3 and 4 also run ``bridge_pull`` with planted faults and fail unless
their own limit rejects them: the last live lane of every pulled round
dropped (a bridge that loses a page), and, on 8 nodes, a route program
pruned of ring distance 4, which carries traffic.  Random weights repeat a
token once decoding turns greedy; the prompt is what makes the KV pages
differ enough for a lost page to show in the logits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.config import (BridgeConfig, RunConfig,  # noqa: E402
                                ShapeConfig)
from repro_torch.core import bridge, kvbridge, steering  # noqa: E402
from repro_torch.core.memport import MemPortTable  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bridge_attention as ba  # noqa: E402
from repro_torch.kernels import bridge_gather as bg  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import step as serve_step  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
STREAM_TOL = dict(rtol=1e-5, atol=1e-5)   # float32: only sum order differs
# bf16 full width: local and bridge_pull round their attention outputs to
# bf16 from float32 values that differ in the last float32 bits, and a
# one-ulp bf16 flip (2**-8 relative) travels through 40 layers; hold the
# largest logit difference to 5% of the largest logit.
FULL_LOGIT_REL_TOL = 5e-2
# float32 reduced model: the placements differ only in sum order.
REDUCED_LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NODES = 8                        # memory nodes of the N-node path
PATHS = {"1-node": 1, f"{NODES}-node": NODES}

KERNELS = {
    "gather_pages": dict(
        fn=bg.gather_pages, source="src/repro_torch/kernels/csrc/bridge_gather.cu",
        replaces="src/repro/kernels/bridge_gather.py:120",
        paths=("1-node", "8-node")),
    "pull_commit": dict(
        fn=bg.pull_commit, source="src/repro_torch/kernels/csrc/bridge_gather.cu",
        replaces="src/repro/kernels/bridge_gather.py:180", paths=("8-node",)),
    "push_commit": dict(
        fn=bg.push_commit, source="src/repro_torch/kernels/csrc/bridge_gather.cu",
        replaces="src/repro/kernels/bridge_gather.py:281", paths=("8-node",)),
    "scatter_pages": dict(
        fn=bg.scatter_pages, source="src/repro_torch/kernels/csrc/bridge_gather.cu",
        replaces="src/repro/kernels/bridge_gather.py:325", paths=("1-node",)),
    "stream_decode_accumulate": dict(
        fn=ba.stream_decode_accumulate,
        source="src/repro_torch/kernels/csrc/bridge_attention.cu",
        replaces="src/repro/kernels/bridge_attention.py:124",
        paths=("1-node", "8-node")),
}


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time of ``fn`` on the card over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def reset_launches() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0


def read_launches() -> dict:
    return {name: k["fn"].launches for name, k in KERNELS.items()}


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def record(report: dict, name: str, path: str, *, err: float, ms: float,
           plain_ms: float, library_ms, nbytes: int, flops: int = 0,
           note: str = "") -> None:
    """Keep one kernel measurement, with its bound: the larger of the bytes
    it must move over HBM's rate and its float32 operations over the
    card's float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
    report[name].setdefault("by_path", {})[path] = entry
    lib = "null" if library_ms is None else f"{library_ms:.4f}"
    print(f"kernel {name} [{path}{note}]: {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {entry['bound_ms']:.6f} ms ({entry['bound_by']}), "
          f"library {lib} ms, max_abs_err {err:.3g}")


def check_stream(report, path, q, kp, vp, seq, lv, m, l, o) -> None:
    got = ba.stream_decode_accumulate(q, kp, vp, seq, lv, m, l, o)
    want = ba.stream_decode_accumulate_plain(q, kp, vp, seq, lv, m, l, o)
    err = 0.0
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, **STREAM_TOL)
        err = max(err, float((g_ - w_).abs().max()))
    b, h, hd = q.shape
    w, t, kv, _ = kp.shape
    n_live = int(lv.sum())
    n_seq = len(set(seq[lv.bool()].tolist()))   # q is read for these only
    page_bytes = t * kv * hd * kp.element_size()
    state_bytes = (2 * b * h + b * h * hd) * 4
    record(report, "stream_decode_accumulate", path, err=err,
           ms=cuda_ms(lambda: ba.stream_decode_accumulate(
               q, kp, vp, seq, lv, m, l, o)),
           plain_ms=cuda_ms(lambda: ba.stream_decode_accumulate_plain(
               q, kp, vp, seq, lv, m, l, o), iters=20),
           library_ms=None,
           nbytes=(n_seq * h * hd * q.element_size() + 2 * n_live * page_bytes
                   + 2 * state_bytes + 2 * w * 4),
           flops=n_live * (4 * h * t * hd + h * t), note=f", W={w}")


def check_gather(report, path, pool, reqs) -> torch.Tensor:
    pool2 = pool.view(pool.shape[0], -1)
    row_bytes = pool2.shape[1] * pool2.element_size()
    got = bg.gather_pages(pool, reqs)
    flat = reqs.reshape(-1)
    want = bg.gather_pages_plain(pool2, flat).view_as(got)
    if not torch.equal(got, want):
        raise AssertionError(f"gather_pages disagrees with its plain "
                             f"version ({path})")
    mask = (flat >= 0)[:, None].to(pool.dtype)
    safe = flat.clamp(min=0)
    record(report, "gather_pages", path, err=0.0,
           ms=cuda_ms(lambda: bg.gather_pages(pool, reqs)),
           plain_ms=cuda_ms(lambda: bg.gather_pages_plain(pool2, flat)),
           library_ms=cuda_ms(lambda: torch.index_select(pool2, 0, safe)
                              * mask),
           nbytes=(int((flat >= 0).sum()) + flat.numel()) * row_bytes
           + flat.numel() * 4, note=f", W={flat.numel()}")
    return got


def nnode_round(dev, rows: int, ppn: int):
    """One round of the 8-node decode path at full width: the pool striped
    over the nodes, node j pulling the first 8 pages of sequence j."""
    table = MemPortTable.striped(rows, NODES, ppn, device=dev)
    program = steering.bidirectional_program(NODES, device=dev)
    ab = bridge._budget_vec(None, NODES, 8, dev)
    max_pages = rows // NODES
    want = (torch.arange(NODES, device=dev)[:, None] * max_pages
            + torch.arange(8, device=dev)[None, :]).to(torch.int32)
    return table, program, ab, want


def check_kernels(report: dict, dev="cuda") -> None:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    b, h, kv, hd, t, w = 8, 32, 8, 128, 16, 8
    rows = b * (1024 // t)                     # the full-width pool: 512 pages
    ppn = rows // NODES
    pool = torch.randn((rows, t, kv, hd), generator=gen, device=dev).bfloat16()
    pool_v = torch.randn((rows, t, kv, hd), generator=gen,
                         device=dev).bfloat16()
    pool2 = pool.view(rows, -1)
    row_bytes = pool2.shape[1] * pool2.element_size()

    # -- one-node path: W = 8 lanes ------------------------------------------
    check_gather(report, "1-node", pool,
                 torch.tensor([5, -1, 130, 7, 511, -1, 0, 64],
                              dtype=torch.int32, device=dev))
    # scatter: one FREE lane and a live duplicate (the later lane wins)
    slots = torch.tensor([3, 90, -1, 200, 3, 17, 400, 511], dtype=torch.int32,
                         device=dev)
    data = torch.randn((w, t, kv, hd), generator=gen, device=dev).bfloat16()
    pool_k, pool_p = pool.clone(), pool.clone()
    bg.scatter_pages(pool_k, slots, data)
    bg.scatter_pages_plain(pool_p.view(rows, -1), slots, data.view(w, -1))
    if not torch.equal(pool_k, pool_p):
        raise AssertionError("scatter_pages disagrees with its plain version")
    written = [i for i, s in enumerate(slots.tolist())
               if s >= 0 and s not in slots.tolist()[i + 1:]]
    lib_idx = slots[written].long()
    lib_data = data.view(w, -1)[written]
    record(report, "scatter_pages", "1-node", err=0.0,
           ms=cuda_ms(lambda: bg.scatter_pages(pool_k, slots, data)),
           plain_ms=cuda_ms(lambda: bg.scatter_pages_plain(
               pool_p.view(rows, -1), slots, data.view(w, -1))),
           library_ms=cuda_ms(lambda: pool_p.view(rows, -1).index_copy_(
               0, lib_idx, lib_data)),
           nbytes=2 * len(written) * row_bytes + slots.numel() * 4)
    # stream: lanes of three sequences and two dead lanes, mid-decode state
    q = torch.randn((b, h, hd), generator=gen, device=dev).bfloat16()
    m = torch.randn((b, h), generator=gen, device=dev)
    l = torch.rand((b, h), generator=gen, device=dev) + 0.5
    o = torch.randn((b, h, hd), generator=gen, device=dev)
    kp = torch.randn((w, t, kv, hd), generator=gen, device=dev).bfloat16()
    vp = torch.randn((w, t, kv, hd), generator=gen, device=dev).bfloat16()
    seq = torch.tensor([0, 0, 0, 3, 3, 5, -1, -1], dtype=torch.int32,
                       device=dev)
    check_stream(report, "1-node", q, kp, vp, seq, (seq >= 0).to(torch.int32),
                 m, l, o)

    # -- 8-node path: one pulled round and one flush --------------------------
    table, program, ab, want = nnode_round(dev, rows, ppn)
    for channels in (2, 1):   # budget 8: 8 lanes a round at either depth
        window = bridge._fused_window(want, 0, ab, channels * (8 // channels))
        send_rows, choice, loop_slot = bridge._pull_operands(
            window, table, program, NODES, ppn)
        send = bg.gather_pages(pool, send_rows)
        got = bg.pull_commit(pool, send, choice, loop_slot)
        want_pc = bg.pull_commit_plain(pool2, send.view(NODES, NODES, w, -1),
                                       choice, loop_slot).view_as(got)
        if not torch.equal(got, want_pc):
            raise AssertionError(f"pull_commit disagrees with its plain "
                                 f"version (channels {channels})")
    send = check_gather(report, "8-node", pool, send_rows)
    send_v = bg.gather_pages(pool_v, send_rows)
    live_rows = int((choice >= 0).sum())
    record(report, "pull_commit", "8-node", err=0.0,
           ms=cuda_ms(lambda: bg.pull_commit(pool, send, choice, loop_slot)),
           plain_ms=cuda_ms(lambda: bg.pull_commit_plain(
               pool2, send.view(NODES, NODES, w, -1), choice, loop_slot)),
           library_ms=None,
           nbytes=(live_rows + choice.numel()) * row_bytes
           + 2 * choice.numel() * 4)
    k_r = got.view(NODES * w, t, kv, hd)
    v_r = bg.pull_commit(pool_v, send_v, choice, loop_slot).view_as(k_r)
    wflat = want.reshape(-1)
    check_stream(report, "8-node", q, k_r, v_r,
                 torch.where(wflat >= 0, wflat // (rows // b), -1),
                 (wflat >= 0).to(torch.int32), m, l, o)

    # push: every sequence flushes its page 3, so home 3 lands 8 writes
    dest = (torch.arange(NODES, device=dev)[:, None] * (rows // b) + 3).to(
        torch.int32)
    payload = torch.randn((NODES, 1, t, kv, hd), generator=gen,
                          device=dev).bfloat16()
    base = torch.zeros((NODES,), dtype=torch.int32, device=dev)
    for channels in (2, 1):
        cb = -(-8 // channels)
        pw = bridge._fused_window(dest, 0, ab, channels * cb)
        pslots = bridge._push_slots(pw, table, program, NODES)
        pool_k, pool_p = pool.clone(), pool.clone()
        bg.push_commit(pool_k, pslots, payload, base, channels=channels, cb=cb)
        bg.push_commit_plain(pool_p.view(rows, -1), pslots,
                             payload.view(NODES, 1, -1), base, channels, cb)
        if not torch.equal(pool_k, pool_p):
            raise AssertionError(f"push_commit disagrees with its plain "
                                 f"version (channels {channels})")
    # the rows the commit resolves, for index_copy_ and the bound
    pairs = {}
    for hh, k, lane in (pslots >= 0).nonzero().tolist():
        pairs[hh * ppn + int(pslots[hh, k, lane])] = (hh - k) % NODES
    lib_idx = torch.tensor(sorted(pairs), device=dev)
    lib_data = payload.view(NODES, -1)[[pairs[r] for r in sorted(pairs)]]
    record(report, "push_commit", "8-node", err=0.0,
           ms=cuda_ms(lambda: bg.push_commit(pool_k, pslots, payload, base,
                                             channels=1, cb=8)),
           plain_ms=cuda_ms(lambda: bg.push_commit_plain(
               pool_p.view(rows, -1), pslots, payload.view(NODES, 1, -1),
               base, 1, 8)),
           library_ms=cuda_ms(lambda: pool_p.view(rows, -1).index_copy_(
               0, lib_idx, lib_data)),
           nbytes=2 * len(pairs) * row_bytes + (pslots.numel() + NODES) * 4,
           note=", channels=1")


# ---------------------------------------------------------------------------
# Phases 3 and 4: decode through the serve path
# ---------------------------------------------------------------------------

def decode(cfg, params, kv, batch, max_len, page_tokens, steps, feed, *,
           num_nodes=1, program=None, dtype=torch.bfloat16, dev="cuda"):
    """Decode ``steps`` steps: fed the input tokens ``feed`` [n, B] for the
    first n steps, greedy after; ``program`` replaces the route program in
    the shared state.  Returns (inputs, logits, per-step ms, a callable
    that runs one more step)."""
    run = RunConfig(model=cfg, shape=ShapeConfig("smoke", max_len, batch,
                                                 "decode"), kv_placement=kv,
                    bridge=BridgeConfig(channels=1))
    ops = serve_step.make_cache_ops(run, max_len, page_tokens,
                                    num_nodes=num_nodes, dtype=dtype,
                                    device=dev)
    state = serve_step.init_serve_state(run, batch, ops)
    if program is not None:
        state["kv_shared"]["program"] = program
    tokens = None
    inputs, logits_all, times = [], [], []
    for i in range(steps):
        if i < feed.shape[0]:
            tokens = feed[i]
        inputs.append(tokens)
        sync(dev)
        t0 = time.perf_counter()
        logits, state = transformer.decode_step(cfg, params, state, tokens,
                                                ops)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        logits_all.append(logits)
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)

    def one_more():
        transformer.decode_step(cfg, params, state, tokens, ops)

    return torch.stack(inputs), torch.stack(logits_all), times, one_more


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def planted_fault():
    """Drop the last live lane of every pulled round: a bridge that loses a
    page.  The checks of phases 3 and 4 must reject what this produces."""
    real = kvbridge.stream_decode_accumulate

    def lossy(q, k, v, seq, live, m, l, o):
        lane = torch.arange(live.shape[0], device=live.device)
        last = torch.where(live > 0, lane, -1).max()
        return real(q, k, v, seq, live * (lane != last), m, l, o)

    kvbridge.stream_decode_accumulate = lossy
    try:
        yield
    finally:
        kvbridge.stream_decode_accumulate = real


def unwired_distance_4(dev) -> steering.RouteProgram:
    """The bidirectional program pruned of ring distance 4: with the pool
    striped over 8 nodes, an eighth of every sequence's pages lie 4 hops
    from its node, so their flushes and pulls are dropped."""
    return steering.pruned_program(
        steering.bidirectional_program(NODES, device=dev), [1, 2, 3, 5, 6, 7])


def worst_rel_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest per-step max-abs logit difference over the step's largest
    logit; got, want: [steps, B, V]."""
    diff = (got.float() - want.float()).abs().amax(dim=(1, 2))
    return float((diff / want.float().abs().amax(dim=(1, 2))).max())


def profile_step(label: str, run_step) -> dict:
    """Profile one decode step: wall time, summed kernel time on the card,
    the port's kernels' launches and mean times, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    ours = {k: [(e.count, e.self_device_time_total / 1e3 / e.count)
                for e in kernels if k in e.key]
            for k in ("gather_rows", "pull_commit_rows", "push_commit_rows",
                      "scatter_rows", "stream_kernel")}
    out = dict(wall_ms=wall, device_ms=device,
               device_busy_share=device / wall if device else None,
               kernel_launches=sum(e.count for e in kernels),
               top_kernels=[(e.key[:60], e.count,
                             e.self_device_time_total / 1e3) for e in top],
               port_kernels_count_and_mean_device_ms=ours)
    print(f"profile {label}:", json.dumps(out))
    return out


def expected_launches(num_nodes, batch, max_pages, budget, layers) -> dict:
    """Kernel launches of one decode step of bridge_pull, from its shapes."""
    per_node = -(-batch // num_nodes)
    rounds = -(-per_node * max_pages // budget)
    if num_nodes == 1:
        return dict(gather_pages=2 * rounds * layers, pull_commit=0,
                    push_commit=0, scatter_pages=2 * layers,
                    stream_decode_accumulate=rounds * layers)
    return dict(gather_pages=2 * rounds * layers,
                pull_commit=2 * rounds * layers, push_commit=2 * layers,
                scatter_pages=0, stream_decode_accumulate=rounds * layers)


FULL = dict(batch=8, max_len=1024, page_tokens=16, steps=48, prompt=40,
            fault_steps=24)


def full_width(report: dict, dev="cuda") -> dict:
    cfg = configs.get_config("granite-3-8b")
    batch, max_len, page_tokens, steps = (FULL[k] for k in (
        "batch", "max_len", "page_tokens", "steps"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen, device=dev)
    sync(dev)
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"full: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads} vocab {cfg.vocab_size}: "
          f"{n_params} bf16 params ({n_params * 2 / 1e9:.2f} GB) made in "
          f"{time.perf_counter() - t0:.1f} s")
    fault_steps = FULL["fault_steps"]
    prompt = torch.randint(0, cfg.vocab_size, (FULL["prompt"], batch),
                           generator=gen, device=dev, dtype=torch.int32)
    shape = (batch, max_len, page_tokens)
    inputs, local_logits, local_ms, local_next = decode(
        cfg, params, "local", *shape, steps, prompt, dev=dev)
    out = dict(local_ms_per_step=statistics.median(local_ms[1:]),
               local_first_step_ms=local_ms[0])
    profile_step("local", local_next)
    del local_next
    for path, n in PATHS.items():
        reset_launches()
        _, pull_logits, pull_ms, pull_next = decode(
            cfg, params, "bridge_pull", *shape, steps, inputs, num_nodes=n,
            dev=dev)
        counts = read_launches()
        want = expected_launches(n, batch, -(-max_len // page_tokens), 8,
                                 cfg.num_layers)
        for name, k in KERNELS.items():
            per_step = counts[name] / steps
            report[name]["launches"] += counts[name]
            if path in k["paths"]:
                report[name]["by_path"][path]["launches"] = counts[name]
                report[name]["by_path"][path]["launches_per_step"] = per_step
                if counts[name] == 0:
                    raise AssertionError(f"{path} bridge_pull never "
                                         f"launched {name}")
            if per_step != want[name]:
                raise AssertionError(f"{path}: {name} launched {per_step} "
                                     f"times a step, expected {want[name]}")
        if not (torch.isfinite(local_logits).all()
                and torch.isfinite(pull_logits).all()):
            raise AssertionError(f"non-finite logits at full width ({path})")
        worst = worst_rel_diff(pull_logits, local_logits)
        if worst > FULL_LOGIT_REL_TOL:
            raise AssertionError(f"{path} bridge_pull logits differ from "
                                 f"local by {worst:.3g} of the largest logit")
        agree = float((pull_logits.argmax(-1) == local_logits.argmax(-1))
                      .float().mean())
        faults = {}
        with planted_fault():
            _, fault_logits, _, _ = decode(
                cfg, params, "bridge_pull", *shape, fault_steps, inputs,
                num_nodes=n, dev=dev)
        faults["lost_lane"] = worst_rel_diff(fault_logits,
                                             local_logits[:fault_steps])
        if n > 1:
            _, fault_logits, _, _ = decode(
                cfg, params, "bridge_pull", *shape, fault_steps, inputs,
                num_nodes=n, program=unwired_distance_4(dev), dev=dev)
            faults["unwired_distance_4"] = worst_rel_diff(
                fault_logits, local_logits[:fault_steps])
        for fault, rel in faults.items():
            if not rel > FULL_LOGIT_REL_TOL:
                raise AssertionError(
                    f"{path} planted fault {fault} moved the logits by only "
                    f"{rel:.3g} of the largest: the full-width check would "
                    f"pass it")
        out[path] = dict(
            bridge_pull_ms_per_step=statistics.median(pull_ms[1:]),
            bridge_pull_first_step_ms=pull_ms[0], greedy_agreement=agree,
            worst_logit_rel_diff=worst,
            planted_faults_worst_logit_rel_diff=faults,
            launches_per_step={k: c / steps for k, c in counts.items()})
        out[path]["profile"] = profile_step(f"bridge_pull {path}", pull_next)
        del pull_next
    out.update(pages_flushed_per_sequence=steps // page_tokens,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("full:", json.dumps({k: v for k, v in out.items()
                               if not isinstance(v, dict)}))
    for path in PATHS:
        print(f"full {path}:", json.dumps({k: v for k, v in out[path].items()
                                            if k != "profile"}))
    del params
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def reduced_f32(dev="cuda") -> None:
    cfg = dataclasses.replace(configs.get_reduced("granite-3-8b"),
                              dtype="float32")
    batch, max_len, page_tokens, steps = 4, 64, 8, 24
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (16, batch), generator=gen,
                           device=dev, dtype=torch.int32)
    args = (cfg, params)
    shape = (batch, max_len, page_tokens, steps)
    kw = dict(dtype=torch.float32, dev=dev)
    local_in, local_logits, _, _ = decode(*args, "local", *shape, prompt, **kw)
    for path, n in PATHS.items():
        pull_in, pull_logits, _, _ = decode(*args, "bridge_pull", *shape,
                                            prompt, num_nodes=n, **kw)
        if not torch.equal(local_in, pull_in):
            raise AssertionError(f"reduced f32: local and {path} bridge_pull "
                                 f"tokens differ")
        torch.testing.assert_close(pull_logits, local_logits,
                                   **REDUCED_LOGIT_TOL)
        err = float((pull_logits - local_logits).abs().max())
        with planted_fault():
            _, fault_logits, _, _ = decode(*args, "bridge_pull", *shape,
                                           local_in, num_nodes=n, **kw)
        fault = float((fault_logits - local_logits).abs().max())
        if torch.allclose(fault_logits, local_logits, **REDUCED_LOGIT_TOL):
            raise AssertionError(f"reduced f32 {path}: a lost page moved the "
                                 f"logits by only {fault:.3g}: the check "
                                 f"would pass it")
        print(f"reduced {path}: float32 local == bridge_pull over {steps} "
              f"steps x {batch} sequences (16 prompt + {steps - 16} greedy;"
              f" sample {local_in[16:, 0].tolist()}), max logit difference "
              f"{err:.3g}; planted fault {fault:.3g}")


# ---------------------------------------------------------------------------
# Phase 5: route programs swap at run time
# ---------------------------------------------------------------------------

def program_variants(dev) -> dict:
    bi = steering.bidirectional_program(NODES, device=dev)
    return {
        "unidirectional": steering.unidirectional_program(NODES, device=dev),
        "bidirectional": bi,
        "pruned": steering.pruned_program(bi, [1, 2, 7]),
        "load_balanced": steering.load_balanced_program(
            NODES, [1.0 + (d % 3) for d in range(1, NODES)], device=dev),
        "link_avoiding": steering.link_avoiding_program(NODES, 1, device=dev),
        "hierarchical": steering.hierarchical_program(Topology.boards(2, 4),
                                                      device=dev),
        "masked_ranks": steering.masked_ranks_program(
            bi, [[r % 3 != 1 for r in range(NODES)]] * (NODES - 1)),
    }


def programs_swap(dev="cuda") -> dict:
    """Pull and push under every program back to back on one card pool,
    bit-exact against the plain path on a CPU copy, building nothing;
    then one round trip under the sync debugger."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    ppn, page = 16, (16, 8, 128)
    pool_c = torch.randn((NODES * ppn,) + page, generator=gen).bfloat16()
    table_c = MemPortTable.striped(NODES * ppn, NODES, ppn, device="cpu")
    want_c = torch.randint(-1, NODES * ppn, (NODES, 12), generator=gen,
                           dtype=torch.int32)
    dest_c = torch.randperm(NODES * ppn, generator=gen)[:NODES * 6].view(
        NODES, 6).to(torch.int32)
    pay_c = torch.randn((NODES, 6) + page, generator=gen).bfloat16()
    ab_c = torch.tensor([8, 3, 8, 5, 8, 8, 1, 8], dtype=torch.int32)
    pool_g = pool_c.to(dev)
    table_g = MemPortTable(table_c.home.to(dev), table_c.slot.to(dev))
    want_g, dest_g, pay_g, ab_g = (x.to(dev) for x in (want_c, dest_c, pay_c,
                                                        ab_c))
    variants = program_variants(dev)
    runs_before = _build.nvcc_runs
    kw = dict(num_nodes=NODES, budget=8, channels=2)
    for name, prog in variants.items():
        prog_c = prog.to("cpu")
        for ab in (None, (ab_g, ab_c)):
            ab_dev, ab_cpu = (None, None) if ab is None else ab
            got = bridge.pull_pages(pool_g, want_g, table_g, program=prog,
                                    active_budget=ab_dev, **kw)
            want = bridge.pull_pages(pool_c, want_c, table_c, program=prog_c,
                                     active_budget=ab_cpu, **kw)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"8-node pull under {name} disagrees "
                                     f"with the plain path")
            bridge.push_pages(pool_g, dest_g, pay_g, table_g, program=prog,
                              active_budget=ab_dev, **kw)
            bridge.push_pages(pool_c, dest_c, pay_c, table_c, program=prog_c,
                              active_budget=ab_cpu, **kw)
            if not torch.equal(pool_g.cpu(), pool_c):
                raise AssertionError(f"8-node push under {name} disagrees "
                                     f"with the plain path")
    if _build.nvcc_runs != runs_before:
        raise AssertionError("swapping route programs ran nvcc")
    prog = variants["hierarchical"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pulled = bridge.pull_pages(pool_g, want_g, table_g, program=prog,
                                   active_budget=ab_g, **kw)
        bridge.push_pages(pool_g, dest_g, pay_g, table_g, program=prog,
                          active_budget=ab_g, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not torch.isfinite(pulled.float()).all():
        raise AssertionError("sync-debug round trip pulled non-finite pages")
    out = dict(programs=list(variants), nvcc_runs_during_swaps=0,
               sync_debug_round_trip="ok")
    print("programs:", json.dumps(out))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    # float32 products in full float32 on the card, as in the reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {', '.join(_build.sources())} in "
          f"{time.perf_counter() - t0:.1f} s")

    report = {name: dict(name=name, route="cuda", source=k["source"],
                         replaces=k["replaces"], launches=0)
              for name, k in KERNELS.items()}
    check_kernels(report)
    # The top-level numbers of a kernel are those at the 8-node path's
    # shapes where it runs there (scatter runs on the 1-node path only);
    # ``by_path`` keeps every path's.
    for name, r in report.items():
        path = "8-node" if "8-node" in r["by_path"] else "1-node"
        r.update({k: v for k, v in r["by_path"][path].items()
                  if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")})
    full_width(report)
    reduced_f32()
    programs_swap()
    print(f"smoke: {time.perf_counter() - t0:.1f} s after the build started")

    print(json.dumps({"kernels": list(report.values())}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
