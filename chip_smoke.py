#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU (an H100: kernels are sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero and
prints no result):

1. build   — compile every kernel under src/repro_torch/kernels/csrc, one
             nvcc per source, all started together;
2. kernels — each kernel against its plain PyTorch version at the decode
             path's shapes (page rows of 16 x 8 x 128 bf16, W = 8 lanes,
             q [8, 32, 128]): gather and scatter bit-exact, the streaming
             accumulate within float32 rounding; times of kernel, plain
             version and one equivalent PyTorch call, beside the bound;
3. full    — granite-3-8b at full width and depth (40 layers, d_model 4096,
             32/8 heads, vocab 49155) in bf16 with weights from a seeded
             generator: batch 8, max_len 1024, page_tokens 16, budget 8,
             48 decode steps.  ``local`` is fed a 40-token random prompt,
             then decodes greedily; ``bridge_pull`` is fed the same tokens
             and its logits are held to local's.  Every kernel's launch
             count must move during the bridge run;
4. reduced — reduced granite-3-8b in float32, a 16-token prompt then
             greedy: ``local`` and ``bridge_pull`` emit identical tokens
             and logits within 1e-4;
5. report  — one JSON line listing every ported kernel, the card's name and
             power limit, then the result line.

Phases 3 and 4 also run ``bridge_pull`` once more with a planted fault (the
last live lane of every pulled round is dropped, as a bridge that loses a
page would) and fail unless their own limit rejects it: random weights
repeat a token once decoding turns greedy, and the prompt is what makes the
KV pages differ enough for a lost page to show in the logits.
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
from repro_torch.config import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.core import kvbridge  # noqa: E402
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

KERNELS = {
    "gather_pages": dict(
        fn=bg.gather_pages, source="src/repro_torch/kernels/csrc/bridge_gather.cu",
        replaces="src/repro/kernels/bridge_gather.py:120"),
    "scatter_pages": dict(
        fn=bg.scatter_pages, source="src/repro_torch/kernels/csrc/bridge_gather.cu",
        replaces="src/repro/kernels/bridge_gather.py:325"),
    "stream_decode_accumulate": dict(
        fn=ba.stream_decode_accumulate,
        source="src/repro_torch/kernels/csrc/bridge_attention.cu",
        replaces="src/repro/kernels/bridge_attention.py:124"),
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


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_kernels(report: dict) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    b, h, kv, hd, t, w = 8, 32, 8, 128, 16, 8
    rows = b * (1024 // t)                     # the full-width pool: 512 pages
    pool = torch.randn((rows, t, kv, hd), generator=gen, device=dev).bfloat16()
    pool2 = pool.view(rows, -1)
    row_bytes = pool2.shape[1] * pool2.element_size()

    # gather: two FREE lanes among live ones
    reqs = torch.tensor([5, -1, 130, 7, 511, -1, 0, 64], dtype=torch.int32,
                        device=dev)
    got = bg.gather_pages(pool, reqs)
    want = bg.gather_pages_plain(pool2, reqs).view_as(got)
    if not torch.equal(got, want):
        raise AssertionError("gather_pages disagrees with its plain version")
    live = int((reqs >= 0).sum())
    mask = (reqs >= 0)[:, None].to(pool.dtype)
    safe = reqs.clamp(min=0)
    report["gather_pages"].update(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: bg.gather_pages(pool, reqs)),
        plain_ms=cuda_ms(lambda: bg.gather_pages_plain(pool2, reqs)),
        library_ms=cuda_ms(lambda: torch.index_select(pool2, 0, safe) * mask),
        bound_ms=(live * row_bytes + w * row_bytes + reqs.numel() * 4)
        / HBM_BYTES_PER_S * 1e3, bound_by="bytes")

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
    report["scatter_pages"].update(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: bg.scatter_pages(pool_k, slots, data)),
        plain_ms=cuda_ms(lambda: bg.scatter_pages_plain(
            pool_p.view(rows, -1), slots, data.view(w, -1))),
        library_ms=cuda_ms(lambda: pool_p.view(rows, -1).index_copy_(
            0, lib_idx, lib_data)),
        bound_ms=(2 * len(written) * row_bytes + slots.numel() * 4)
        / HBM_BYTES_PER_S * 1e3, bound_by="bytes")

    # stream: lanes of three sequences and two dead lanes, mid-decode state
    q = torch.randn((b, h, hd), generator=gen, device=dev).bfloat16()
    kp = torch.randn((w, t, kv, hd), generator=gen, device=dev).bfloat16()
    vp = torch.randn((w, t, kv, hd), generator=gen, device=dev).bfloat16()
    seq = torch.tensor([0, 0, 0, 3, 3, 5, -1, -1], dtype=torch.int32,
                       device=dev)
    lv = (seq >= 0).to(torch.int32)
    m = torch.randn((b, h), generator=gen, device=dev)
    l = torch.rand((b, h), generator=gen, device=dev) + 0.5
    o = torch.randn((b, h, hd), generator=gen, device=dev)
    got = ba.stream_decode_accumulate(q, kp, vp, seq, lv, m, l, o)
    want = ba.stream_decode_accumulate_plain(q, kp, vp, seq, lv, m, l, o)
    err = 0.0
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, **STREAM_TOL)
        err = max(err, float((g_ - w_).abs().max()))
    n_live = int(lv.sum())
    n_seq = len(set(seq[lv.bool()].tolist()))   # q is read for these only
    page_bytes = t * kv * hd * kp.element_size()
    state_bytes = (2 * b * h + b * h * hd) * 4
    nbytes = (n_seq * h * hd * q.element_size() + 2 * n_live * page_bytes
              + 2 * state_bytes + 2 * w * 4)
    flops = n_live * (4 * h * t * hd + h * t)
    report["stream_decode_accumulate"].update(
        max_abs_err=err,
        ms=cuda_ms(lambda: ba.stream_decode_accumulate(
            q, kp, vp, seq, lv, m, l, o)),
        plain_ms=cuda_ms(lambda: ba.stream_decode_accumulate_plain(
            q, kp, vp, seq, lv, m, l, o), iters=50),
        library_ms=None,
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= flops / F32_FLOP_PER_S else "operations"))
    for name, r in report.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
              f" bound {r['bound_ms']:.6f} ms ({r['bound_by']}), library "
              f"{lib} ms, max_abs_err {r['max_abs_err']:.3g}")


# ---------------------------------------------------------------------------
# Phases 3 and 4: decode through the serve path
# ---------------------------------------------------------------------------

def decode(cfg, params, kv, batch, max_len, page_tokens, steps, feed, *,
           dtype=torch.bfloat16):
    """Decode ``steps`` steps: fed the input tokens ``feed`` [n, B] for the
    first n steps, greedy after.  Returns (inputs, logits, per-step ms, a
    callable that runs one more step)."""
    run = RunConfig(model=cfg, shape=ShapeConfig("smoke", max_len, batch,
                                                 "decode"), kv_placement=kv)
    ops = serve_step.make_cache_ops(run, max_len, page_tokens, dtype=dtype,
                                    device="cuda")
    state = serve_step.init_serve_state(run, batch, ops)
    tokens = None
    inputs, logits_all, times = [], [], []
    for i in range(steps):
        if i < feed.shape[0]:
            tokens = feed[i]
        inputs.append(tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = transformer.decode_step(cfg, params, state, tokens,
                                                ops)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        logits_all.append(logits)
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)

    def one_more():
        transformer.decode_step(cfg, params, state, tokens, ops)

    return torch.stack(inputs), torch.stack(logits_all), times, one_more


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


def worst_rel_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest per-step max-abs logit difference over the step's largest
    logit; got, want: [steps, B, V]."""
    diff = (got.float() - want.float()).abs().amax(dim=(1, 2))
    return float((diff / want.float().abs().amax(dim=(1, 2))).max())


def profile_step(label: str, run_step) -> dict:
    """Profile one decode step: wall time, summed kernel time on the card
    and the kernels that took the most of it."""
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
            for k in ("gather_rows", "scatter_rows", "stream_kernel")}
    out = dict(wall_ms=wall, device_ms=device,
               device_busy_share=device / wall if device else None,
               top_kernels=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
                            for e in top],
               port_kernels_count_and_mean_device_ms=ours)
    print(f"profile {label}:", json.dumps(out))
    return out


def full_width(report: dict) -> dict:
    cfg = configs.get_config("granite-3-8b")
    batch, max_len, page_tokens, steps = 8, 1024, 16, 48
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"full: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads} vocab {cfg.vocab_size}: "
          f"{n_params} bf16 params ({n_params * 2 / 1e9:.2f} GB) made in "
          f"{time.perf_counter() - t0:.1f} s")
    prompt_len, fault_steps = 40, 24
    prompt = torch.randint(0, cfg.vocab_size, (prompt_len, batch),
                           generator=gen, device="cuda", dtype=torch.int32)
    inputs, local_logits, local_ms, local_next = decode(
        cfg, params, "local", batch, max_len, page_tokens, steps, prompt)
    reset_launches()
    _, pull_logits, pull_ms, pull_next = decode(
        cfg, params, "bridge_pull", batch, max_len, page_tokens, steps,
        inputs)
    for name, k in KERNELS.items():
        report[name]["launches"] = k["fn"].launches
    for name, r in report.items():
        if r["launches"] == 0:
            raise AssertionError(f"bridge_pull decode never launched {name}")
    if not (torch.isfinite(local_logits).all()
            and torch.isfinite(pull_logits).all()):
        raise AssertionError("non-finite logits at full width")
    worst = worst_rel_diff(pull_logits, local_logits)
    if worst > FULL_LOGIT_REL_TOL:
        raise AssertionError(f"bridge_pull logits differ from local by "
                             f"{worst:.3g} of the largest logit")
    agree = float((pull_logits.argmax(-1) == local_logits.argmax(-1))
                  .float().mean())
    with planted_fault():
        _, fault_logits, _, _ = decode(
            cfg, params, "bridge_pull", batch, max_len, page_tokens,
            fault_steps, inputs)
    fault = worst_rel_diff(fault_logits, local_logits[:fault_steps])
    if not fault > FULL_LOGIT_REL_TOL:
        raise AssertionError(f"a lost page moved the logits by only "
                             f"{fault:.3g} of the largest: the full-width "
                             f"check would pass it")
    flushed = (steps // page_tokens)
    out = dict(local_ms_per_step=statistics.median(local_ms[1:]),
               bridge_pull_ms_per_step=statistics.median(pull_ms[1:]),
               local_first_step_ms=local_ms[0],
               bridge_pull_first_step_ms=pull_ms[0],
               greedy_agreement=agree, worst_logit_rel_diff=worst,
               planted_fault_worst_logit_rel_diff=fault,
               pages_flushed_per_sequence=flushed,
               launches_per_step={n: r["launches"] / steps
                                  for n, r in report.items()},
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("full:", json.dumps(out))
    profile_step("local", local_next)
    profile_step("bridge_pull", pull_next)
    del params, local_next, pull_next
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


def reduced_f32() -> None:
    cfg = dataclasses.replace(configs.get_reduced("granite-3-8b"),
                              dtype="float32")
    batch, max_len, page_tokens, steps = 4, 64, 8, 24
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (16, batch), generator=gen,
                           device="cuda", dtype=torch.int32)
    args = (cfg, params)
    shape = (batch, max_len, page_tokens, steps)
    local_in, local_logits, _, _ = decode(*args, "local", *shape, prompt,
                                          dtype=torch.float32)
    pull_in, pull_logits, _, _ = decode(*args, "bridge_pull", *shape, prompt,
                                        dtype=torch.float32)
    if not torch.equal(local_in, pull_in):
        raise AssertionError("reduced f32: local and bridge_pull tokens differ")
    torch.testing.assert_close(pull_logits, local_logits, **REDUCED_LOGIT_TOL)
    err = float((pull_logits - local_logits).abs().max())
    with planted_fault():
        _, fault_logits, _, _ = decode(*args, "bridge_pull", *shape,
                                       local_in, dtype=torch.float32)
    fault = float((fault_logits - local_logits).abs().max())
    if torch.allclose(fault_logits, local_logits, **REDUCED_LOGIT_TOL):
        raise AssertionError(f"reduced f32: a lost page moved the logits by "
                             f"only {fault:.3g}: the check would pass it")
    print(f"reduced: float32 local == bridge_pull over {steps} steps x "
          f"{batch} sequences (16 prompt + {steps - 16} greedy; sample "
          f"{local_in[16:, 0].tolist()}), max logit difference {err:.3g}; "
          f"planted fault {fault:.3g}")


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
    full_width(report)
    reduced_f32()

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
