#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU (an H100: kernels are sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero and
prints no result):

1. build    — compile every kernel under src/repro_torch/kernels/csrc, one
              nvcc per source, all started together;
2. kernels  — each kernel against its plain PyTorch version on the card:
              the decode paths' page kernels at their shapes (page rows of
              16 x 8 x 128 bf16; the one-node path's W = 8 lanes and one
              round of the 8-node path), bit-exact, and the streaming
              accumulate within float32 rounding; flash attention at the
              sequence forward's shapes (B 8, S 1024, 32/8 heads of 128,
              causal: the bf16 wgmma kernel on bf16 inputs, and the float32
              three-term TF32 kernel on float32 inputs, its bound three
              TF32 products beside one float32 product on the CUDA cores)
              and at the mask and head-size cases, a row that sees no key
              among them (float32 2e-5, bf16 2e-2; each call must launch
              the variant its dtype names); paged decode attention at the
              serving decode shapes (3e-5 / 3e-2; its two kernels' device
              time apart); the fold also at the decode paths' round kinds (all
              FREE and one sequence's 8 lanes at W = 8; 3 live lanes in
              each of 8 sequences at W = 64), both decode kernels bit-
              identical from call to call; the STREAM passes at the paper's
              10,000,000 elements and at 1,003, bit-exact; the two write
              kernels also on whole-pool flushes (scatter at W = 1,024 with
              FREE, out-of-pool and duplicate lanes; push_commit writing
              every slot of 8 homes, channels 1, 2 and 4), bit-exact.
              Times of kernel, plain version and one equivalent PyTorch
              call, beside the bound; the wrappers of gather, scatter,
              push_commit and every STREAM pass timed in turns with their
              library call (median of five rounds); for the gather and the
              write kernels the time of a call replayed from a CUDA graph
              of 100 calls; where a wrapper call's host time goes (the
              1-node gather, the fold's live W = 8 round, STREAM scale bf16
              and the write kernels); and
              each kernel's device time from the profiler, taken after
              every host timing of the phase;
3. full     — granite-3-8b at full width and depth (40 layers, d_model 4096,
              32/8 heads, vocab 49155) in bf16 with weights from a seeded
              generator: batch 8, max_len 1024, page_tokens 16, budget 8,
              channels 1, 48 decode steps.  ``local`` is fed a 40-token
              random prompt, then decodes greedily; ``bridge_pull`` on one
              memory node and on 8 (the pool striped over a node axis, the
              default bidirectional route program) is fed the same tokens
              and its logits are held to local's (the 8-node pull on all
              40 layers; every other bridge run of this phase, planted
              faults included, on the first 10, against local on those
              layers over the same tokens).  Each path's kernels must
              launch exactly the counts its shapes give, counted from 0 just
              before the path runs; a profiled step gives the fold's
              launches one by one (mean, median, longest).  The kernel
              API's paged decode attention then reads layer 0 of the 8-node
              pool through the memport table and is held to dense attention
              over local's cache.  ``bridge_push`` (attention at the memory
              nodes; only its flushes launch kernels) runs the same 48
              steps on 1 and 8 nodes, held to local's logits.  Then
              ``bridge_pull`` with the in-band counters on (tenant lane
              b % 2): (a) 20 steps on 1 and 8 nodes, logits bit-identical
              to the counters-off run's first 20 steps; (b) 40 steps on 8
              nodes over a scattered memport table and a two-board fabric
              with its hierarchical program, so every slot and tier carries
              traffic; in both every layer's counters equal the host oracle
              (``core/ref.expected_transfer_telemetry``) bit for bit, and
              the launches equal the counters-off path's;
4. reduced  — reduced granite-3-8b in float32, a 16-token prompt then
              greedy: ``local``, ``bridge_pull`` (1 and 8 nodes, counters
              off and on), ``bridge_push`` (1 and 8 nodes) and ``ring``
              emit identical tokens and logits within 1e-4;
5. forward  — the same full-width weights: the sequence forward timed at
              B 8 x S 1024 (median of 5 after a warm-up), exactly one flash
              launch per layer, every one the bf16 tensor-core kernel; its
              logits over 200 random tokens held to teacher-forced
              ``local`` decode within 5e-2 of the largest logit, and in
              float32 at the reduced size within 1e-4 (there every flash
              launch is the float32 three-term TF32 kernel);
6. stream   — triad over 65,536 float32 elements pulled as 32 pages of
              2048 through the 4-node bridge (a pool blocked over 4 memory
              nodes, budget 8) is bit-identical to triad on the local
              arrays (the check of the paper's Figure 3);
7. programs — the software-defined check: pull and push on one 8-node pool
              under each of the route-program constructors back to back,
              bit-exact against the plain path on a CPU copy, their
              counters (a tenant lane) equal to the host oracle, with no
              nvcc run; each also through the unfused engine
              (``fused=False``, which ignores the channels: the
              reference's pipelined and bufferless engines run it too),
              bit-exact against the fused engine's pages and the plain
              path, counters equal to the oracle, none of the four bridge
              kernels launched; then one 8-node pull and push, counters
              off and on, and one unfused pull and push, under
              ``torch.cuda.set_sync_debug_mode("error")``;
8. control  — the software control plane's closed loop: first
              ``examples/quickstart_torch.py`` at its own size (bit-exact
              to ``pull_pages_ref`` before and after a node fails); then a
              plane over 8 memory nodes x 2,048 slots of granite-3-8b's KV
              page (16 x 8 x 128 bf16; 512 MiB), 75% filled under the
              striped, hashed and affinity policies, 8 x 256 requests,
              budget 8, on the 8-node engine and on the loopback path over
              8 logical nodes (``table_nodes``): a push and a pull with the
              counters on (bit-exact to ``push_pages_ref`` /
              ``pull_pages_ref``, the counters to the host oracle), the
              counters folded and ``rate_limits``, ``select_channels`` and
              ``affinity_migration`` run on them, node 3 failed and both
              plans carried out on the pool by the gather and scatter
              kernels, the program recompiled, a pull under the new table,
              program and budgets bit-exact to the contents before the
              failure, a failed ring direction and one more pull; every
              datapath call under the sync debugger, no nvcc run.  Last a
              ``Calibrator`` fit: 8-node pulls timed (CUDA events, median
              of 5) under four programs at budgets 4, 8 and 16, the fitted
              constants, residuals and channel pick printed with the card.
              The phase's launches of the four bridge kernels must be
              exactly what its shapes give;
9. serve    — request-level serving through the launcher's traffic path
              (``launch/serve.py`` ``_traffic_mode``): full-width
              granite-3-8b, two tenants (chat, interactive, share 3;
              crawl, batch, share 1), 8 slots, max_len 256, page_tokens 16,
              the QoS policy, 12 arrival steps of a seeded stream at 0.5
              requests a step a tenant, under ``local`` and ``bridge_pull``
              on 8 memory nodes.  Every request retires or is shed with a
              reason, both tenants retire, every leased page comes back;
              two retired requests of 48 tokens or more (3 pages: each
              pulls flushed pages for 16 steps or more), both tenants and a
              slot that an earlier request had left among them, decoded
              alone in their slot of a fresh engine give the same tokens
              bit for bit, and ``flight.why`` explains each; the launches
              equal the
              serve step's shapes times the decode steps (the orchestrator
              and batcher launch none); an engine step syncs with the host
              once (the emitted tokens) and the orchestrator's outputs
              upload without a sync; the Chrome trace and the debug bundle
              are written and read back.  Prints tokens/s, per-QoS p50/p99
              latency (µs and steps), TTFT, the host µs of
              ``batcher.control()`` and the ms of a decode step;
10. dense   — gemma3-12b, h2o-danube-3-4b and starcoder2-7b at full width
              and depth in bf16, weights from seed 0, one at a time: the
              forward at B 2 x S 1024 (median of 3 after a warm-up, one
              bf16 flash launch a layer), held to teacher-forced ``local``
              decode over 64 tokens within 5e-2 of the largest logit (a
              planted mask fault must break it); the bf16 flash kernel at
              the config's heads within 2e-2 of its plain version at
              B 2 x S 1024 and, with a window, at S = window + 1,024, where
              the window hides keys; then a 40-token prompt and 16 greedy
              steps under ``local``, and ``bridge_pull`` and
              ``bridge_push`` on 8 nodes fed local's tokens, logits within
              5e-2 (bit-identical where no layer reaches the bridge),
              launches what the bridge layers give (8 of 48, 0 of 24, 32
              of 32); the fold within 1e-5 of its plain version on the last
              round the pull pulled, at the config's heads (16/8 of 256,
              36/4 of 128); and a pull that loses a page must break the
              5e-2 limit;
11. train   — the training path: the flash backward kernels against
              their plain version (the bf16 wgmma kernel and the float32
              three-term TF32 kernel at the training shapes, B 4 x S 1024,
              32/8 heads of 128, causal, the split-hd bf16 wgmma kernel and
              the split-hd float32 TF32 kernel at gemma3-12b's, 16/8 heads
              of 256, and both dtypes at the mask and head-size cases, a row
              that sees no key among them; bf16
              within 2e-2 of the largest gradient, float32 within 2e-4;
              each call must launch the kernel the (dtype, hd) table
              names), bit-identical between calls, a planted fault
              (q_offset shifted by one; the causal mask where q_offset
              moves no mask) that must break every limit, timed
              in turns with the library's backward through SDPA beside its
              bound (the backward's five products, 2.5 times the forward's
              operations; three TF32 products for float32, beside one
              float32 product on the CUDA cores) and the floor of each
              kernel's design (seven products; nine for the bf16 split-hd
              kernel, which computes s and dp once in each of its dk/dv
              warpgroups), device time by kernel; the forward kernels
              at the sequence forward's shapes with the lse not asked for
              and asked for; granite-3-8b at full width on 4 of its 40
              layers in bf16 (weights from seed 0, remat "block"): a warm-up
              step and 5 timed ones on a repeated SyntheticLM batch of
              B 4 x S 1024, the loss after them below the first, each layer
              a step two forward flash launches (the forward and the
              backward's recompute) and one backward launch, ms a step,
              tokens/s, peak memory and one step's forward / backward /
              optimizer split; one reduced float32 step on the card against
              the same step on the CPU (the plain versions) from the same
              state, within 1e-4, and the same for reduced gemma3-12b at
              its own heads of 256 (1 layer; the split-hd float32 TF32
              backward; each parameter within 1e-4 plus AdamW's
              first-step slope times its gradient's difference);
              gemma3-12b at full width on 1 of its 48 layers in bf16
              (heads of 256: the split-hd wgmma backward), a warm-up step
              and 2 more on a repeated B 2 x S 1024 batch, the loss
              falling; and the AdamW moments of the first layer (and the
              embedding) through two ``zero_bridge`` stores over 4 logical
              memory nodes (the loopback path, pages of 16,384 float32):
              a step through the pool bit-identical to the local one, a
              checkpoint, node 2 failed, ``rehome_after_failure`` from the
              checkpoint image, pulls bit-identical to it, no page on node
              2, one gather a pull and one scatter a push;
12. engines — the unfused engine through the serve path: granite-3-8b at
              full width on its first 10 layers (bf16, weights from seed
              0), batch 8, max_len 64, page_tokens 16, budget 8, 8 memory
              nodes, a 24-token random prompt then 8 greedy steps (page 0
              of every sequence flushed and pulled for 16 steps):
              ``bridge_pull`` and ``bridge_push`` through ``make_cache_ops``
              under the fused engine, the unfused one (``fused=False``)
              and the bufferless bridge (``edge_buffer=False``: the fold
              over unfused transfers), logits within 5e-2
              of the largest against ``local`` on the same layers and
              tokens and against the fused engine's; the unfused runs
              launch no kernel, the bufferless pull only the fold; a pull
              that loses a page under ``fused=False`` must break the limit;
              ms a decode step per engine, with the card;
13. report  — one JSON line listing every ported kernel with its launches on
              the paths that ran it, the card's name and power limit, then
              the result line.

Phases 3 and 4 also run ``bridge_pull`` with planted faults and fail unless
their own limit rejects them: the last live lane of every pulled round
dropped (a bridge that loses a page), and, on 8 nodes, a route program
pruned of ring distance 4, which carries traffic; ``bridge_push`` runs with
the last live lane of every flush dropped (a lost write).  Phase 5 runs the
forward
with the flash kernel's mask shifted by one position (every query also sees
the next token) and fails unless its limits reject that.  Random weights
repeat a token once decoding turns greedy; the prompt is what makes the KV
pages differ enough for a lost page to show in the logits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from dataclasses import fields
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs, tree  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import (SWA_ATTN, BridgeConfig,  # noqa: E402
                                OptimConfig, RunConfig, ShapeConfig)
from repro_torch.core import bridge, kvbridge, steering  # noqa: E402
from repro_torch.core import zero_bridge  # noqa: E402
from repro_torch.core import ref as tref  # noqa: E402
from repro_torch.core.control_plane import (ControlPlane,  # noqa: E402
                                            execute_plan, plan_rows)
from repro_torch.core.perfmodel import Calibrator, route_features  # noqa: E402
from repro_torch.core.memport import FREE, MemPortTable  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bridge_attention as ba  # noqa: E402
from repro_torch.kernels import bridge_gather as bg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import stream as st  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, to_device  # noqa: E402
from repro_torch.models.flash import attention_ref, flash_bwd_ref  # noqa: E402,E501
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import step as serve_step  # noqa: E402
from repro_torch.telemetry import TelemetryAggregator  # noqa: E402
from repro_torch.telemetry import counters as tcounters  # noqa: E402
from repro_torch.telemetry.aggregate import to_host  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
TF32_FLOP_PER_S = 495e12         # H100 SXM TF32 tensor cores, dense
STREAM_TOL = dict(rtol=1e-5, atol=1e-5)   # float32: only sum order differs
# bf16 full width: local and bridge_pull round their attention outputs to
# bf16 from float32 values that differ in the last float32 bits, and a
# one-ulp bf16 flip (2**-8 relative) travels through 40 layers; hold the
# largest logit difference to 5% of the largest logit.
FULL_LOGIT_REL_TOL = 5e-2
# float32 reduced model: the placements differ only in sum order.
REDUCED_LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# Kernel checks against the plain versions, the reference suite's limits
# (tests/test_kernels.py): the kernels compute in float32 and differ from
# the dense softmax in sum order; bf16 adds one rounding of the output.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PAGED_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
# The sequence forward against teacher-forced local decode, bf16 full width:
# one product over S rows against S products over one row round bf16 at
# other places; the limit of the decode checks.
FORWARD_LOGIT_REL_TOL = 5e-2
NODES = 8                        # memory nodes of the N-node path
PATHS = {"1-node": 1, f"{NODES}-node": NODES}

# ``paths``: the decode paths of phase 3 that launch the kernel; ``headline``:
# the measurement of phase 2 whose numbers stand at the top of its row;
# ``variant``: where one wrapper launches two kernels (flash attention: the
# bf16 wgmma kernel and the float32 three-term TF32 kernel), the kernel
# whose launches the row counts.
KERNELS = {
    "gather_pages": dict(
        fns=(bg.gather_pages,),
        source="src/repro_torch/kernels/csrc/bridge_gather.cu",
        replaces="src/repro/kernels/bridge_gather.py:120",
        paths=("1-node", "8-node"), headline="8-node"),
    "pull_commit": dict(
        fns=(bg.pull_commit,),
        source="src/repro_torch/kernels/csrc/bridge_gather.cu",
        replaces="src/repro/kernels/bridge_gather.py:180", paths=("8-node",),
        headline="8-node"),
    "push_commit": dict(
        fns=(bg.push_commit,),
        source="src/repro_torch/kernels/csrc/bridge_gather.cu",
        replaces="src/repro/kernels/bridge_gather.py:281", paths=("8-node",),
        headline="8-node"),
    "scatter_pages": dict(
        fns=(bg.scatter_pages,),
        source="src/repro_torch/kernels/csrc/bridge_gather.cu",
        replaces="src/repro/kernels/bridge_gather.py:325", paths=("1-node",),
        headline="1-node"),
    "stream_decode_accumulate": dict(
        fns=(ba.stream_decode_accumulate,),
        source="src/repro_torch/kernels/csrc/bridge_attention.cu",
        replaces="src/repro/kernels/bridge_attention.py:124",
        paths=("1-node", "8-node"), headline="8-node"),
    "paged_attention": dict(
        fns=(pa.paged_attention,),
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:117", paths=(),
        headline="api"),
    "flash_attention": dict(
        fns=(fa.flash_attention,), variant=fa.WGMMA,
        source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:109", paths=(),
        headline="forward"),
    "flash_attention_f32": dict(
        fns=(fa.flash_attention,), variant=fa.TF32X3,
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:109", paths=(),
        headline="forward f32"),
    "stream": dict(
        fns=(st.stream_copy, st.stream_scale, st.stream_add, st.stream_triad),
        source="src/repro_torch/kernels/csrc/stream.cu",
        replaces="src/repro/kernels/stream.py:62", paths=(),
        headline="triad float32"),
    # no pallas_call: the counterpart of the reference's XLA custom VJP;
    # one wrapper, four kernels (bwd_variant: bf16 on the tensor cores and
    # float32 on the TF32 tensor cores, each up to hd 128 and, with the
    # head dim split, above)
    "flash_attention_bwd": dict(
        fns=(fa.flash_attention_bwd,), variant=fa.BWD_WGMMA,
        source="src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
        replaces="src/repro/models/flash.py:176", paths=(),
        headline="train bf16"),
    "flash_attention_bwd_f32": dict(
        fns=(fa.flash_attention_bwd,), variant=fa.BWD_TF32X3,
        source="src/repro_torch/kernels/csrc/flash_attention_bwd_tf32.cu",
        replaces="src/repro/models/flash.py:176", paths=(),
        headline="train f32"),
    "flash_attention_bwd_wgmma256": dict(
        fns=(fa.flash_attention_bwd,), variant=fa.BWD_WGMMA256,
        source="src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma256.cu",
        replaces="src/repro/models/flash.py:176", paths=(),
        headline="gemma3 bf16"),
    "flash_attention_bwd_tf32_256": dict(
        fns=(fa.flash_attention_bwd,), variant=fa.BWD_TF32X3_256,
        source="src/repro_torch/kernels/csrc/flash_attention_bwd_tf32_256.cu",
        replaces="src/repro/models/flash.py:176", paths=(),
        headline="gemma3 f32"),
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


def device_us(fn, kernel: str, calls: int = 20,
              patience_s: float = 90.0) -> float:
    """Mean device time, in us, of the kernel whose name holds ``kernel``
    (any operation on the card for "") over ``calls`` calls of ``fn``, from
    the profiler: the kernel alone, without the host's issue time that
    back-to-back calls may wait on.  Each call must run it once, and the
    count must match in the profile whose time is kept.  The profiler now
    and then reports fewer kernels than ran (seen on the H100: 49 of 50;
    and late in a whole smoke, never in a fresh process, profiles that
    hold no operation on the card at all, up to ten in a row over ten
    seconds).  A short profile is reported and taken again, for a named
    kernel after 2,000 small operations that open it (after which most
    such profiles held the kernels), until ``patience_s`` seconds have
    passed."""
    from torch.profiler import ProfilerActivity, profile
    filler = torch.zeros(1, device="cuda") if kernel else None
    fn()
    torch.cuda.synchronize()
    deadline = time.perf_counter() + patience_s
    for attempt in itertools.count():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2000 if attempt and kernel else 0):
                filler.add_(1)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and kernel in e.key]
        launches = sum(e.count for e in events)
        if launches == calls:
            return sum(e.self_device_time_total for e in events) / launches
        if time.perf_counter() > deadline:
            raise AssertionError(f"profiled {launches} launches of {kernel} "
                                 f"in {calls} calls, {attempt + 1} profiles "
                                 f"running over {patience_s} s")
        print(f"device_us: profiled {launches} launches of {kernel} in "
              f"{calls} calls; profiling again", file=sys.stderr)
        time.sleep(0.2)


def graph_ms(fn, calls: int = 100, replays: int = 20) -> float:
    """Mean time of one call of ``fn`` when ``calls`` calls recorded in one
    CUDA graph are replayed: the kernel without the host's issue time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def host_us(fn, iters: int = 2000, chunk: int = 100) -> float:
    """Mean host time, in us, until one call of ``fn`` returns, over
    ``iters`` calls timed in chunks of ``chunk``; the card drains between
    chunks, outside the timing, so a full launch queue never holds a call
    back (a long kernel, STREAM's, would otherwise set the pace)."""
    fn()
    torch.cuda.synchronize()
    dt = 0.0
    for _ in range(iters // chunk):
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn()
        dt += time.perf_counter() - t0
        torch.cuda.synchronize()
    return dt / (iters // chunk * chunk) * 1e6


def host_breakdown(name: str, **parts) -> dict:
    """Where one wrapper call's host time goes: each part (the whole call,
    its operand checks, its output allocation, the raw stream getter, the
    bare C launch with its arguments ready, one library call) timed alone
    on the host, in us."""
    out = {f"{part}_us": host_us(fn) for part, fn in parts.items()}
    print(f"host {name}:", json.dumps(out))
    return out


def in_turns(entry: dict, name: str, call, library, *, iters: int = 200,
             graph: bool = False, host=None) -> None:
    """The numbers of a wrapper that may be host-bound.  The wrapper and its
    library call are timed in turns, 5 rounds each, and their medians
    become the entry's ``ms`` and ``library_ms`` (one round each moves with
    the host by tens of percent); with ``graph``, the time of a call when
    100 calls recorded in a CUDA graph are replayed; with ``host``, the
    parts of :func:`host_breakdown` besides the whole call and the library
    call."""
    rounds = [(cuda_ms(call, iters=iters), cuda_ms(library, iters=iters))
              for _ in range(5)]
    entry["ms_rounds"], entry["library_ms_rounds"] = map(list, zip(*rounds))
    entry["ms"] = statistics.median(entry["ms_rounds"])
    entry["library_ms"] = statistics.median(entry["library_ms_rounds"])
    print(f"kernel {name}: in turns with its library call, wrapper "
          f"{entry['ms_rounds']} ms, library {entry['library_ms_rounds']} ms")
    if graph:
        entry["graph_ms"] = graph_ms(call)
    if host is not None:
        entry["host"] = host_breakdown(name, wrapper=call, **host,
                                       library=library)


def profile_deferred(profiled: list) -> None:
    """Device time of each (entry, name, call, kernel[, library]) from the
    profiler, after every host timing of phase 2: in this smoke's runs,
    launches timed after a profiler session took longer on the host.  With
    a library call that runs one operation on the card, its device time
    too."""
    for entry, name, call, kernel, *library in profiled:
        entry["device_us"] = device_us(call, kernel)
        graph = ("" if "graph_ms" not in entry else
                 f", CUDA-graph replay {entry['graph_ms']:.5f} ms a call")
        lib = ("null" if entry["library_ms"] is None
               else f"{entry['library_ms']:.4f}")
        if library:
            entry["library_device_us"] = device_us(library[0], "")
            lib += f" (device {entry['library_device_us']:.2f} us)"
        print(f"kernel {name}: device {entry['device_us']:.2f} us, wrapper "
              f"{entry['ms']:.4f} ms{graph}, library {lib} ms")


def reset_launches() -> None:
    for k in KERNELS.values():
        for fn in k["fns"]:
            fn.launches = 0
            for variant in getattr(fn, "launches_by_kernel", {}):
                fn.launches_by_kernel[variant] = 0


def read_launches() -> dict:
    return {name: sum(fn.launches_by_kernel[k["variant"]] if "variant" in k
                      else fn.launches for fn in k["fns"])
            for name, k in KERNELS.items()}


def count_path(report: dict, path: str, counts: dict) -> None:
    """Add one path's launches, counted from 0 just before it ran, to the
    report."""
    for name, n in counts.items():
        report[name]["launches"] += n
        if n:
            report[name]["by_path"].setdefault(path, {})["launches"] = n


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def record(report: dict, name: str, path: str, *, err: float, ms: float,
           plain_ms: float, library_ms, nbytes: int, flops: int = 0,
           flop_rate: float = F32_FLOP_PER_S, note: str = "",
           dev_us=None) -> dict:
    """Keep one kernel measurement, with its bound: the larger of the bytes
    it must move over HBM's rate and its operations over the card's peak
    rate for their input type (``flop_rate``: float32 by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
    if dev_us is not None:
        entry["device_us"] = dev_us
    report[name].setdefault("by_path", {})[path] = entry
    lib = "null" if library_ms is None else f"{library_ms:.4f}"
    on_device = "" if dev_us is None else f" (device {dev_us:.2f} us)"
    print(f"kernel {name} [{path}{note}]: {ms:.4f} ms{on_device}, plain "
          f"{plain_ms:.4f} ms, bound {entry['bound_ms']:.6f} ms "
          f"({entry['bound_by']}), library {lib} ms, max_abs_err {err:.3g}")
    return entry


def check_stream(report, path, q, kp, vp, seq, lv, m, l, o, profiled: list,
                 host: bool = False) -> None:
    """The decode-attention fold within 1e-5 of its plain version, bit for
    bit from call to call, then timed beside its byte bound; the call is
    added to ``profiled``, and with ``host`` where its host time goes."""
    args = (q, kp, vp, seq, lv, m, l, o)
    got = ba.stream_decode_accumulate(*args)
    want = ba.stream_decode_accumulate_plain(*args)
    err = 0.0
    for g_, a_, w_ in zip(got, ba.stream_decode_accumulate(*args), want):
        torch.testing.assert_close(g_, w_, **STREAM_TOL)
        if not torch.equal(g_, a_):
            raise AssertionError(f"stream_decode_accumulate ({path}) is not "
                                 f"bit-identical from call to call")
        err = max(err, float((g_ - w_).abs().max()))
    b, h, hd = q.shape
    w, t, kv, _ = kp.shape
    n_live = int(lv.sum())
    n_seq = len(set(seq[lv.bool()].tolist()))   # q is read for these only
    page_bytes = t * kv * hd * kp.element_size()
    state_bytes = (2 * b * h + b * h * hd) * 4
    call = functools.partial(ba.stream_decode_accumulate, *args)
    entry = record(
        report, "stream_decode_accumulate", path, err=err, ms=cuda_ms(call),
        plain_ms=cuda_ms(lambda: ba.stream_decode_accumulate_plain(*args),
                         iters=20),
        library_ms=None,
        nbytes=(n_seq * h * hd * q.element_size() + 2 * n_live * page_bytes
                + 2 * state_bytes + 2 * w * 4),
        flops=n_live * (4 * h * t * hd + h * t), note=f", W={w}")
    profiled.append((entry, f"stream_decode_accumulate ({path})", call,
                     "stream_kernel"))
    if host:
        c_args = (ba._DTYPE_CODE[q.dtype], q.data_ptr(), kp.data_ptr(),
                  vp.data_ptr(), seq.data_ptr(), lv.data_ptr(), m.data_ptr(),
                  l.data_ptr(), o.data_ptr(), *(x.data_ptr() for x in got),
                  b, h, kv, w, t, hd, hd ** -0.5, _build.stream_of(q))
        entry["host"] = host_breakdown(
            f"stream_decode_accumulate ({path})", wrapper=call,
            checks=lambda: _build.on_cpu("stream_decode_accumulate", q, kp,
                                         vp, m, l, o, ids=(seq, lv),
                                         aligned=False),
            alloc=lambda: ba.new_state(b, h, hd, q.device),
            stream=lambda: _build.stream_of(q),
            c_launch=lambda: ba._stream_c(*c_args))


def check_gather(report, path, pool, reqs, profiled: list,
                 host: bool = False) -> torch.Tensor:
    """gather_pages bit for bit against its plain version, then timed in
    turns with ``index_select`` x mask and from a CUDA graph; with
    ``host``, where a call's host time goes.  The call is added to
    ``profiled``."""
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
    library = lambda: torch.index_select(pool2, 0, safe) * mask  # noqa: E731
    if not torch.equal(library().view_as(got), want):
        raise AssertionError("index_select x mask is not the gather")
    call = functools.partial(bg.gather_pages, pool, reqs)
    entry = record(report, "gather_pages", path, err=0.0, ms=cuda_ms(call),
                   plain_ms=cuda_ms(lambda: bg.gather_pages_plain(pool2,
                                                                  flat)),
                   library_ms=cuda_ms(library),
                   nbytes=(int((flat >= 0).sum()) + flat.numel()) * row_bytes
                   + flat.numel() * 4, note=f", W={flat.numel()}")
    shape = reqs.shape + pool.shape[1:]
    args = (pool.data_ptr(), reqs.data_ptr(), got.data_ptr(), pool.shape[0],
            flat.numel(), row_bytes, _build.stream_of(pool))
    in_turns(entry, f"gather_pages ({path})", call, library, graph=True,
             host=None if not host else dict(
                 checks=lambda: _build.on_cpu("gather_pages", pool,
                                              ids=(reqs,)),
                 alloc=lambda: pool.new_empty(shape),
                 stream=lambda: _build.stream_of(pool),
                 c_launch=lambda: bg._gather_c(*args)))
    profiled.append((entry, f"gather_pages ({path})", call, "gather_rows"))
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


def check_kernels(report: dict, dev="cuda") -> list:
    """The decode paths' page kernels and the stream fold at their shapes.
    Returns the calls whose device time the profiler takes once every host
    timing of phase 2 is done (:func:`profile_deferred`)."""
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

    profiled = []
    # -- one-node path: W = 8 lanes ------------------------------------------
    check_gather(report, "1-node", pool,
                 torch.tensor([5, -1, 130, 7, 511, -1, 0, 64],
                              dtype=torch.int32, device=dev), profiled,
                 host=True)
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
    scatter = functools.partial(bg.scatter_pages, pool_k, slots, data)
    entry = record(
        report, "scatter_pages", "1-node", err=0.0, ms=cuda_ms(scatter),
        plain_ms=cuda_ms(lambda: bg.scatter_pages_plain(
            pool_p.view(rows, -1), slots, data.view(w, -1))),
        library_ms=cuda_ms(lambda: pool_p.view(rows, -1).index_copy_(
            0, lib_idx, lib_data)),
        nbytes=2 * len(written) * row_bytes + slots.numel() * 4)
    profiled.append((entry, "scatter_pages", scatter, "scatter_rows"))
    args = (pool_k.data_ptr(), slots.data_ptr(), data.data_ptr(), rows, w,
            row_bytes, _build.stream_of(pool_k))
    in_turns(entry, "scatter_pages", scatter,
             lambda: pool_p.view(rows, -1).index_copy_(0, lib_idx, lib_data),
             graph=True, host=dict(
                 checks=lambda: _build.on_cpu("scatter_pages", pool_k, data,
                                              ids=(slots,)),
                 stream=lambda: _build.stream_of(pool_k),
                 c_launch=lambda: bg._scatter_c(*args)))
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
                 m, l, o, profiled)
    # the 1-node decode's two kinds of round: all FREE (a round past every
    # sequence's flushed pages), and one sequence's 8 pages
    for path, ids in (("free W=8", [-1] * w), ("live W=8", [5] * w)):
        seq = torch.tensor(ids, dtype=torch.int32, device=dev)
        check_stream(report, path, q, kp, vp, seq, (seq >= 0).to(torch.int32),
                     m, l, o, profiled, host=path == "live W=8")

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
    send = check_gather(report, "8-node", pool, send_rows, profiled)
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
                 (wflat >= 0).to(torch.int32), m, l, o, profiled)
    # the 8-node decode's live round: node j's first 3 lanes carry sequence
    # j's flushed pages, the other 5 are FREE
    seq = torch.where(torch.arange(NODES * w, device=dev) % w < 3,
                      torch.arange(NODES * w, device=dev) // w, -1).to(
        torch.int32)
    check_stream(report, "live W=64 3x8", q, k_r, v_r, seq,
                 (seq >= 0).to(torch.int32), m, l, o, profiled)

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
    push = functools.partial(bg.push_commit, pool_k, pslots, payload, base,
                             channels=1, cb=8)
    entry = record(
        report, "push_commit", "8-node", err=0.0, ms=cuda_ms(push),
        plain_ms=cuda_ms(lambda: bg.push_commit_plain(
            pool_p.view(rows, -1), pslots, payload.view(NODES, 1, -1),
            base, 1, 8)),
        library_ms=cuda_ms(lambda: pool_p.view(rows, -1).index_copy_(
            0, lib_idx, lib_data)),
        nbytes=2 * len(pairs) * row_bytes + (pslots.numel() + NODES) * 4,
        note=", channels=1")
    profiled.append((entry, "push_commit", push, "push_commit_rows"))
    args = (pool_k.data_ptr(), pslots.data_ptr(), payload.data_ptr(),
            base.data_ptr(), ppn, NODES, NODES, 8, 8, 1, row_bytes,
            _build.stream_of(pool_k))
    in_turns(entry, "push_commit", push,
             lambda: pool_p.view(rows, -1).index_copy_(0, lib_idx, lib_data),
             graph=True, host=dict(
                 checks=lambda: _build.on_cpu("push_commit", pool_k, payload,
                                              ids=(pslots, base)),
                 stream=lambda: _build.stream_of(pool_k),
                 c_launch=lambda: bg._push_c(*args)))
    return profiled + check_full_flush(report, gen, pool, dev)


def check_full_flush(report: dict, gen, pool, dev="cuda") -> list:
    """The write kernels on whole-pool flushes of the full-width pool (512
    pages of 32 KiB), bit-exact against their plain versions: scatter at
    W = 1024 lanes with FREE, out-of-pool and duplicate lanes, then a flush
    that writes every row once (timed); push_commit on 8 homes with
    channels 4, 2 and 1, every home's 64 grid steps writing each of its 64
    slots once (channels 1 timed).  Returns the timed calls, for the
    profiler."""
    rows = pool.shape[0]
    ppn = rows // NODES
    pool2 = pool.view(rows, -1)
    row_bytes = pool2.shape[1] * pool2.element_size()
    page = tuple(pool.shape[1:])
    slots = torch.randint(-(rows // 4), rows + rows // 8, (2 * rows,),
                          generator=gen, device=dev,
                          dtype=torch.int32).clamp(min=-1)
    data = torch.randn((2 * rows,) + page, generator=gen,
                       device=dev).bfloat16()
    pool_k, pool_p = pool.clone(), pool.clone()
    bg.scatter_pages(pool_k, slots, data)
    bg.scatter_pages_plain(pool_p.view(rows, -1), slots,
                           data.view(2 * rows, -1))
    if not torch.equal(pool_k, pool_p):
        raise AssertionError("scatter_pages disagrees with its plain version "
                             "at W = 1024")
    perm = torch.randperm(rows, generator=gen, device=dev).to(torch.int32)
    data = data[:rows]
    bg.scatter_pages(pool_k, perm, data)
    bg.scatter_pages_plain(pool_p.view(rows, -1), perm, data.view(rows, -1))
    if not torch.equal(pool_k, pool_p):
        raise AssertionError("scatter_pages disagrees with its plain version "
                             "on a full flush")
    lib_pool = pool.clone()
    lib_pool.view(rows, -1).index_copy_(0, perm.long(), data.view(rows, -1))
    if not torch.equal(lib_pool, pool_k):
        raise AssertionError("index_copy_ is not the full flush's scatter")
    scatter = functools.partial(bg.scatter_pages, pool_k, perm, data)
    record(report, "scatter_pages", "full flush", err=0.0,
           ms=cuda_ms(scatter, iters=50),
           plain_ms=cuda_ms(lambda: bg.scatter_pages_plain(
               pool_p.view(rows, -1), perm, data.view(rows, -1)), iters=20),
           library_ms=cuda_ms(lambda: pool_p.view(rows, -1).index_copy_(
               0, perm.long(), data.view(rows, -1)), iters=50),
           nbytes=2 * rows * row_bytes + rows * 4, note=", W=512")
    profiled = [(report["scatter_pages"]["by_path"]["full flush"],
                 "scatter_pages (full flush)", scatter, "scatter_rows")]

    pslots = torch.stack([torch.randperm(ppn, generator=gen, device=dev)
                          for _ in range(NODES)]).view(NODES, NODES, 8).to(
        torch.int32)
    payload = torch.randn((NODES, 8) + page, generator=gen,
                          device=dev).bfloat16()
    base = torch.zeros((NODES,), dtype=torch.int32, device=dev)
    for channels in (4, 2, 1):
        cb = 8 // channels
        pool_k, pool_p = pool.clone(), pool.clone()
        bg.push_commit(pool_k, pslots, payload, base, channels=channels,
                       cb=cb)
        bg.push_commit_plain(pool_p.view(rows, -1), pslots,
                             payload.view(NODES, 8, -1), base, channels, cb)
        if not torch.equal(pool_k, pool_p):
            raise AssertionError(f"push_commit disagrees with its plain "
                                 f"version on a full flush (channels "
                                 f"{channels})")
    # home h's slot row k, lane l lands payload[(h - k) mod N, l]
    hh, kk, ll = (torch.arange(x, device=dev) for x in (NODES, NODES, 8))
    dst = (hh[:, None, None] * ppn + pslots).long().reshape(-1)
    src = payload.view(NODES, 8, -1)[
        (hh[:, None, None] - kk[None, :, None]) % NODES,
        ll[None, None, :].expand(NODES, NODES, 8)].reshape(rows, -1)
    lib_pool = pool.clone()
    lib_pool.view(rows, -1).index_copy_(0, dst, src)
    if not torch.equal(lib_pool, pool_k):
        raise AssertionError("index_copy_ is not the full flush's commit")
    push = functools.partial(bg.push_commit, pool_k, pslots, payload, base,
                             channels=1, cb=8)
    record(report, "push_commit", "full flush", err=0.0,
           ms=cuda_ms(push, iters=50),
           plain_ms=cuda_ms(lambda: bg.push_commit_plain(
               pool_p.view(rows, -1), pslots, payload.view(NODES, 8, -1),
               base, 1, 8), iters=20),
           library_ms=cuda_ms(lambda: pool_p.view(rows, -1).index_copy_(
               0, dst, src), iters=50),
           nbytes=2 * rows * row_bytes + (pslots.numel() + NODES) * 4,
           note=", 8 homes x 64 slots, channels=1")
    profiled.append((report["push_commit"]["by_path"]["full flush"],
                     "push_commit (full flush)", push, "push_commit_rows"))
    return profiled


def visible_mask(sq: int, sk: int, causal: bool, window: int,
                 q_offset: int) -> torch.Tensor:
    """[Sq, Sk] bool: the (query, key) pairs the masks leave visible, what
    the kernel's two products must compute."""
    q_pos = torch.arange(sq)[:, None] + q_offset
    k_pos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= q_pos - k_pos < window
    return mask


# flash checks beside the forward's shapes: (B, Sq, Sk, H, kv, hd, causal,
# window, q_offset); float32 and bf16 each.  The last case leaves its first
# 40 rows no key to see (q_offset -40).
FLASH_CASES = [
    (2, 200, 200, 32, 8, 128, False, 0, 0),
    (1, 300, 300, 32, 8, 128, True, 100, 0),
    (1, 128, 384, 32, 8, 128, True, 0, 256),
    (1, 256, 256, 4, 1, 64, True, 0, 0),
    (1, 256, 256, 4, 1, 120, True, 0, 0),
    (1, 256, 256, 4, 1, 192, True, 0, 0),
    (1, 256, 256, 4, 1, 256, True, 0, 0),
    (1, 64, 64, 4, 2, 64, True, 16, -40),
]
# The two kernels behind the one wrapper: (report row, measurement, kernel,
# peak rate of the tensor cores' input type, tensor-core products a float32
# product takes).  bf16 runs one product on bf16 tiles; float32 three on
# TF32 tiles (hi·hi + hi·lo + lo·hi), its bound beside one float32 product
# on the CUDA cores (67 TFLOP/s), the bound of the kernel it replaced.
FLASH_ROWS = {torch.bfloat16: ("flash_attention", "forward", fa.WGMMA,
                               BF16_FLOP_PER_S, 1),
              torch.float32: ("flash_attention_f32", "forward f32",
                              fa.TF32X3, TF32_FLOP_PER_S, 3)}


def check_flash_f32_large_scores(q, k, v) -> dict:
    """The float32 kernel with q scaled by 4 (scores of standard deviation
    4, causal) against the plain version, and both against attention in
    float64 computed one batch at a time: the kernel within 2e-5 of each.
    There the plain version's own float32 rounding is of the same order."""
    q4 = 4 * q
    got = fa.flash_attention(q4, k, v).double()
    plain = attention_ref(q4, k, v).double()
    b, s, h, hd = q.shape
    kv = k.shape[2]
    keep = visible_mask(s, s, True, 0, 0).to(q.device)
    err = dict(kernel_vs_plain=0.0, kernel_vs_f64=0.0, plain_vs_f64=0.0,
               max_abs_score=0.0)
    for i in range(b):
        qg = q4[i].double().view(s, kv, h // kv, hd)
        sc = torch.einsum("qkgd,skd->kgqs", qg, k[i].double()) * hd ** -0.5
        err["max_abs_score"] = max(err["max_abs_score"],
                                   float(sc.masked_fill(~keep, 0).abs().max()))
        p = torch.softmax(sc.masked_fill(~keep, float("-inf")), dim=-1)
        want = torch.einsum("kgqs,skd->qkgd", p, v[i].double()).reshape(
            s, h, hd)
        for name, x, y in (("kernel_vs_plain", got[i], plain[i]),
                           ("kernel_vs_f64", got[i], want),
                           ("plain_vs_f64", plain[i], want)):
            err[name] = max(err[name], float((x - y).abs().max()))
    if not (err["kernel_vs_plain"] <= FLASH_TOL["float32"]
            and err["kernel_vs_f64"] <= FLASH_TOL["float32"]):
        raise AssertionError(f"flash_attention float32 at q x 4: {err}")
    print(f"kernel flash_attention_f32 [q x 4, B 8 S 1024 causal float32]: "
          f"{err}")
    return err


def check_flash(report: dict, gen, dev="cuda") -> None:
    """Flash attention against its plain version: both kernels timed at the
    sequence forward's shapes (B 8, S 1024, 32/8 heads of 128, causal; the
    bf16 wgmma kernel on bf16 inputs, the float32 three-term TF32 kernel on
    inputs drawn in float32, whose full mantissas one TF32 product would
    round), then the mask and head-size cases.  Every call must launch the
    kernel its dtype names, once."""
    def inputs(b, sq, sk, h, kv, hd, dtype):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((b, sq, h, hd), (b, sk, kv, hd),
                                   (b, sk, kv, hd)))

    def error(q, k, v, dtype_name, **kw):
        kernel = FLASH_ROWS[q.dtype][2]
        before = dict(fa.flash_attention.launches_by_kernel)
        got = fa.flash_attention(q, k, v, **kw)
        after = fa.flash_attention.launches_by_kernel
        if (after[kernel] != before[kernel] + 1
                or sum(after.values()) != sum(before.values()) + 1):
            raise AssertionError(f"flash_attention {dtype_name} launched "
                                 f"{after} after {before}, not one "
                                 f"{kernel}")
        want = attention_ref(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        if not err <= FLASH_TOL[dtype_name]:
            raise AssertionError(f"flash_attention {list(q.shape)} {kw} "
                                 f"{dtype_name} differs from its plain "
                                 f"version by {err:.3g}")
        return err, got

    b, s, h, kv, hd = 8, 1024, 32, 8, 128
    pairs = int(visible_mask(s, s, True, 0, 0).sum())
    for dtype, name in ((torch.bfloat16, "bfloat16"),
                        (torch.float32, "float32")):
        row, path, kernel, rate, products = FLASH_ROWS[dtype]
        q, k, v = inputs(b, s, s, h, kv, hd, dtype)
        err, _ = error(q, k, v, name, causal=True)
        flops = 4 * b * h * hd * pairs
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        iters = 200 if dtype == torch.bfloat16 else 50
        record(report, row, path, err=err,
               ms=cuda_ms(lambda: fa.flash_attention(q, k, v), iters=iters),
               plain_ms=cuda_ms(lambda: attention_ref(q, k, v), iters=20),
               library_ms=cuda_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True),
                   iters=iters),
               nbytes=2 * q.numel() * q.element_size()
               + 2 * k.numel() * k.element_size(),
               flops=products * flops, flop_rate=rate,
               note=f", B 8 S 1024 causal {name}",
               dev_us=device_us(lambda: fa.flash_attention(q, k, v), kernel,
                                calls=10))
        if dtype == torch.float32:
            entry = report[row]["by_path"][path]
            cores_ms = flops / F32_FLOP_PER_S * 1e3
            entry["bound_ms_cuda_cores"] = cores_ms
            dev_ms = entry["device_us"] / 1e3
            print(f"kernel {row} [{path}]: bound {entry['bound_ms']:.6f} ms "
                  f"as three TF32 products ({entry['bound_ms'] / dev_ms:.1%}"
                  f" of the device time), {cores_ms:.6f} ms as one float32 "
                  f"product on the CUDA cores ({cores_ms / dev_ms:.1%})")
            entry["large_scores"] = check_flash_f32_large_scores(q, k, v)
        del q, k, v, qt, kt, vt
    worst, zero_rows = {}, 0
    for case in FLASH_CASES:
        b, sq, sk, h, kv, hd, causal, window, q_offset = case
        # the rows that see no key: the kernel must give exact zeros
        dead = ~visible_mask(sq, sk, causal, window, q_offset).any(1)
        for dtype, name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            q, k, v = inputs(b, sq, sk, h, kv, hd, dtype)
            err, got = error(q, k, v, name, causal=causal, window=window,
                             q_offset=q_offset)
            if got[:, dead.to(dev)].any():
                raise AssertionError(f"flash_attention {case} {name}: a row "
                                     f"that sees no key is not zero")
            zero_rows += int(dead.sum()) * b * h
            worst[name] = max(worst.get(name, 0.0), err)
    if not zero_rows:
        raise AssertionError("no flash case has a row that sees no key")
    report["flash_attention"]["max_abs_err_other_cases"] = worst["bfloat16"]
    report["flash_attention_f32"]["max_abs_err_other_cases"] = \
        worst["float32"]
    print(f"kernel flash_attention: {len(FLASH_CASES)} more cases x 2 dtypes "
          f"(not causal, window 100, q_offset 256, hd 64/120/192/256 with "
          f"kv 1, {zero_rows} rows that see no key, all zero) within "
          f"{FLASH_TOL}: worst {worst}")


def check_paged(report: dict, gen, dev="cuda") -> None:
    """Paged decode attention against its plain version at the serving
    decode shapes (B 8, 32/8 heads of 128, T 16, 64 pages a sequence):
    random distinct slots, one -1 entry, ragged lengths (0 and lengths
    that are not a multiple of T among them)."""
    b, h, kv, hd, t, mp = 8, 32, 8, 128, 16, 64
    slots = b * mp + 8
    table = torch.randperm(slots, generator=gen, device=dev)[:b * mp].view(
        b, mp).to(torch.int32)
    table[2, 1] = -1
    lengths = torch.tensor([1024, 0, 17, 500, 1023, 16, 777, 64],
                           dtype=torch.int32, device=dev)
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        kp, vp = (torch.randn((slots, t, kv, hd), generator=gen,
                              device=dev).to(dtype) for _ in range(2))
        q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
        got = pa.paged_attention(q, kp, vp, table, lengths, max_pages=mp)
        want = pa.paged_attention_plain(q, kp, vp, table, lengths,
                                        max_pages=mp)
        err = float((got.float() - want.float()).abs().max())
        if not err <= PAGED_TOL[name]:
            raise AssertionError(f"paged_attention {name} differs from its "
                                 f"plain version by {err:.3g}")
        if got[1].any():
            raise AssertionError("paged_attention: a sequence of length 0 "
                                 "gave nonzero output")
        if not torch.equal(got, pa.paged_attention(q, kp, vp, table, lengths,
                                                   max_pages=mp)):
            raise AssertionError(f"paged_attention {name} is not "
                                 f"bit-identical from call to call")
    pages = int((lengths // t).clamp(max=mp).sum())
    page_bytes = t * kv * hd * kp.element_size()
    call = functools.partial(pa.paged_attention, q, kp, vp, table, lengths,
                             max_pages=mp)
    entry = record(
        report, "paged_attention", "api", err=err, ms=cuda_ms(call),
        plain_ms=cuda_ms(lambda: pa.paged_attention_plain(
            q, kp, vp, table, lengths, max_pages=mp), iters=20),
        library_ms=None,
        nbytes=2 * pages * page_bytes + 2 * q.numel() * q.element_size()
        + table.numel() * 4 + b * 4,
        flops=pages * (4 * h * t * hd + h * t), note=", B 8 bf16")
    # a call is two kernels: the split folds, then the merge of the splits
    entry["device_us_by_kernel"] = {
        kernel: device_us(call, kernel) for kernel in ("paged_split_kernel",
                                                       "paged_combine_kernel")}
    entry["device_us"] = sum(entry["device_us_by_kernel"].values())
    print(f"kernel paged_attention: device {entry['device_us']:.2f} us a "
          f"call, by kernel", json.dumps(entry["device_us_by_kernel"]))


STREAM_SIZES = (10_000_000, 1003)        # the paper's arrays; a ragged tail
STREAM_BYTES = {"copy": 2, "scale": 2, "add": 3, "triad": 3}   # arrays moved
STREAM_FLOPS = {"copy": 0, "scale": 1, "add": 1, "triad": 2}   # per element


def stream_calls(q: float = 3.0) -> dict:
    """Per pass: (kernel, plain version, one PyTorch call), each on (a, b,
    c) as the paper names its arrays."""
    return {
        "copy": (lambda a, b, c: kops.stream_copy(c),
                 lambda a, b, c: st.stream_copy_plain(c),
                 lambda a, b, c: torch.empty_like(c).copy_(c)),
        "scale": (lambda a, b, c: kops.stream_scale(c, q),
                  lambda a, b, c: st.stream_scale_plain(c, q),
                  lambda a, b, c: torch.mul(c, q)),
        "add": (lambda a, b, c: kops.stream_add(a, b),
                lambda a, b, c: st.stream_add_plain(a, b),
                lambda a, b, c: torch.add(a, b)),
        "triad": (lambda a, b, c: kops.stream_triad(b, c, q),
                  lambda a, b, c: st.stream_triad_plain(b, c, q),
                  lambda a, b, c: torch.add(b, c, alpha=q)),
    }


def check_stream_passes(report: dict, gen, dev="cuda"):
    """The STREAM passes bit for bit against their plain versions at the
    paper's 10,000,000 elements and at 1,003, float32 and bf16; times at
    10M, rotating over 4 sets of arrays (at least 240 MB) so that
    back-to-back calls do not run from the 50 MB L2, each wrapper in turns
    with its library call.
    Returns the local rates in MiB/s, the paper's unit, and the calls whose
    device time the profiler takes after phase 2's host timings."""
    rates, profiled = {}, []
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        for n in STREAM_SIZES:
            sets = [tuple(torch.randn((n,), generator=gen,
                                      device=dev).to(dtype)
                          for _ in range(3)) for _ in range(4)]
            for op, (kernel, plain, library) in stream_calls().items():
                if not torch.equal(kernel(*sets[0]), plain(*sets[0])):
                    raise AssertionError(f"stream {op} {name} n={n} is not "
                                         f"bit-identical to its plain version")
                if n != STREAM_SIZES[0]:
                    continue

                def rotating(fn, sets=sets):
                    it = itertools.cycle(sets)
                    return lambda: fn(*next(it))

                entry = record(
                    report, "stream", f"{op} {name}", err=0.0,
                    ms=cuda_ms(rotating(kernel), iters=100),
                    plain_ms=cuda_ms(rotating(plain), iters=100),
                    library_ms=cuda_ms(rotating(library), iters=100),
                    nbytes=STREAM_BYTES[op] * n * sets[0][0].element_size(),
                    flops=STREAM_FLOPS[op] * n, note=f", n={n}")
                host = None
                if (op, dtype) == ("scale", torch.bfloat16):
                    c, out = sets[0][2], torch.empty_like(sets[0][2])
                    args = (st._DTYPE_CODE[dtype], 1, c.data_ptr(), 0,
                            out.data_ptr(), n, 3.0, _build.stream_of(c))
                    host = dict(
                        checks=lambda: _build.on_cpu("stream_scale", c,
                                                     aligned=False),
                        alloc=lambda: torch.empty_like(c),
                        stream=lambda: _build.stream_of(c),
                        c_launch=lambda: st._stream_c(*args))
                in_turns(entry, f"stream {op} {name}", rotating(kernel),
                         rotating(library), iters=100, host=host,
                         graph=host is not None)
                profiled.append((entry, f"stream {op} {name}",
                                 rotating(kernel), "stream_pass_kernel",
                                 rotating(library)))
                rates[f"{op} {name}"] = (STREAM_BYTES[op] * n
                                         * sets[0][0].element_size()
                                         / (entry["ms"] / 1e3) / 2 ** 20)
    return rates, profiled


# ---------------------------------------------------------------------------
# Phases 3 and 4: decode through the serve path
# ---------------------------------------------------------------------------

def decode(cfg, params, kv, batch, max_len, page_tokens, steps, feed, *,
           num_nodes=1, program=None, table=None, dtype=torch.bfloat16,
           dev="cuda", engine=None, **telemetry):
    """Decode ``steps`` steps: fed the input tokens ``feed`` [n, B] for the
    first n steps, greedy after; ``program`` and ``table`` replace the
    route program and the memport table in the shared state; ``engine``
    (``fused``, ``edge_buffer``, ``channels``; default the fused engine at
    channels 1) goes to ``run.bridge``; ``telemetry``
    (``collect_telemetry``, ``tenant_of_seq``, ``max_tenants``,
    ``topology``) goes to ``make_cache_ops``.  Returns (inputs, logits,
    per-step ms, a callable that runs one more step, the decode state after
    ``steps`` steps)."""
    run = RunConfig(model=cfg, shape=ShapeConfig("smoke", max_len, batch,
                                                 "decode"), kv_placement=kv,
                    bridge=BridgeConfig(**(engine or {})))
    ops = serve_step.make_cache_ops(run, max_len, page_tokens,
                                    num_nodes=num_nodes, dtype=dtype,
                                    device=dev, **telemetry)
    state = serve_step.init_serve_state(run, batch, ops)
    if program is not None:
        state["kv_shared"]["program"] = program
    if table is not None:
        state["kv_shared"]["table"] = table
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

    return torch.stack(inputs), torch.stack(logits_all), times, one_more, state


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


def device_events(prof) -> list:
    """(name, us) of every operation the profiler saw on the card, read
    from its raw events.  ``key_averages`` would first build the tree of
    every host event: slow for a decode step of 100,000 launches."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


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
    t0 = time.perf_counter()
    kernels = device_events(prof)
    by_name = {}
    for name, us in kernels:
        count_us = by_name.setdefault(name, [0, 0.0])
        count_us[0] += 1
        count_us[1] += us
    device = sum(us for _, us in kernels) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    ours = {k: [(n, us / 1e3 / n) for name, (n, us) in by_name.items()
                if k in name]
            for k in ("gather_rows", "pull_commit_rows", "push_commit_rows",
                      "scatter_rows", "stream_kernel", fa.TF32X3,
                      fa.WGMMA)}
    # the fold's launches one by one: a few live rounds among many all-FREE
    # ones, told apart by the median and the longest beside the mean
    fold_us = sorted(us for name, us in kernels if "stream_kernel" in name)
    out = dict(wall_ms=wall, device_ms=device,
               device_busy_share=device / wall if device else None,
               kernel_launches=len(kernels),
               top_kernels=[(name[:60], n, us / 1e3)
                            for name, (n, us) in top],
               port_kernels_count_and_mean_device_ms=ours)
    if fold_us:
        out["stream_kernel_us"] = dict(
            launches=len(fold_us), mean=statistics.fmean(fold_us),
            median=statistics.median(fold_us), max=fold_us[-1])
    out["read_s"] = time.perf_counter() - t0
    print(f"profile {label}:", json.dumps(out))
    return out


def expected_launches(num_nodes, batch, max_pages, budget, layers,
                      mode="pull") -> dict:
    """Kernel launches of one decode step of bridge_pull or bridge_push,
    from its shapes: a layer flushes k and v through one push round each
    (``push_commit``, or ``scatter_pages`` on one node); the pull also
    gathers (and on N nodes commits) k and v a round and folds each round;
    the push attends at the memory with no kernel."""
    per_node = -(-batch // num_nodes)
    rounds = -(-per_node * max_pages // budget)
    flush_rounds = -(-per_node // budget)
    want = dict.fromkeys(KERNELS, 0)
    if num_nodes == 1:
        want["scatter_pages"] = 2 * layers
    else:
        want["push_commit"] = 2 * flush_rounds * layers
    if mode == "pull":
        want.update(gather_pages=2 * rounds * layers,
                    stream_decode_accumulate=rounds * layers)
        if num_nodes > 1:
            want["pull_commit"] = 2 * rounds * layers
    return want


def hold_launches(report: dict, label: str, counts: dict, want: dict,
                  steps: int) -> dict:
    """Every kernel's launches over ``steps`` decode steps, counted from 0
    just before the path ran, must be exactly ``want`` a step (so a kernel
    of the path that never launched fails); they go into the report under
    ``label``.  Returns the launches a step."""
    per_step = {}
    for name, n in counts.items():
        per_step[name] = n / steps
        if per_step[name] != want[name]:
            raise AssertionError(f"{label}: {name} launched {per_step[name]} "
                                 f"times a step, expected {want[name]}")
        report[name]["launches"] += n
        if n:
            entry = report[name]["by_path"].setdefault(label, {})
            entry.update(launches=n, launches_per_step=per_step[name])
    return per_step


# the planted-fault runs stop after step 18, the second step that reads a
# flushed page (page 0, flushed when the 16th token is in; cut from 24
# steps so the whole smoke keeps inside its limit)
FULL = dict(batch=8, max_len=1024, page_tokens=16, steps=48, prompt=40,
            fault_steps=18)
# Every bridge run of phase 3 but the 8-node pull (the 1-node pull, the
# planted faults, the pushes and the counters-on runs) takes the first 10
# of granite-3-8b's 40 layers, at full width and for all its steps, held
# to local on those layers over the same tokens: each layer runs the same
# rounds, so depth adds time and no round kind (cut from 40 layers so the
# whole smoke keeps well inside its limit on a slow host).
SHALLOW = 10


def full_params(dev="cuda"):
    """Full-width granite-3-8b in bf16 with weights from seed 0, made once
    for the decode and the forward phases."""
    cfg = configs.get_config("granite-3-8b")
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
    return cfg, params, gen


def shallow(cfg, params):
    """The first ``SHALLOW`` layers of the model, at full width: the
    config and a view of the weights."""
    return (dataclasses.replace(cfg, num_layers=SHALLOW),
            dict(params, layers=params["layers"][:SHALLOW]))


def full_width(report: dict, cfg, params, gen, dev="cuda") -> dict:
    batch, max_len, page_tokens, steps = (FULL[k] for k in (
        "batch", "max_len", "page_tokens", "steps"))
    fault_steps = FULL["fault_steps"]
    prompt = torch.randint(0, cfg.vocab_size, (FULL["prompt"], batch),
                           generator=gen, device=dev, dtype=torch.int32)
    shape = (batch, max_len, page_tokens)
    inputs, local_logits, local_ms, local_next, local_state = decode(
        cfg, params, "local", *shape, steps, prompt, dev=dev)
    # what the shallow paths are held to: local over the same tokens
    cfg_s, params_s = shallow(cfg, params)
    _, local_s, _, _, _ = decode(cfg_s, params_s, "local", *shape, steps,
                                 inputs, dev=dev)
    depth = {"1-node": (cfg_s, params_s, local_s),
             f"{NODES}-node": (cfg, params, local_logits)}
    off_logits, off_ms = {}, {}
    out = dict(local_ms_per_step=statistics.median(local_ms[1:]),
               local_first_step_ms=local_ms[0])
    profile_step("local", local_next)
    del local_next
    for path, n in PATHS.items():
        p_cfg, p_params, p_local = depth[path]
        reset_launches()
        _, pull_logits, pull_ms, pull_next, pull_state = decode(
            p_cfg, p_params, "bridge_pull", *shape, steps, inputs,
            num_nodes=n, dev=dev)
        counts = read_launches()
        want = expected_launches(n, batch, -(-max_len // page_tokens), 8,
                                 p_cfg.num_layers)
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
        if not (torch.isfinite(p_local).all()
                and torch.isfinite(pull_logits).all()):
            raise AssertionError(f"non-finite logits at full width ({path})")
        worst = worst_rel_diff(pull_logits, p_local)
        if worst > FULL_LOGIT_REL_TOL:
            raise AssertionError(f"{path} bridge_pull logits differ from "
                                 f"local by {worst:.3g} of the largest logit")
        agree = float((pull_logits.argmax(-1) == p_local.argmax(-1))
                      .float().mean())
        faults = {}
        with planted_fault():
            _, fault_logits, _, _, _ = decode(
                cfg_s, params_s, "bridge_pull", *shape, fault_steps, inputs,
                num_nodes=n, dev=dev)
        faults["lost_lane"] = worst_rel_diff(fault_logits,
                                             local_s[:fault_steps])
        if n > 1:
            _, fault_logits, _, _, _ = decode(
                cfg_s, params_s, "bridge_pull", *shape, fault_steps, inputs,
                num_nodes=n, program=unwired_distance_4(dev), dev=dev)
            faults["unwired_distance_4"] = worst_rel_diff(
                fault_logits, local_s[:fault_steps])
        for fault, rel in faults.items():
            if not rel > FULL_LOGIT_REL_TOL:
                raise AssertionError(
                    f"{path} planted fault {fault} moved the logits by only "
                    f"{rel:.3g} of the largest: the full-width check would "
                    f"pass it")
        out[path] = dict(
            layers=p_cfg.num_layers,
            bridge_pull_ms_per_step=statistics.median(pull_ms[1:]),
            bridge_pull_first_step_ms=pull_ms[0], greedy_agreement=agree,
            worst_logit_rel_diff=worst,
            planted_faults_worst_logit_rel_diff=faults,
            launches_per_step={k: c / steps for k, c in counts.items()})
        out[path]["profile"] = profile_step(f"bridge_pull {path}", pull_next)
        del pull_next
        if n == NODES:
            out["paged_api"] = paged_over_pool(report, cfg, local_state,
                                               pull_state, gen, dev)
        del pull_state
        # what the telemetry runs are held to: the same steps and layers,
        # counters off
        if p_cfg is cfg_s:
            off_logits[path] = pull_logits[:TELEM["steps"]].clone()
            off_ms[path] = out[path]["bridge_pull_ms_per_step"]
        else:
            _, off, off_step_ms, _, _ = decode(
                cfg_s, params_s, "bridge_pull", *shape, TELEM["steps"],
                inputs, num_nodes=n, dev=dev)
            off_logits[path], off_ms[path] = off, statistics.median(
                off_step_ms[1:])
        del pull_logits
    out.update(pages_flushed_per_sequence=steps // page_tokens,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("full:", json.dumps({k: v for k, v in out.items()
                               if not isinstance(v, dict)}))
    for path in PATHS:
        print(f"full {path}:", json.dumps({k: v for k, v in out[path].items()
                                            if k != "profile"}))
    del local_state
    torch.cuda.empty_cache()
    return out, dict(inputs=inputs, off_logits=off_logits, off_ms=off_ms,
                     shallow=depth["1-node"])


@contextlib.contextmanager
def planted_push_fault():
    """Drop the last live lane of every push round (each flush of a step is
    one round here): a bridge that loses a written page.  The checks of the
    push paths must reject what this produces."""
    real = bridge.push_pages

    def lossy(pool, dest, payload, table, **kw):
        flat = dest.reshape(-1)
        lane = torch.arange(flat.numel(), device=flat.device)
        last = torch.where(flat >= 0, lane, -1).max()
        dest = torch.where(lane == last, FREE, flat).view(dest.shape)
        return real(pool, dest, payload, table, **kw)

    bridge.push_pages = lossy
    try:
        yield
    finally:
        bridge.push_pages = real


def push_paths(report: dict, ctx: dict, dev="cuda") -> dict:
    """bridge_push (attention at the memory nodes) on 1 and 8 nodes at full
    width and ``SHALLOW`` layers, fed the tokens of phase 3: logits held to
    local's on those layers, exact launches (the flushes only), a profiled
    step, and a planted lost write that the limit must reject."""
    shape = (FULL["batch"], FULL["max_len"], FULL["page_tokens"])
    steps, fault_steps = FULL["steps"], FULL["fault_steps"]
    inputs = ctx["inputs"]
    cfg, params, local_logits = ctx["shallow"]
    out = {}
    for path, n in PATHS.items():
        reset_launches()
        _, logits, ms, nxt, state = decode(cfg, params, "bridge_push",
                                           *shape, steps, inputs,
                                           num_nodes=n, dev=dev)
        counts = read_launches()
        per_step = hold_launches(
            report, f"{path} push", counts,
            expected_launches(n, FULL["batch"], shape[1] // shape[2], 8,
                              cfg.num_layers, mode="push"), steps)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"non-finite bridge_push logits ({path})")
        worst = worst_rel_diff(logits, local_logits)
        if worst > FULL_LOGIT_REL_TOL:
            raise AssertionError(f"{path} bridge_push logits differ from "
                                 f"local by {worst:.3g} of the largest logit")
        with planted_push_fault():
            _, fault_logits, _, _, _ = decode(
                cfg, params, "bridge_push", *shape, fault_steps, inputs,
                num_nodes=n, dev=dev)
        fault = worst_rel_diff(fault_logits, local_logits[:fault_steps])
        if not fault > FULL_LOGIT_REL_TOL:
            raise AssertionError(f"{path} planted lost write moved the "
                                 f"bridge_push logits by only {fault:.3g}")
        out[path] = dict(
            layers=cfg.num_layers,
            bridge_push_ms_per_step=statistics.median(ms[1:]),
            bridge_push_first_step_ms=ms[0], worst_logit_rel_diff=worst,
            planted_lost_write_rel_diff=fault,
            greedy_agreement=float((logits.argmax(-1)
                                    == local_logits.argmax(-1))
                                   .float().mean()),
            launches_per_step={k: v for k, v in per_step.items() if v})
        out[path]["profile"] = profile_step(f"bridge_push {path}", nxt)
        print(f"push {path}:", json.dumps({k: v for k, v in out[path].items()
                                            if k != "profile"}))
        del nxt, state, logits
    return out


# ---------------------------------------------------------------------------
# Phase 3, telemetry: bridge_pull with the in-band counters on
# ---------------------------------------------------------------------------

# (a) 20 steps: the first flushed page of each sequence is pulled in steps
# 17-20; (b) 40 steps: pages 0 and 1 of every sequence are pulled.
TELEM = dict(steps=20, fabric_steps=40, tenants=2)


def by_node_np(x: np.ndarray, n: int, fill) -> np.ndarray:
    """[B, ...] -> [N, ceil(B / N), ...], padding rows ``fill``
    (``kvbridge._by_node`` on the host)."""
    per = -(-x.shape[0] // n)
    pad = n * per - x.shape[0]
    if pad:
        x = np.concatenate([x, np.full((pad,) + x.shape[1:], fill, x.dtype)])
    return x.reshape((n, per) + x.shape[1:])


def oracle_counters(steps, n, table, program, topology, tenant,
                    max_tenants):
    """The host oracle (``core/ref.expected_transfer_telemetry``) summed
    over every bridge transfer of one layer in ``steps`` decode steps,
    every sequence at length s in step s: the k and v flush of the step's
    append, then the k and v pull of each round of its request list.  The
    lists are built here on the host, as kvbridge builds them; every layer
    sees the same lists."""
    batch, page_t, budget = FULL["batch"], FULL["page_tokens"], 8
    max_pages = FULL["max_len"] // page_t
    table_c = MemPortTable(table.home.cpu(), table.slot.cpu())
    program_c = None if program is None else program.to("cpu")
    ids = (np.arange(batch)[:, None] * max_pages
           + np.arange(max_pages)[None, :]).astype(np.int32)
    page_tenant = by_node_np(np.repeat(tenant[:, None], max_pages, 1), n,
                             0).reshape(n, -1)
    seq_tenant = by_node_np(tenant, n, 0)
    total = None
    for s in range(steps):
        full = s % page_t == page_t - 1 and s // page_t < max_pages
        dest = np.full(batch, FREE, np.int32)
        if full:
            dest = (np.arange(batch) * max_pages + s // page_t).astype(
                np.int32)
        lists = [(by_node_np(dest, n, FREE), seq_tenant)]
        want = np.where(np.arange(max_pages)[None, :] < (s + 1) // page_t,
                        ids, FREE).astype(np.int32)
        want = by_node_np(want, n, FREE).reshape(n, -1)
        lists += [(want[:, i:i + budget], page_tenant[:, i:i + budget])
                  for i in range(0, want.shape[1], budget)]
        for req, ten in lists:
            t = tref.expected_transfer_telemetry(
                req, table_c, program_c, num_nodes=n, budget=budget,
                topology=topology, tenant_ids=ten, max_tenants=max_tenants)
            t = tcounters.add(t, t)                   # the k and the v pool
            total = t if total is None else tcounters.add(total, t)
    return total


def hold_counters(label: str, state: dict, want) -> None:
    """Every layer's cumulative counters equal the oracle, bit for bit."""
    want_h = {f.name: getattr(want, f.name).numpy() for f in fields(want)}
    for i, st in enumerate(state["layers"]):
        got = to_host(st["telem"])
        for name, w in want_h.items():
            if not np.array_equal(getattr(got, name), w):
                raise AssertionError(
                    f"{label}: layer {i} {name} {getattr(got, name).tolist()}"
                    f" != oracle {w.tolist()}")


def scattered_table(dev) -> MemPortTable:
    """Page p of sequence j homed at node (3j + p + 1) mod 8, slot p: for
    each p a bijection over j, so every node holds 64 pages, and pages 0
    and 1 of the 8 sequences lie at every ring distance 0-7 from their
    sequence's node."""
    batch, max_pages = FULL["batch"], FULL["max_len"] // FULL["page_tokens"]
    j = torch.arange(batch, device=dev)[:, None]
    p = torch.arange(max_pages, device=dev)[None, :]
    home = torch.remainder(3 * j + p + 1, NODES).to(torch.int32)
    slot = torch.broadcast_to(p, home.shape).to(torch.int32)
    return MemPortTable(home=home.reshape(-1).contiguous(),
                        slot=slot.reshape(-1).contiguous())


def telemetry_runs(report: dict, ctx: dict, dev="cuda") -> dict:
    """bridge_pull with the counters on, tenant lane b % 2, on ``SHALLOW``
    layers: (a) on 1 and 8 nodes with the default table and program, logits
    bit-identical to the same steps of phase 3's counters-off run on those
    layers, every layer's counters equal
    to the host oracle, the launches of the counters-off path; (b) on 8
    nodes with a scattered table and a two-board fabric whose hierarchical
    program wires every (rank, slot) pair, so that every counter field
    carries traffic."""
    shape = (FULL["batch"], FULL["max_len"], FULL["page_tokens"])
    max_pages = shape[1] // shape[2]
    tenant = np.arange(FULL["batch"]) % TELEM["tenants"]
    kw = dict(collect_telemetry=True, tenant_of_seq=tenant,
              max_tenants=TELEM["tenants"])
    inputs = ctx["inputs"]
    cfg, params, local_logits = ctx["shallow"]
    out = {}
    runs = [(path, n, TELEM["steps"], {}) for path, n in PATHS.items()]
    topo = Topology.boards(2, 4)
    runs.append((f"{NODES}-node fabric", NODES, TELEM["fabric_steps"],
                 dict(program=steering.hierarchical_program(topo, device=dev),
                      table=scattered_table(dev), topology=topo)))
    for label, n, steps, fabric in runs:
        reset_launches()
        _, logits, ms, nxt, state = decode(
            cfg, params, "bridge_pull", *shape, steps, inputs,
            num_nodes=n, dev=dev, **kw, **fabric)
        counts = read_launches()
        hold_launches(report, f"{label} telemetry", counts,
                      expected_launches(n, shape[0], max_pages, 8,
                                        cfg.num_layers), steps)
        res = dict(steps=steps, layers=cfg.num_layers,
                   ms_per_step=statistics.median(ms[1:]), first_step_ms=ms[0])
        if label in PATHS:
            off = ctx["off_logits"][label]
            res["logits_bit_identical_to_counters_off"] = bool(
                torch.equal(logits, off))
            if not res["logits_bit_identical_to_counters_off"]:
                # Is the counters-off path itself repeatable on the card?
                _, again, _, _, _ = decode(cfg, params, "bridge_pull",
                                           *shape, steps, inputs,
                                           num_nodes=n, dev=dev)
                if torch.equal(again, off):
                    raise AssertionError(f"{label}: the counters changed "
                                         f"the logits")
                res["counters_off_repeatable"] = False
            res["counters_off_ms_per_step"] = ctx["off_ms"][label]
        res["worst_logit_rel_diff"] = worst_rel_diff(logits,
                                                     local_logits[:steps])
        if res["worst_logit_rel_diff"] > FULL_LOGIT_REL_TOL:
            raise AssertionError(f"{label} telemetry logits differ from "
                                 f"local by {res['worst_logit_rel_diff']:.3g}")
        program = state["kv_shared"].get("program")
        t0 = time.perf_counter()
        want = oracle_counters(steps, n, state["kv_shared"]["table"], program,
                               fabric.get("topology"), tenant,
                               TELEM["tenants"])
        hold_counters(label, state, want)
        res["oracle_s"] = time.perf_counter() - t0
        total = to_host(serve_step.collect_state_telemetry(state))
        served = total.loopback_served + total.slot_served.sum(-1)
        if not (np.array_equal(total.tenant_served.sum(-1), served)
                and np.array_equal(total.tenant_spilled.sum(-1),
                                   total.spilled)
                and np.array_equal(total.tenant_pruned.sum(-1),
                                   total.pruned)):
            raise AssertionError(f"{label}: tenant sums do not reconcile")
        res.update(served_pages=int(served.sum()),
                   tenant_served=total.tenant_served.sum(0).tolist(),
                   slot_served=total.slot_served.sum(0).tolist(),
                   tier_hops=total.tier_hops.sum(0).tolist(),
                   epoch_cw=total.epoch_cw.sum(0).tolist(),
                   epoch_ccw=total.epoch_ccw.sum(0).tolist(),
                   spilled=int(total.spilled.sum()),
                   pruned=int(total.pruned.sum()))
        if fabric and not ((total.slot_served.sum(0) > 0).all()
                           and (total.tier_hops.sum(0) > 0).all()
                           and res["spilled"] == 0 and res["pruned"] == 0):
            raise AssertionError(f"{label}: a counter carries no traffic or "
                                 f"a page was dropped: {res}")
        if fabric:
            agg = TelemetryAggregator(n, max_tenants=TELEM["tenants"])
            agg.update(serve_step.collect_state_telemetry(state))
            print(agg.describe())
        # Every layer runs the same ops: the launches the counters add to a
        # step are the layers times those they add to one layer's cache
        # op, profiled with the counters on and off on the same state.
        layer = {}
        for on in (True, False):
            ops = serve_step.make_cache_ops(
                RunConfig(model=cfg, shape=ShapeConfig(
                    "smoke", shape[1], shape[0], "decode"),
                    kv_placement="bridge_pull",
                    bridge=BridgeConfig(channels=1)),
                shape[1], shape[2], num_nodes=n, device=dev,
                topology=fabric.get("topology"),
                **(kw if on else {}))
            layer[on] = cache_op_launches(cfg, ops, state, on, dev)
        res.update(layer_launches_counters_on=layer[True],
                   layer_launches_counters_off=layer[False],
                   launches_added_per_step=(layer[True] - layer[False])
                   * cfg.num_layers)
        out[label] = res
        print(f"telemetry {label}:", json.dumps(res))
        del nxt, state, logits
    return out


def cache_op_launches(cfg, ops, state, with_counters: bool, dev) -> int:
    """Kernel launches on the card, from the profiler, of one call of
    layer 0's cache op (append one token, attend) on ``state``."""
    from torch.profiler import ProfilerActivity, profile
    b = state["lengths"].shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    q, k_new, v_new = (torch.randn((b, h, cfg.head_dim), generator=gen,
                                   device=dev).bfloat16()
                       for h in (cfg.num_heads, cfg.num_kv_heads,
                                 cfg.num_kv_heads))
    st = state["layers"][0]
    if not with_counters:
        st = {"paged": st["paged"]}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ops.append_and_attend(cfg, st, state["kv_shared"], state["lengths"],
                              q, k_new, v_new)
        torch.cuda.synchronize()
    return len(device_events(prof))


def paged_over_pool(report, cfg, local_state, pull_state, gen, dev) -> dict:
    """The kernel API's paged decode attention over the KV pool that the
    8-node bridge_pull decode left behind: layer 0's pages, addressed
    through the memport table (page table = the flat pool rows of each
    sequence's logical pages), against dense attention over the ``local``
    cache of the same tokens.  Layer 0's k and v depend on the tokens only,
    so the two caches hold the same values."""
    layer = pull_state["layers"][0]["paged"]
    table = pull_state["kv_shared"]["table"]
    lengths = pull_state["lengths"]
    b = lengths.shape[0]
    max_pages = FULL["max_len"] // FULL["page_tokens"]
    ppn = layer.k_pool.shape[0] // NODES
    home, slot = table.translate(
        kvbridge.logical_page_ids(b, max_pages, device=dev).reshape(-1))
    rows = (home * ppn + slot).view(b, max_pages).to(torch.int32)
    q = torch.randn((b, cfg.num_heads, cfg.head_dim), generator=gen,
                    device=dev).bfloat16()
    reset_launches()
    got = kops.paged_attention(q, layer.k_pool, layer.v_pool, rows, lengths,
                               max_pages=max_pages)
    sync(dev)
    counts = read_launches()
    flushed = (lengths // FULL["page_tokens"]) * FULL["page_tokens"]
    pos = torch.arange(FULL["max_len"], device=dev)
    want = kvbridge.masked_decode_attention(
        q, local_state["layers"][0]["k"], local_state["layers"][0]["v"],
        pos[None, :] < flushed[:, None])
    err = float((got.float() - want.float()).abs().max())
    if not err <= PAGED_TOL["bfloat16"]:
        raise AssertionError(f"paged decode over the 8-node pool differs from "
                             f"local attention by {err:.3g}")
    if counts["paged_attention"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"paged decode over the pool launched {counts}")
    count_path(report, "api", counts)
    out = dict(flushed_tokens=flushed.tolist(), max_abs_err_vs_local=err,
               launches=counts["paged_attention"])
    print("paged api:", json.dumps(out))
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
    local_in, local_logits, _, _, _ = decode(*args, "local", *shape, prompt,
                                             **kw)
    for path, n in PATHS.items():
        pull_in, pull_logits, _, _, _ = decode(*args, "bridge_pull", *shape,
                                               prompt, num_nodes=n, **kw)
        if not torch.equal(local_in, pull_in):
            raise AssertionError(f"reduced f32: local and {path} bridge_pull "
                                 f"tokens differ")
        torch.testing.assert_close(pull_logits, local_logits,
                                   **REDUCED_LOGIT_TOL)
        err = float((pull_logits - local_logits).abs().max())
        with planted_fault():
            _, fault_logits, _, _, _ = decode(*args, "bridge_pull", *shape,
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
    tel = dict(collect_telemetry=True, tenant_of_seq=np.arange(batch) % 2,
               max_tenants=2)
    for label, kv, n, extra in (
            ("ring", "ring", 1, {}),
            ("1-node bridge_push", "bridge_push", 1, {}),
            (f"{NODES}-node bridge_push", "bridge_push", NODES, {}),
            ("1-node bridge_pull telemetry", "bridge_pull", 1, tel),
            (f"{NODES}-node bridge_pull telemetry", "bridge_pull", NODES,
             tel)):
        got_in, got_logits, _, _, _ = decode(*args, kv, *shape, prompt,
                                             num_nodes=n, **kw, **extra)
        if not torch.equal(local_in, got_in):
            raise AssertionError(f"reduced f32: local and {label} tokens "
                                 f"differ")
        torch.testing.assert_close(got_logits, local_logits,
                                   **REDUCED_LOGIT_TOL)
        print(f"reduced {label}: float32 tokens == local's, max logit "
              f"difference {float((got_logits - local_logits).abs().max()):.3g}")


# ---------------------------------------------------------------------------
# Phase 5: the sequence forward (prefill / scoring)
# ---------------------------------------------------------------------------

FORWARD = dict(batch=8, seq=1024, repeats=5, check_seq=200)


@contextlib.contextmanager
def shifted_mask():
    """Attention through the flash kernel with q_offset shifted by one, so
    every query also sees the next token: a mask fault.  The forward's
    checks must reject what this produces."""
    real = attention.flash_attention

    def leaky(q, k, v, *, causal=True, window=0, q_offset=0):
        return real(q, k, v, causal=causal, window=window,
                    q_offset=q_offset + 1)

    attention.flash_attention = leaky
    try:
        yield
    finally:
        attention.flash_attention = real


def forward_vs_decode(cfg, params, tokens, dtype, dev):
    """(forward logits, teacher-forced local decode logits, the forward's
    logits under the planted mask fault), each [S, B, V]."""
    b, s = tokens.shape
    fwd, _ = transformer.forward(cfg, params, {"tokens": tokens})
    with shifted_mask():
        fault, _ = transformer.forward(cfg, params, {"tokens": tokens})
    _, local, _, _, _ = decode(cfg, params, "local", b, s, 16, s,
                               tokens.T.contiguous(), dtype=dtype, dev=dev)
    return fwd.transpose(0, 1), local, fault.transpose(0, 1)


def forward_phase(report: dict, cfg, params, dev="cuda") -> dict:
    """Full-width granite-3-8b sequence forward: timed at B 8 x S 1024 with
    the flash kernel's launches counted (one per layer, every one the bf16
    tensor-core kernel), then held to teacher-forced local decode over 200
    tokens, with a planted mask fault that the check must reject."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    b, s, repeats = FORWARD["batch"], FORWARD["seq"], FORWARD["repeats"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     device=dev, dtype=torch.int32)}
    logits, _ = transformer.forward(cfg, params, batch)       # warm-up
    if (tuple(logits.shape) != (b, s, cfg.vocab_size)
            or logits.dtype != torch.float32
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"forward logits {list(logits.shape)} "
                             f"{logits.dtype} (finite: "
                             f"{bool(torch.isfinite(logits).all())})")
    del logits
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        logits, _ = transformer.forward(cfg, params, batch)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        del logits
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = cfg.num_layers * repeats
    if counts != want:
        raise AssertionError(f"forward launched {counts}, expected {want}")
    count_path(report, "forward", counts)
    ms = statistics.median(times)
    prof = profile_step("forward", lambda: transformer.forward(cfg, params,
                                                               batch))

    tokens = torch.randint(0, cfg.vocab_size, (b, FORWARD["check_seq"]),
                           generator=gen, device=dev, dtype=torch.int32)
    fwd, local, fault = forward_vs_decode(cfg, params, tokens,
                                          torch.bfloat16, dev)
    if not (torch.isfinite(fwd).all() and torch.isfinite(local).all()):
        raise AssertionError("non-finite logits in the forward check")
    worst = worst_rel_diff(fwd, local)
    if worst > FORWARD_LOGIT_REL_TOL:
        raise AssertionError(f"forward logits differ from local decode by "
                             f"{worst:.3g} of the largest logit")
    fault_rel = worst_rel_diff(fault, local)
    if not fault_rel > FORWARD_LOGIT_REL_TOL:
        raise AssertionError(f"planted mask fault moved the forward's logits "
                             f"by only {fault_rel:.3g} of the largest: the "
                             f"check would pass it")
    out = dict(batch=b, seq=s, ms_per_forward=ms, forward_ms=times,
               prefill_tokens_per_s=b * s / (ms / 1e3),
               flash_launches_per_forward=counts["flash_attention"] / repeats,
               peak_gb=peak, check_seq=FORWARD["check_seq"],
               worst_logit_rel_diff_vs_local=worst,
               planted_mask_fault_rel_diff=fault_rel,
               greedy_agreement=float((fwd.argmax(-1) == local.argmax(-1))
                                      .float().mean()),
               profile_device_ms=prof["device_ms"])
    print("forward:", json.dumps(out))
    return out


def forward_reduced_f32(report: dict, dev="cuda") -> dict:
    """Reduced granite-3-8b in float32: the forward against teacher-forced
    local decode at 1e-4 per position; the planted mask fault must break
    that limit.  Each of the two forwards launches one float32 three-term
    TF32 flash kernel per layer, and nothing else of the port's kernels."""
    cfg = dataclasses.replace(configs.get_reduced("granite-3-8b"),
                              dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (4, 48), generator=gen,
                           device=dev, dtype=torch.int32)
    reset_launches()
    fwd, local, fault = forward_vs_decode(cfg, params, tokens, torch.float32,
                                          dev)
    counts = read_launches()
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention_f32"] = 2 * cfg.num_layers
    if counts != want:
        raise AssertionError(f"reduced f32 forward launched {counts}, "
                             f"expected {want}")
    count_path(report, "forward f32", counts)
    torch.testing.assert_close(fwd, local, **REDUCED_LOGIT_TOL)
    if torch.allclose(fault, local, **REDUCED_LOGIT_TOL):
        raise AssertionError("reduced f32: the planted mask fault passes the "
                             "forward check")
    out = dict(max_logit_diff=float((fwd - local).abs().max()),
               planted_mask_fault=float((fault - local).abs().max()))
    print("forward reduced:", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 6: STREAM through the bridge (the check of the paper's Figure 3)
# ---------------------------------------------------------------------------

def stream_bridge(report: dict, dev="cuda") -> dict:
    """Triad over 65,536 float32 elements held as 32 pages of 2048 in a
    pool blocked over 4 memory nodes, node 0 pulling every page through the
    4-node bridge (budget 8): bit-identical to triad on the local arrays."""
    n, page, nodes = 65536, 2048, 4
    pages = n // page
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    b = torch.randn((n,), generator=gen, device=dev)
    c = torch.randn((n,), generator=gen, device=dev)
    table = MemPortTable.blocked(pages, nodes, pages // nodes, device=dev)
    want = torch.full((nodes, pages), FREE, dtype=torch.int32, device=dev)
    want[0] = torch.arange(pages, dtype=torch.int32, device=dev)

    def remote():
        kw = dict(num_nodes=nodes, budget=8)
        c_rem = bridge.pull_pages(c.view(pages, page), want, table, **kw)
        b_rem = bridge.pull_pages(b.view(pages, page), want, table, **kw)
        return kops.stream_triad(b_rem[0].reshape(-1), c_rem[0].reshape(-1))

    reset_launches()
    local = kops.stream_triad(b, c)
    got = remote()
    sync(dev)
    counts = read_launches()
    if not torch.equal(local, got):
        raise AssertionError("triad through the 4-node bridge differs from "
                             "triad on the local arrays")
    if (counts["stream"] != 2 or not counts["gather_pages"]
            or not counts["pull_commit"]):
        raise AssertionError(f"STREAM through the bridge launched {counts}")
    count_path(report, "bridge", counts)
    out = dict(elements=n, pages=pages, nodes=nodes, bit_identical=True,
               local_triad_ms=cuda_ms(lambda: kops.stream_triad(b, c),
                                      iters=50),
               bridge_pull_and_triad_ms=cuda_ms(remote, iters=20),
               launches=counts)
    print("stream bridge:", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 7: route programs swap at run time
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


def hold_transfer_counters(label: str, got, want) -> None:
    """One transfer's counters on the card equal the host oracle's."""
    got = to_host(got)
    for f in fields(want):
        if not np.array_equal(getattr(got, f.name),
                              getattr(want, f.name).numpy()):
            raise AssertionError(f"{label}: {f.name} differs from the oracle")


BRIDGE_KERNELS = ("gather_pages", "pull_commit", "push_commit",
                  "scatter_pages")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-identical bf16 tensors (a -0.0 against +0.0 differs)."""
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


def hold_no_bridge_launch(label: str, counts: dict) -> None:
    """None of the four bridge kernels launched in ``counts``."""
    if any(counts[name] for name in BRIDGE_KERNELS):
        raise AssertionError(f"{label} launched bridge kernels: "
                             f"{ {k: counts[k] for k in BRIDGE_KERNELS} }")


def programs_swap(dev="cuda") -> dict:
    """Pull and push under every program back to back on one card pool,
    bit-exact against the plain path on a CPU copy, with the counters on
    (a tenant lane, the hierarchical program's fabric) and held to the host
    oracle, building nothing; each also through the unfused engine,
    bit-exact against the fused engine and the plain path, its counters
    held to the oracle, launching no bridge kernel; then one round trip
    under the sync debugger, counters off and on, and one unfused pull and
    push."""
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
    ten_c = torch.randint(-1, 5, (NODES, 12), generator=gen,
                          dtype=torch.int32)
    ten_g = ten_c.to(dev)
    variants = program_variants(dev)
    topo = Topology.boards(2, 4)
    runs_before = _build.nvcc_runs
    kw = dict(num_nodes=NODES, budget=8, channels=2)
    tel = dict(collect_telemetry=True, max_tenants=3)
    t_engines = 0.0
    for name, prog in variants.items():
        prog_c = prog.to("cpu")
        topology = topo if name == "hierarchical" else None
        for ab in (None, (ab_g, ab_c)):
            ab_dev, ab_cpu = (None, None) if ab is None else ab
            got, got_t = bridge.pull_pages(
                pool_g, want_g, table_g, program=prog, active_budget=ab_dev,
                topology=topology, tenant_ids=ten_g, **kw, **tel)
            want = bridge.pull_pages(pool_c, want_c, table_c, program=prog_c,
                                     active_budget=ab_cpu, **kw)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"8-node pull under {name} disagrees "
                                     f"with the plain path")
            pull_oracle = tref.expected_transfer_telemetry(
                want_c, table_c, prog_c, num_nodes=NODES, budget=8,
                active_budget=ab_cpu, topology=topology, tenant_ids=ten_c,
                max_tenants=3)
            hold_transfer_counters(f"8-node pull under {name}", got_t,
                                   pull_oracle)
            push_oracle = tref.expected_transfer_telemetry(
                dest_c, table_c, prog_c, num_nodes=NODES, budget=8,
                active_budget=ab_cpu, topology=topology, max_tenants=3)
            before = pool_g.clone()
            _, got_t = bridge.push_pages(
                pool_g, dest_g, pay_g, table_g, program=prog,
                active_budget=ab_dev, topology=topology, **kw, **tel)
            bridge.push_pages(pool_c, dest_c, pay_c, table_c, program=prog_c,
                              active_budget=ab_cpu, **kw)
            if not torch.equal(pool_g.cpu(), pool_c):
                raise AssertionError(f"8-node push under {name} disagrees "
                                     f"with the plain path")
            hold_transfer_counters(f"8-node push under {name}", got_t,
                                   push_oracle)
            # the unfused engine on the same pool and requests
            t_sub = time.perf_counter()
            reset_launches()
            label = f"8-node unfused under {name}"
            e_got, e_t = bridge.pull_pages(
                before, want_g, table_g, program=prog, active_budget=ab_dev,
                topology=topology, tenant_ids=ten_g, fused=False, **kw,
                **tel)
            if not (same_bits(e_got, got) and torch.equal(e_got.cpu(), want)):
                raise AssertionError(f"{label}: pull disagrees with the "
                                     f"fused engine or the plain path")
            hold_transfer_counters(f"{label} pull", e_t, pull_oracle)
            _, e_t = bridge.push_pages(
                before, dest_g, pay_g, table_g, program=prog,
                active_budget=ab_dev, topology=topology, fused=False, **kw,
                **tel)
            if not (same_bits(before, pool_g)
                    and torch.equal(before.cpu(), pool_c)):
                raise AssertionError(f"{label}: push disagrees with the "
                                     f"fused engine or the plain path")
            hold_transfer_counters(f"{label} push", e_t, push_oracle)
            hold_no_bridge_launch(label, read_launches())
            t_engines += time.perf_counter() - t_sub
            del before
    if _build.nvcc_runs != runs_before:
        raise AssertionError("swapping route programs ran nvcc")
    prog = variants["hierarchical"]
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pulled = bridge.pull_pages(pool_g, want_g, table_g, program=prog,
                                   active_budget=ab_g, **kw)
        fused_counts = read_launches()
        # one unfused pull and push, on the pool the fused pull read
        reset_launches()
        unfused = bridge.pull_pages(pool_g, want_g, table_g, program=prog,
                                    active_budget=ab_g, fused=False, **kw)
        bridge.push_pages(pool_g, dest_g, pay_g, table_g, program=prog,
                          active_budget=ab_g, fused=False, **kw)
        unfused_counts = read_launches()
        bridge.push_pages(pool_g, dest_g, pay_g, table_g, program=prog,
                          active_budget=ab_g, **kw)
        # and with the counters on, a tenant lane and the program's fabric
        _, pull_t = bridge.pull_pages(
            pool_g, want_g, table_g, program=prog, active_budget=ab_g,
            topology=topo, tenant_ids=ten_g, **kw, **tel)
        _, push_t = bridge.push_pages(
            pool_g, dest_g, pay_g, table_g, program=prog, active_budget=ab_g,
            topology=topo, tenant_ids=ten_g[:, :6], **kw, **tel)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    hold_no_bridge_launch("the unfused engine under the sync debugger",
                          unfused_counts)
    if not (fused_counts["gather_pages"] and fused_counts["pull_commit"]):
        raise AssertionError(f"the fused pull under the sync debugger "
                             f"launched {fused_counts}")
    if not torch.isfinite(pulled.float()).all():
        raise AssertionError("sync-debug round trip pulled non-finite pages")
    if not same_bits(unfused, pulled):
        raise AssertionError("sync-debug unfused pull disagrees with the "
                             "fused engine's")
    prog_c = prog.to("cpu")
    hold_transfer_counters("sync-debug pull", pull_t,
                           tref.expected_transfer_telemetry(
                               want_c, table_c, prog_c, num_nodes=NODES,
                               budget=8, active_budget=ab_c, topology=topo,
                               tenant_ids=ten_c, max_tenants=3))
    hold_transfer_counters("sync-debug push", push_t,
                           tref.expected_transfer_telemetry(
                               dest_c, table_c, prog_c, num_nodes=NODES,
                               budget=8, active_budget=ab_c, topology=topo,
                               tenant_ids=ten_c[:, :6], max_tenants=3))
    out = dict(programs=list(variants), nvcc_runs_during_swaps=0,
               sync_debug_round_trip="ok",
               counters_equal_oracle="every program, throttled and not, "
                                     "every engine, and under the sync "
                                     "debugger",
               unfused_engine_bit_exact="fused engine and plain path, "
                                        "every program, throttled and not",
               unfused_bridge_kernel_launches=0,
               unfused_engine_s=t_engines)
    print("programs:", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 8: the software control plane's closed loop
# ---------------------------------------------------------------------------

CONTROL = dict(slots=2048, requests=256, budget=8, page=(16, 8, 128),
               migrate=64, failed=3)
CONTROL_PAGE_BYTES = 16 * 8 * 128 * 2      # granite-3-8b's bf16 KV page


@contextlib.contextmanager
def no_host_sync():
    """Raise on any operation that synchronises with the card (the swaps of
    the table, the program and the budgets must copy nothing back)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def quickstart(dev="cuda") -> dict:
    """``examples/quickstart_torch.py`` at its own size on the card."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(device=dev)


def filled_plane(dev):
    """A control plane over 8 memory nodes of 2,048 slots, 75% of them
    filled: a quarter of the slots striped, a quarter hashed, and a quarter
    of each node's homed there (4,096, 4,096 and 8 x 512 pages)."""
    slots = CONTROL["slots"]
    cp = ControlPlane(NODES, slots, NODES * slots, seed=0, device=dev)
    regions = [cp.allocate(NODES * slots // 4, "kv-striped", "striped"),
               cp.allocate(NODES * slots // 4, "kv-hashed", "hashed")]
    affinity = [cp.allocate(slots // 4, f"kv-node{a}", "affinity",
                            affinity=a) for a in range(NODES)]
    return cp, regions, affinity


def control_requests(regions, affinity) -> np.ndarray:
    """i32[8, 256] distinct logical pages: node j asks for 128 pages homed
    on node j + 1 (so node j dominates that home's traffic) and 128 of the
    striped and hashed regions, shuffled."""
    rng = np.random.default_rng(21)
    half = CONTROL["requests"] // 2
    shared = rng.choice(np.concatenate([r.page_ids for r in regions]),
                        NODES * half, replace=False).reshape(NODES, half)
    own = np.stack([rng.choice(affinity[(j + 1) % NODES].page_ids, half,
                               replace=False) for j in range(NODES)])
    want = np.concatenate([own, shared], 1)
    return np.stack([rng.permutation(row) for row in want]).astype(np.int32)


def control_loop(path: str, dev="cuda") -> dict:
    """The closed loop on one path (the 8-node engine, or the loopback path
    over 8 logical nodes): push and pull with the counters on, bit-exact to
    the plain oracles and the counters to the host oracle; fold them and run
    the policies; fail node 3 and carry out the migration and failure plans
    with the gather and scatter kernels; recompile; pull again under the new
    table, program and budgets; fail a ring direction, recompile and pull
    again.  Every datapath call runs under the sync debugger."""
    slots, budget = CONTROL["slots"], CONTROL["budget"]
    cp, regions, affinity = filled_plane(dev)
    cp.topology.pair_table(dev)       # uploaded once, before the swaps
    kw = dict(num_nodes=NODES, budget=budget, topology=cp.topology)
    if path == "loopback":
        kw.update(num_nodes=1, table_nodes=NODES)
    want_np = control_requests(regions, affinity)
    want = torch.from_numpy(want_np).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    pool = torch.randn((NODES * slots,) + CONTROL["page"], generator=gen,
                       device=dev).bfloat16()
    payload = torch.randn(tuple(want.shape) + CONTROL["page"], generator=gen,
                          device=dev).bfloat16()
    table, prog = cp.table(), cp.route_program()
    before = pool.clone()
    with no_host_sync():
        _, push_t = bridge.push_pages(pool, want, payload, table,
                                      program=prog, collect_telemetry=True,
                                      **kw)
        pages, pull_t = bridge.pull_pages(pool, want, table, program=prog,
                                          collect_telemetry=True, **kw)
    if not torch.equal(pool, tref.push_pages_ref(before, want, payload, table,
                                                 slots, prog)):
        raise AssertionError(f"control {path}: push != push_pages_ref")
    del before
    if not (torch.equal(pages, tref.pull_pages_ref(pool, want, table, slots,
                                                   prog))
            and torch.equal(pages, payload)):
        raise AssertionError(f"control {path}: pull != pull_pages_ref")
    table_c, prog_c = MemPortTable(table.home.cpu(), table.slot.cpu()), \
        prog.to("cpu")
    oracle = tref.expected_transfer_telemetry(
        want_np, table_c, prog_c, num_nodes=NODES, budget=budget)
    hold_transfer_counters(f"control {path} push", push_t, oracle)
    hold_transfer_counters(f"control {path} pull", pull_t, oracle)

    # measure -> aggregate -> the policies
    agg = TelemetryAggregator(NODES, page_bytes=CONTROL_PAGE_BYTES)
    agg.update(pull_t)
    for node in range(NODES):
        cp.record_step_time(node, 2.0 if node == 5 else 1.0)
    budgets = cp.rate_limits(budget, telemetry=agg)
    pick = cp.select_channels(budget, CONTROL_PAGE_BYTES, agg, program=prog)
    migration = cp.affinity_migration(agg, min_share=0.5,
                                      limit=CONTROL["migrate"])
    moved_m = plan_rows(migration, slots, dev)
    failure = cp.fail_node(CONTROL["failed"])
    moved_f = plan_rows(failure, slots, dev)
    table2, prog2 = cp.table(), cp.route_program()
    ab = torch.from_numpy(budgets).to(dev)
    swap = dict(active_budget=ab, overprovision=2, **kw)
    with no_host_sync():
        execute_plan(pool, moved_m)
        execute_plan(pool, moved_f)
        pages2, pull2_t = bridge.pull_pages(pool, want, table2, program=prog2,
                                            collect_telemetry=True, **swap)
    if not torch.equal(pages2, payload):
        raise AssertionError(f"control {path}: the pull after the failure "
                             "differs from the contents before it")
    hold_transfer_counters(
        f"control {path} pull after the failure", pull2_t,
        tref.expected_transfer_telemetry(
            want_np, MemPortTable(table2.home.cpu(), table2.slot.cpu()),
            prog2.to("cpu"), num_nodes=NODES, budget=budget,
            active_budget=budgets, overprovision=2))
    cp.report_link_failure(+1)
    prog3 = cp.route_program()
    with no_host_sync():
        pages3 = bridge.pull_pages(pool, want, table2, program=prog3, **swap)
    if not torch.equal(pages3, payload):
        raise AssertionError(f"control {path}: the pull around the failed "
                             "link differs")
    out = dict(pages=int(want.numel()), rate_limits=budgets.tolist(),
               channels_pick=pick, migrated=len(migration),
               rehomed=len(failure),
               offsets_after_link_failure=prog3.offsets.cpu().tolist())
    return out, cp, agg, pool, want, table2


def fit_programs(dev) -> dict:
    """(program, topology) the calibrator is fitted over."""
    bi = steering.bidirectional_program(NODES, device=dev)
    topo = Topology.boards(2, 4)
    return {
        "unidirectional": (steering.unidirectional_program(NODES, device=dev),
                           None),
        "bidirectional": (bi, None),
        "pruned": (steering.pruned_program(bi, [1, 2, 6, 7]), None),
        "hierarchical": (steering.hierarchical_program(topo, device=dev),
                         topo),
    }


def calibrator_fit(cp, agg, pool, want, table, card: str,
                   dev="cuda") -> tuple[dict, dict]:
    """Time 8-node pulls (CUDA events, median of 5 after a warm-up) under
    four programs at budgets 4, 8 and 16, and fit the Calibrator on their
    route features with the measured per-round slot loads.  Returns the fit
    and the pulls each (program, budget) ran."""
    cal = Calibrator()
    samples, calls = [], {}
    programs = fit_programs(dev)
    for name, (prog, topo) in programs.items():
        _, telem = bridge.pull_pages(pool, want, table, num_nodes=NODES,
                                     budget=8, program=prog, topology=topo,
                                     collect_telemetry=True)
        host_t = to_host(telem)
        dist = host_t.slot_served.sum(0).astype(float)
        intra = host_t.slot_intra.sum(0).astype(float)
        for budget in (4, 8, 16):
            rounds = steering.num_rounds(want.shape[1], budget)

            def pull():
                return bridge.pull_pages(pool, want, table, num_nodes=NODES,
                                         budget=budget, program=prog)

            pull()
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                pull()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e3)
            # a warm-up and 5 timed pulls; at budget 8 also the pull that
            # measured the slot loads
            calls[(name, budget)] = 6 + (budget == 8)
            x = route_features(prog, CONTROL_PAGE_BYTES, budget, rounds=rounds,
                               slot_pages=dist / rounds, topology=topo,
                               slot_intra_pages=(None if topo is None
                                                 else intra / rounds))
            us = statistics.median(times)
            cal.observe(x, us)
            samples.append(dict(program=name, budget=budget, rounds=rounds,
                                us=us, us_runs=times, features=x.tolist()))
    for smp in samples:
        smp["residual_us"] = smp["us"] - float(
            cal.theta @ np.asarray(smp["features"]))
    bi = programs["bidirectional"][0]
    fit = dict(card=card, constants=cal.constants(),
               hw=dataclasses.asdict(cal.hw()),
               channels_pick_fitted=cp.select_channels(
                   8, CONTROL_PAGE_BYTES, agg, program=bi, calibrator=cal),
               channels_pick_static=cp.select_channels(
                   8, CONTROL_PAGE_BYTES, agg, program=bi),
               samples=samples)
    print(f"control calibrator fit ({card}):", json.dumps(
        {k: v for k, v in fit.items() if k != "samples"}))
    for smp in samples:
        print(f"control transfer {smp['program']} budget {smp['budget']} "
              f"({smp['rounds']} rounds): {smp['us']:.1f} us median of 5 "
              f"{[round(t, 1) for t in smp['us_runs']]}, residual "
              f"{smp['residual_us']:.1f} us ({card})")
    return fit, calls


def control_launches(quick: dict, plans: dict, calls: dict) -> dict:
    """The launches the control phase's shapes give: the quickstart's two
    loopback pulls and its plan; on each path a push, three pulls (the last
    two at overprovision 2) and its plans (one gather and one scatter
    each); the calibrator's pulls."""
    want = dict.fromkeys(KERNELS, 0)
    rounds = steering.num_rounds(CONTROL["requests"], CONTROL["budget"])
    moved = plans["8-node"] + plans["loopback"] + (quick["moved"] > 0)
    want["gather_pages"] = 2 + (rounds + 2 * 2 * rounds) + 3 + moved
    want["scatter_pages"] = 1 + moved
    want["pull_commit"] = rounds + 2 * 2 * rounds
    want["push_commit"] = rounds
    for (_, budget), n in calls.items():
        r = steering.num_rounds(CONTROL["requests"], budget)
        want["gather_pages"] += n * r
        want["pull_commit"] += n * r
    return want


def control_phase(report: dict, card: str, dev="cuda") -> dict:
    """Phase 8: the quickstart, the closed loop on both paths at full
    width, and the calibrator fit; nothing is built and every launch of the
    bridge kernels is counted against the shapes."""
    t0 = time.perf_counter()
    runs_before = _build.nvcc_runs
    torch.cuda.synchronize()
    reset_launches()
    quick = quickstart(dev)
    loops, plans = {}, {}
    for path in ("8-node", "loopback"):
        out, cp, agg, pool, want, table = control_loop(path, dev)
        loops[path] = out
        plans[path] = (out["migrated"] > 0) + (out["rehomed"] > 0)
        if path == "8-node":
            kept = (cp, agg, pool, want, table)
        else:
            del pool
    fit, calls = calibrator_fit(*kept, card=card, dev=dev)
    del kept
    torch.cuda.synchronize()
    launches = hold_launches(report, "control", read_launches(),
                             control_launches(quick, plans, calls), 1)
    if _build.nvcc_runs != runs_before:
        raise AssertionError("the control phase ran nvcc")
    out = dict(quickstart=quick, loops=loops, launches={
        k: v for k, v in launches.items() if v},
        seconds=time.perf_counter() - t0)
    print("control:", json.dumps(out))
    print(f"control phase: {out['seconds']:.1f} s")
    return dict(out, fit=fit)


# ---------------------------------------------------------------------------
# Phase 9: request-level serving through the launcher's traffic path
# ---------------------------------------------------------------------------

# two tenants (chat, interactive, share 3; crawl, batch, share 1), 8 slots,
# max_len 256, page_tokens 16, the QoS policy: 12 arrival steps at 0.5
# requests a step a tenant give 13 requests (8 chat, 5 crawl) and 133
# decode steps.  Two retired requests are decoded again alone: those of
# the fewest tokens among the requests of at least 3 pages' tokens (each
# flushes 2 pages or more and pulls them for 16 steps or more), both
# tenants among them and one in a slot that an earlier request had left
# (cut from four, 301 solo steps, so that the engines phase fits)
SERVE = dict(batch=8, max_len=256, page_tokens=16, steps=12, rate=0.5,
             seed=0, solo=2, solo_min_pages=3, min_retired=12)
SERVE_PATHS = {"local": ("local", 1), f"{NODES}-node pull": ("bridge_pull",
                                                            NODES)}


def syncs_in(fn) -> int:
    """The host syncs ``fn`` makes, counted from the sync debugger's
    warnings."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def serve_args(cfg, kv: str, num_nodes: int, tmp: str):
    from repro_torch.launch import serve as launch
    return launch.build_parser().parse_args([
        "--arch", cfg.name, "--kv", kv, "--num-nodes", str(num_nodes),
        "--batch", str(SERVE["batch"]), "--max-len", str(SERVE["max_len"]),
        "--page-tokens", str(SERVE["page_tokens"]), "--traffic",
        "--traffic-steps", str(SERVE["steps"]),
        "--traffic-rate", str(SERVE["rate"]),
        "--traffic-seed", str(SERVE["seed"]), "--policy", "qos",
        "--trace-out", f"{tmp}/trace.json",
        "--debug-bundle", f"{tmp}/bundle.zip"])


def check_served(batcher, orc) -> dict:
    """Every submitted request retired or was shed with a reason, both
    tenants retired requests, and every leased page came back."""
    from repro_torch.serve.batcher import SHED_ATTEMPTS, SHED_TERMINAL
    acc = batcher.accounting()
    submitted = sum(acc["submitted"].values())
    done, shed = sum(acc["completed"].values()), sum(acc["shed"].values())
    if batcher.in_flight() or done + shed != submitted:
        raise AssertionError(f"serve: {done} retired + {shed} shed of "
                             f"{submitted} submitted, {batcher.in_flight()} "
                             f"in flight")
    reasons = {r for v in batcher.shed.values() for r in v}
    if not reasons <= {SHED_TERMINAL, SHED_ATTEMPTS}:
        raise AssertionError(f"serve: shed without a reason: {reasons}")
    if done < SERVE["min_retired"] or set(acc["completed"]) != set(orc.specs):
        raise AssertionError(f"serve: retired {acc['completed']}, expected "
                             f">= {SERVE['min_retired']} over both tenants")
    held = {t: orc.held_pages(t) for t in orc.specs}
    if orc.leases or any(held.values()):
        raise AssertionError(f"serve: pages still held after the drain: "
                             f"{held}")
    return dict(submitted=submitted, retired=acc["completed"], shed=shed)


def read_back(tmp: str, retired: int) -> dict:
    """The run's Chrome trace and debug bundle, read back."""
    import zipfile
    from repro_torch.obs import FlightRecorder
    events = json.loads(Path(f"{tmp}/trace.json").read_text())["traceEvents"]
    cats = {}
    for e in events[1:]:
        cats[e["cat"]] = cats.get(e["cat"], 0) + 1
    if cats.get("request") != retired or not cats.get("round") or not (
            cats.get("control")):
        raise AssertionError(f"serve trace: spans by category {cats}, "
                             f"{retired} requests retired")
    with zipfile.ZipFile(f"{tmp}/bundle.zip") as z:
        names = sorted(z.namelist())
        journal = FlightRecorder.from_jsonl(z.read("journal.jsonl").decode())
        json.loads(z.read("trace.json"))
        describe = z.read("describe.txt").decode()
    if names != ["describe.txt", "journal.jsonl", "metrics.txt",
                 "trace.json"] or "orchestrator:" not in describe:
        raise AssertionError(f"serve debug bundle holds {names}")
    return dict(trace_spans=cats, journal_records=len(journal))


def solo_picks(batcher, orc) -> tuple:
    """The retired sequences the solo decode checks: of the requests of at
    least ``solo_min_pages`` pages' tokens, the ``solo`` with the fewest
    tokens in all that hold both tenants and one sequence admitted to a slot
    that an earlier one had left.  Returns them and the ids of the
    sequences in such slots."""
    done = batcher.retired
    reused = {id(s) for s in done
              if any(t.slot == s.slot and t.admit_step < s.admit_step
                     for t in done)}
    long = [s for s in done if s.req.total_tokens
            >= SERVE["solo_min_pages"] * SERVE["page_tokens"]]
    best = None
    for picks in itertools.combinations(long, SERVE["solo"]):
        if ({s.req.tenant_id for s in picks} != set(orc.specs)
                or not any(id(s) in reused for s in picks)):
            continue
        tokens = sum(s.req.total_tokens for s in picks)
        if best is None or tokens < best[0]:
            best = (tokens, list(picks))
    if best is None:
        seen = [(s.req.tenant_id, s.req.total_tokens, s.slot) for s in done]
        raise AssertionError(
            f"serve: no {SERVE['solo']} retired requests of "
            f"{SERVE['solo_min_pages']} pages or more hold both tenants and "
            f"a reused slot (tenant, tokens, slot): {seen}")
    return best[1], reused


def serve_phase(report: dict, cfg, params, dev="cuda") -> dict:
    """Phase 9: full-width granite-3-8b serving request traffic through the
    launcher's ``_traffic_mode`` under each placement, then the fidelity,
    causality, launch and sync checks."""
    import tempfile

    from repro_torch.launch import serve as launch
    from repro_torch.serve.batcher import ModelDecodeEngine, solo_reference
    t0 = time.perf_counter()
    out = {}
    per_slot = -(-SERVE["max_len"] // SERVE["page_tokens"])
    for label, (kv, n) in SERVE_PATHS.items():
        with tempfile.TemporaryDirectory() as tmp:
            args = serve_args(cfg, kv, n, tmp)
            run = launch.make_run(cfg, args)
            want = (dict.fromkeys(KERNELS, 0) if kv == "local" else
                    expected_launches(n, SERVE["batch"], per_slot, 8,
                                      cfg.num_layers))
            sync(dev)
            reset_launches()
            ran = launch._traffic_mode(run, cfg, params, args,
                                       torch.device(dev))
            sync(dev)
            counts = read_launches()
            orc, batcher, engine = ran["orc"], ran["batcher"], ran["engine"]
            res = ran["result"]
            hold_launches(report, f"serve {label}", counts, want,
                          engine.steps)
            entry = dict(check_served(batcher, orc),
                         **read_back(tmp, res["completed"]))
        # fidelity: retired requests decoded alone in the same slot of a
        # fresh engine, bit for bit
        solo = ModelDecodeEngine(run, params, batch=SERVE["batch"],
                                 max_len=SERVE["max_len"],
                                 page_tokens=SERVE["page_tokens"],
                                 num_nodes=n, dtype=torch.bfloat16,
                                 device=dev)
        picked, reused = solo_picks(batcher, orc)
        t_solo = time.perf_counter()
        reset_launches()
        for seq in picked:
            if seq.out != solo_reference(solo, seq.req, slot=seq.slot):
                raise AssertionError(
                    f"serve {label}: request {seq.req.req_id} (tenant "
                    f"{seq.req.tenant_id}, slot {seq.slot}) differs from "
                    f"its solo decode")
            if not orc.flight.why(seq.req.req_id):
                raise AssertionError(f"serve {label}: flight.why("
                                     f"{seq.req.req_id}) is empty")
        sync(dev)
        solo_s = time.perf_counter() - t_solo
        hold_launches(report, f"serve {label} solo", read_launches(), want,
                      solo.steps)
        # the one host sync a step is the emitted tokens; the
        # orchestrator's outputs upload without one
        tokens = np.zeros((SERVE["batch"],), np.int32)
        step_syncs = syncs_in(lambda: solo.step(tokens, [0, 3]))
        backlogs = {1: [[0, 1]], 2: [[2]]}
        orc.route_program()
        out_syncs = syncs_in(lambda: (orc.table(), orc.route_program(),
                                      orc.active_budget(),
                                      orc.compose_requests(backlogs)))
        if step_syncs != 1 or out_syncs:
            raise AssertionError(f"serve {label}: {step_syncs} host syncs in "
                                 f"an engine step (expected 1), {out_syncs} "
                                 f"in the orchestrator's outputs")
        entry.update(
            {k: res[k] for k in ("steps", "decode_steps", "tokens",
                                 "wall_s", "tokens_per_s", "latency_us",
                                 "ttft_us", "latency_steps", "control_us",
                                 "decode_ms", "peak_in_flight")},
            solo_checked=[dict(req=s.req.req_id, tenant=s.req.tenant_id,
                               tokens=s.req.total_tokens, slot=s.slot,
                               reused_slot=id(s) in reused) for s in picked],
            solo_steps=solo.steps, solo_s=solo_s, step_syncs=step_syncs,
            launches_per_step={k: v for k, v in want.items() if v})
        print(f"serve {label}:", json.dumps(entry))
        out[label] = entry
        del ran, orc, batcher, engine, solo
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"serve phase: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the unfused engine through the serve path
# ---------------------------------------------------------------------------

# granite-3-8b at full width on its first ``SHALLOW`` layers: a 24-token
# prompt, then 8 greedy steps; page 0 of every sequence is flushed when its
# 16th token is in and pulled in steps 17-32.  max_len 64: one round of 4
# lanes a node.  The fault runs stop after step 18.
ENGINE_RUN = dict(batch=8, max_len=64, page_tokens=16, prompt=24, steps=32,
                  fault_steps=18)
# the serve-path engines: run.bridge knobs
SERVE_ENGINES = {"fused": {}, "unfused": dict(fused=False),
                 "bufferless": dict(edge_buffer=False)}


@contextlib.contextmanager
def planted_unfused_fault(budget: int = 8):
    """Drop the last live lane of every round of an unfused pull (node-major
    over the round's ``budget`` lanes a node, as :func:`planted_fault`
    drops it from a fused round): a bridge that loses a page."""
    real = bridge.pull_pages

    def lossy(pool, want, table, **kw):
        n, r = want.shape
        rounds = -(-r // budget)
        pad = want.new_full((n, rounds * budget - r), FREE)
        by_round = torch.cat([want, pad], 1).view(n, rounds, budget)
        flat = by_round.transpose(0, 1).reshape(rounds, n * budget)
        lane = torch.arange(n * budget, device=want.device)
        last = torch.where(flat >= 0, lane, -1).amax(1, keepdim=True)
        flat = torch.where(lane == last, FREE, flat)
        want = flat.view(rounds, n, budget).transpose(0, 1).reshape(
            n, rounds * budget)[:, :r]
        return real(pool, want, table, **kw)

    bridge.pull_pages = lossy
    try:
        yield
    finally:
        bridge.pull_pages = real


def engines_phase(report: dict, cfg, params, card: str, dev="cuda") -> dict:
    """Phase 12: bridge_pull and bridge_push on 8 nodes through
    ``make_cache_ops`` under the fused and unfused engines and the
    bufferless bridge at full width on ``SHALLOW`` layers: logits held to local's and
    the fused engine's, the launches to the shapes (none but the
    bufferless pull's folds off the fused engine), a planted lost page
    under ``fused=False`` rejected, and ms a decode step per engine."""
    t0 = time.perf_counter()
    cfg_s, params_s = shallow(cfg, params)
    batch, max_len, page_tokens, steps = (ENGINE_RUN[k] for k in (
        "batch", "max_len", "page_tokens", "steps"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    prompt = torch.randint(0, cfg.vocab_size, (ENGINE_RUN["prompt"], batch),
                           generator=gen, device=dev, dtype=torch.int32)
    shape = (batch, max_len, page_tokens)
    inputs, local_logits, local_ms, _, _ = decode(cfg_s, params_s, "local",
                                                  *shape, steps, prompt,
                                                  dev=dev)
    out = dict(layers=cfg_s.num_layers, local_ms_per_step=statistics.median(
        local_ms[1:]))
    max_pages = -(-max_len // page_tokens)
    for kv in ("bridge_pull", "bridge_push"):
        mode = kv.split("_")[1]
        fused = expected_launches(NODES, batch, max_pages, 8,
                                  cfg_s.num_layers, mode)
        logits = {}
        for ename, knobs in SERVE_ENGINES.items():
            if ename == "fused":
                want = fused
            else:
                # the unfused engine launches no kernel; a bufferless pull
                # still folds its rounds (``fused`` stays True there)
                want = dict.fromkeys(KERNELS, 0)
                if "fused" not in knobs and mode == "pull":
                    want["stream_decode_accumulate"] = fused[
                        "stream_decode_accumulate"]
            sync(dev)
            reset_launches()
            _, got, ms, _, _ = decode(cfg_s, params_s, kv, *shape, steps,
                                      inputs, num_nodes=NODES, engine=knobs,
                                      dev=dev)
            hold_launches(report, f"engines {ename} {mode}", read_launches(),
                          want, steps)
            if not torch.isfinite(got).all():
                raise AssertionError(f"non-finite {ename} {kv} logits")
            logits[ename] = got
            entry = dict(ms_per_step=statistics.median(ms[1:]),
                         first_step_ms=ms[0],
                         worst_logit_rel_diff_vs_local=worst_rel_diff(
                             got, local_logits),
                         worst_logit_rel_diff_vs_fused=worst_rel_diff(
                             got, logits["fused"]),
                         greedy_agreement_vs_fused=float(
                             (got.argmax(-1) == logits["fused"].argmax(-1))
                             .float().mean()))
            for ref_name in ("local", "fused"):
                worst = entry[f"worst_logit_rel_diff_vs_{ref_name}"]
                if worst > FULL_LOGIT_REL_TOL:
                    raise AssertionError(
                        f"{ename} {kv} logits differ from {ref_name}'s by "
                        f"{worst:.3g} of the largest logit")
            out[f"{ename} {mode}"] = entry
        del logits
    fault_steps = ENGINE_RUN["fault_steps"]
    with planted_unfused_fault():
        _, fault_logits, _, _, _ = decode(
            cfg_s, params_s, "bridge_pull", *shape, fault_steps, inputs,
            num_nodes=NODES, engine=SERVE_ENGINES["unfused"], dev=dev)
    fault = worst_rel_diff(fault_logits, local_logits[:fault_steps])
    if not fault > FULL_LOGIT_REL_TOL:
        raise AssertionError(f"a lost page under fused=False moved the "
                             f"logits by only {fault:.3g} of the largest")
    out.update(planted_lost_page_rel_diff=fault,
               seconds=time.perf_counter() - t0)
    print(f"engines ({card}):", json.dumps(out))
    print(f"engines ms a decode step ({card}, {cfg_s.num_layers} layers, "
          f"{NODES} nodes): " + ", ".join(
              f"{k} {v['ms_per_step']:.2f}" for k, v in out.items()
              if isinstance(v, dict)))
    print(f"engines phase: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the dense configs at full width and depth
# ---------------------------------------------------------------------------

# the forward at B 2 x S 1024 (median of 3 after a warm-up); teacher-forced
# local decode over 64 tokens held to the forward; flash at the forward's
# shapes and, where the config has a window, at one batch row of 1,024
# tokens past the window (gemma3-12b: S 2048 against w 1024,
# h2o-danube-3-4b: S 5120 against w 4096), so the window hides keys; a
# 40-token prompt and 16 greedy steps under local, then bridge_pull and
# bridge_push on 8 nodes fed local's tokens (max_len 64: 3 pages a sequence
# flushed and pulled); the fold held to its plain version on the last round
# that bridge_pull pulled; bridge_pull with a lost page over the fault runs'
# 18 steps
DENSE = dict(archs=("gemma3-12b", "h2o-danube-3-4b", "starcoder2-7b"),
             batch=2, seq=1024, repeats=3, check_seq=64, prompt=40,
             steps=56, max_len=64, page_tokens=16)


def bridge_layers(cfg) -> int:
    """Layers whose KV goes through the bridge: sliding-window layers keep
    a local ring under every placement."""
    return sum(kind != SWA_ATTN for kind in cfg.layers)


def check_flash_at(report: dict, path: str, q, k, v, window: int) -> dict:
    """The bf16 flash kernel, causal with ``window``, one launch of the
    wgmma kernel within ``FLASH_TOL`` of its plain version, timed beside
    its bound and one PyTorch call (SDPA; with a mask where the window
    hides keys)."""
    before = fa.flash_attention.launches_by_kernel[fa.WGMMA]
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    if fa.flash_attention.launches_by_kernel[fa.WGMMA] != before + 1:
        raise AssertionError(f"flash_attention ({path}) did not launch the "
                             f"wgmma kernel once")
    want = attention_ref(q, k, v, causal=True, window=window)
    err = float((got.float() - want.float()).abs().max())
    del got, want
    if not err <= FLASH_TOL["bfloat16"]:
        raise AssertionError(f"flash_attention ({path}) differs from its "
                             f"plain version by {err:.3g}")
    b, s, h, hd = q.shape
    keep = visible_mask(s, s, True, window, 0)
    hidden = int((~keep).sum()) - s * (s - 1) // 2
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if hidden:
        mask = keep.to(q.device)
        library = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa: E731
                                enable_gqa=True)
    else:
        library = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa: E731
                               enable_gqa=True)
    entry = record(
        report, "flash_attention", path, err=err,
        ms=cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True,
                                              window=window), iters=20),
        plain_ms=cuda_ms(lambda: attention_ref(q, k, v, causal=True,
                                               window=window),
                         iters=3, warmup=1),
        library_ms=cuda_ms(library, iters=20),
        nbytes=2 * q.numel() * q.element_size()
        + 2 * k.numel() * k.element_size(),
        flops=4 * b * h * hd * int(keep.sum()), flop_rate=BF16_FLOP_PER_S,
        note=f", B {b} S {s} {h}/{k.shape[2]} heads of {hd} window "
             f"{window}")
    entry["pairs_the_window_hides"] = hidden
    return entry


def dense_flash(report: dict, arch: str, cfg, gen, dev) -> dict:
    """Flash at the config's heads: at the forward's shapes, and where the
    config has a window, at a length where the window hides keys."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = cfg.window_size if SWA_ATTN in cfg.layers else 0
    cases = [(DENSE["batch"], DENSE["seq"], f"dense {arch}")]
    if window:
        cases.append((1, window + 1024, f"dense {arch} window"))
    out = {}
    for b, s, path in cases:
        q, k, v = (torch.randn((b, s, heads, hd), generator=gen,
                               device=dev).bfloat16()
                   for heads in (h, kv, kv))
        entry = check_flash_at(report, path, q, k, v, window)
        if path.endswith("window") and not entry["pairs_the_window_hides"]:
            raise AssertionError(f"{path}: the window hides no key")
        out[path] = {key: entry[key] for key in (
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "pairs_the_window_hides")}
        del q, k, v
    return out


@contextlib.contextmanager
def last_fold(kept: list):
    """Keep the operands of the last fold that the decode path calls."""
    real = kvbridge.stream_decode_accumulate

    def keep(*args):
        kept[:] = args
        return real(*args)

    kvbridge.stream_decode_accumulate = keep
    try:
        yield
    finally:
        kvbridge.stream_decode_accumulate = real


def dense_config(report: dict, arch: str, dev="cuda") -> dict:
    cfg = configs.get_config(arch)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen, device=dev)
    sync(dev)
    n_params = sum(p.numel() for p in _leaves(params))
    out = dict(layers=cfg.num_layers, bridge_layers=bridge_layers(cfg),
               params=n_params, init_s=time.perf_counter() - t0)
    gen.manual_seed(2)
    b, s, repeats = DENSE["batch"], DENSE["seq"], DENSE["repeats"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     device=dev, dtype=torch.int32)}
    logits, _ = transformer.forward(cfg, params, batch)       # warm-up
    if (tuple(logits.shape) != (b, s, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} forward logits {list(logits.shape)}")
    del logits
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for _ in range(repeats):
        t1 = time.perf_counter()
        logits, _ = transformer.forward(cfg, params, batch)
        sync(dev)
        times.append((time.perf_counter() - t1) * 1e3)
        del logits
    counts = read_launches()
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = cfg.num_layers * repeats
    if counts != want:
        raise AssertionError(f"{arch} forward launched {counts}, expected "
                             f"{want}")
    count_path(report, f"dense {arch} forward", counts)
    ms = statistics.median(times)
    out.update(forward_ms=ms, forward_times_ms=times,
               prefill_tokens_per_s=b * s / (ms / 1e3),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del batch

    tokens = torch.randint(0, cfg.vocab_size, (b, DENSE["check_seq"]),
                           generator=gen, device=dev, dtype=torch.int32)
    fwd, local, fault = forward_vs_decode(cfg, params, tokens,
                                          torch.bfloat16, dev)
    worst = worst_rel_diff(fwd, local)
    fault_rel = worst_rel_diff(fault, local)
    if not (torch.isfinite(fwd).all() and torch.isfinite(local).all()):
        raise AssertionError(f"{arch}: non-finite logits in the forward check")
    if worst > FORWARD_LOGIT_REL_TOL:
        raise AssertionError(f"{arch} forward logits differ from local decode "
                             f"by {worst:.3g} of the largest logit")
    if not fault_rel > FORWARD_LOGIT_REL_TOL:
        raise AssertionError(f"{arch} planted mask fault moved the forward's "
                             f"logits by only {fault_rel:.3g}")
    out.update(forward_vs_decode_rel_diff=worst,
               planted_mask_fault_rel_diff=fault_rel)
    del fwd, local, fault
    out["flash"] = dense_flash(report, arch, cfg, gen, dev)

    prompt = torch.randint(0, cfg.vocab_size, (DENSE["prompt"], b),
                           generator=gen, device=dev, dtype=torch.int32)
    shape = (b, DENSE["max_len"], DENSE["page_tokens"])
    steps = DENSE["steps"]
    inputs, local_logits, local_ms, _, _ = decode(cfg, params, "local",
                                                  *shape, steps, prompt,
                                                  dev=dev)
    if not torch.isfinite(local_logits).all():
        raise AssertionError(f"{arch}: non-finite local decode logits")
    out["ms_per_step"] = {"local": statistics.median(local_ms[1:])}
    fold = []
    for kv in ("bridge_pull", "bridge_push"):
        reset_launches()
        with (last_fold(fold) if kv == "bridge_pull"
              else contextlib.nullcontext()):
            _, logits, step_ms, _, _ = decode(cfg, params, kv, *shape, steps,
                                              inputs, num_nodes=NODES,
                                              dev=dev)
        sync(dev)
        want = expected_launches(NODES, b, shape[1] // shape[2], 8,
                                 bridge_layers(cfg), mode=kv.split("_")[1])
        hold_launches(report, f"dense {arch} {kv}", read_launches(), want,
                      steps)
        worst = worst_rel_diff(logits, local_logits)
        if not torch.isfinite(logits).all() or worst > FULL_LOGIT_REL_TOL:
            raise AssertionError(f"{arch} {kv} logits differ from local by "
                                 f"{worst:.3g} of the largest logit")
        if not bridge_layers(cfg) and not torch.equal(logits, local_logits):
            raise AssertionError(f"{arch} {kv}: no layer reaches the bridge, "
                                 f"yet the logits differ from local's")
        out["ms_per_step"][kv] = statistics.median(step_ms[1:])
        out[f"{kv}_rel_diff"] = worst
        out[f"{kv}_greedy_agreement"] = float(
            (logits.argmax(-1) == local_logits.argmax(-1)).float().mean())
        out[f"{kv}_launches_per_step"] = {k: v for k, v in want.items() if v}
        del logits
    if bridge_layers(cfg):
        # the fold at this config's heads, on the operands of the last
        # round bridge_pull pulled (its last layer at its last step)
        q, kp, vp, seq, lv, m, l, o = fold
        if not int(lv.sum()):
            raise AssertionError(f"{arch}: the last pulled round has no "
                                 f"live lane")
        check_stream(report, f"dense {arch}", *fold, [])
        entry = report["stream_decode_accumulate"]["by_path"][
            f"dense {arch}"]
        out["fold"] = {key: entry[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms")}
        out["fold"]["shape"] = dict(lanes=kp.shape[0], live=int(lv.sum()),
                                    heads=q.shape[1], kv=kp.shape[2],
                                    head_dim=q.shape[2])
        del q, kp, vp, seq, lv, m, l, o
        # a bridge that loses a page must break the placements' limit
        with planted_fault():
            _, fault_logits, _, _, _ = decode(
                cfg, params, "bridge_pull", *shape, FULL["fault_steps"],
                inputs, num_nodes=NODES, dev=dev)
        fault_rel = worst_rel_diff(fault_logits,
                                   local_logits[:FULL["fault_steps"]])
        if not fault_rel > FULL_LOGIT_REL_TOL:
            raise AssertionError(f"{arch} planted lost page moved the "
                                 f"bridge_pull logits by only "
                                 f"{fault_rel:.3g} of the largest")
        out["planted_lost_page_rel_diff"] = fault_rel
        del fault_logits
    del fold
    out["seconds"] = time.perf_counter() - t0
    del params, local_logits
    torch.cuda.empty_cache()
    print(f"dense {arch}:", json.dumps(out))
    return out


def dense_phase(report: dict, dev="cuda") -> dict:
    """Phase 10: each dense config at full width and depth in bf16, one at
    a time, each freed before the next."""
    t0 = time.perf_counter()
    out = {arch: dense_config(report, arch, dev) for arch in DENSE["archs"]}
    out["seconds"] = time.perf_counter() - t0
    print(f"dense phase: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 11: training
# ---------------------------------------------------------------------------

# granite-3-8b at full width, cut to 4 of its 40 layers (one card holds the
# bf16 weights and float32 moments of 40 layers in 96 GB); the moments'
# trip through the pool takes the first layer and the embedding (the
# checkpoint it writes and reads back is 3.2 GB of float32 moments).
TRAIN = dict(layers=4, batch=4, seq=1024, steps=5, pool_layers=1,
             pool_nodes=4, page_elems=16_384, failed_node=2)
# The backward against its plain version: float32 as an absolute limit (the
# kernel's float32 sums differ from the plain version's in order only),
# bf16 over the largest gradient (p and ds are rounded to bf16 where the
# plain version rounds them, the sums in another order).
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# cases beside the training shape, in bf16 and float32: (B, Sq, Sk, H, kv,
# hd, causal, window, q_offset); the third leaves its first 40 rows no key
# to see.
FLASH_BWD_CASES = [
    (1, 300, 300, 32, 8, 128, True, 100, 0),
    (1, 128, 384, 32, 8, 128, True, 0, 256),
    (1, 64, 64, 4, 2, 64, True, 16, -40),
    (1, 256, 256, 4, 1, 64, True, 0, 0),
    (1, 256, 256, 4, 1, 256, True, 0, 0),
    (1, 200, 260, 32, 8, 120, True, 0, 60),    # h2o-danube's head dim
    (1, 192, 192, 8, 8, 128, True, 0, -30),    # g 1, rows that see no key
    (1, 100, 100, 36, 4, 128, True, 0, 0),     # starcoder2's g 9: padding
    (1, 130, 70, 8, 2, 64, False, 0, 0),       # bidirectional, ragged
    (1, 160, 160, 8, 4, 192, True, 0, 0),      # hd 192: blocks split 2 / 1
    (1, 200, 260, 8, 2, 136, True, 0, 60),     # hd 136 padded to 192
    (1, 192, 192, 16, 8, 256, True, 0, -30),   # gemma3's heads, dead rows
]
# the report row of each backward kernel
BWD_ROWS = {k["variant"]: name for name, k in KERNELS.items()
            if k["fns"] == (fa.flash_attention_bwd,)}
# the floor of each backward kernel's design, in products over the visible
# pairs (the backward needs five): s and dp computed in both passes, and in
# the bf16 split-hd kernel once more in its second dk/dv warpgroup (the
# float32 one's warps share the halves of s and dp through shared memory)
BWD_DESIGN_PRODUCTS = {fa.BWD_WGMMA: 7, fa.BWD_TF32X3: 7,
                       fa.BWD_WGMMA256: 9, fa.BWD_TF32X3_256: 7}
# gemma3-12b at full width, cut to 1 of its 48 layers (a sliding-window
# layer, whose 1,024-token window hides no key at S 1024): its heads of 256
# take the split-hd wgmma backward in bf16.
TRAIN_GEMMA3 = dict(layers=1, batch=2, seq=1024, steps=2)
# the reduced float32 step on the card against the same step on the CPU
TRAIN_REDUCED_TOL = dict(rtol=1e-4, atol=1e-4)


def bwd_inputs(gen, dtype, b, sq, sk, h, kv, hd, dev="cuda"):
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd),
                          (b, sq, h, hd))]


def bwd_error(got, want) -> float:
    """The backward's error by its limit's measure: the largest absolute
    difference of dq, dk and dv, over the largest gradient in bf16."""
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    if got[0].dtype == torch.bfloat16:
        err /= max(float(w.float().abs().max()) for w in want)
    return err


def check_bwd_case(q, k, v, do, **kw) -> dict:
    """One backward call against its plain version on the same inputs:
    one launch of the kernel the (dtype, hd) table names, within its limit,
    bit-identical on a second call, zero gradients for rows that see no
    key; and with a planted fault the limit must break: q_offset shifted by
    one (every query also sees the next key), or, where q_offset moves no
    mask (bidirectional, no window), the causal mask."""
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    kernel = fa.bwd_variant(q.dtype, q.shape[-1]).kernel
    before = (fa.flash_attention_bwd.launches,
              fa.flash_attention_bwd.launches_by_kernel[kernel])
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    if (fa.flash_attention_bwd.launches,
            fa.flash_attention_bwd.launches_by_kernel[kernel]) != (
                before[0] + 2, before[1] + 2):
        raise AssertionError(f"flash_attention_bwd: not one launch of "
                             f"{kernel} a call")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd {list(q.shape)} {kw}: two "
                             f"calls differ")
    want = flash_bwd_ref(q, k, v, o, do, lse, **kw)
    err = bwd_error(got, want)
    tol = BWD_TOL[q.dtype]
    if not err <= tol:
        raise AssertionError(f"flash_attention_bwd {list(q.shape)} {kw} "
                             f"{q.dtype} differs from its plain version by "
                             f"{err:.3g} (limit {tol})")
    sq, sk = q.shape[1], k.shape[1]
    dead = ~visible_mask(sq, sk, kw.get("causal", True), kw.get("window", 0),
                         kw.get("q_offset", 0)).any(1)
    if got[0][:, dead.to(q.device)].any():
        raise AssertionError("flash_attention_bwd: a row that sees no key "
                             "has a nonzero dq")
    if kw.get("causal", True) or kw.get("window", 0) > 0:
        shifted = dict(kw, q_offset=kw.get("q_offset", 0) + 1)
    else:
        shifted = dict(kw, causal=True)
    fault = bwd_error(fa.flash_attention_bwd(q, k, v, o, do, lse, **shifted),
                      want)
    if fault <= tol:
        raise AssertionError(f"flash_attention_bwd with {shifted} moved the "
                             f"gradients by only {fault:.3g}: the check would "
                             f"pass it")
    return dict(err=err, planted_fault=fault, dead_rows=int(dead.sum()),
                o=o, lse=lse, want=want)


def check_flash_bwd(report: dict, gen, dev="cuda") -> dict:
    """The backward kernels at the training shapes (B 4 x S 1024, causal):
    bf16 (the wgmma kernel) and float32 (the three-term TF32 kernel) at
    granite-3-8b's 32/8 heads of 128, bf16 (the split-hd wgmma kernel) and
    float32 (the split-hd TF32 kernel) at gemma3-12b's 16/8 heads of 256,
    each timed in turns with the library's backward (``torch.autograd.grad``
    through ``scaled_dot_product_attention``, shown for comparison; five
    rounds, medians), beside its bound (the backward's five products over
    the visible pairs, 2.5 times the forward's operations, at the bf16
    tensor cores' peak; float32 as three TF32 products at the TF32 peak, and
    as one float32 product on the CUDA cores), the floor of the kernel's
    design (``BWD_DESIGN_PRODUCTS``: seven products, s and dp computed in
    both passes; nine for the bf16 split-hd kernel), its plain version and its
    device time by kernel; then both dtypes at the mask and head-size
    cases, each held to the kernel the (dtype, hd) table names."""
    b, s = TRAIN["batch"], TRAIN["seq"]
    pairs = int(visible_mask(s, s, True, 0, 0).sum())
    out = {}
    for dtype, path, (h, kv, hd), rate, products, iters in (
            (torch.bfloat16, "train bf16", (32, 8, 128), BF16_FLOP_PER_S, 1,
             50),
            (torch.float32, "train f32", (32, 8, 128), TF32_FLOP_PER_S, 3,
             10),
            (torch.bfloat16, "gemma3 bf16", (16, 8, 256), BF16_FLOP_PER_S,
             1, 50),
            (torch.float32, "gemma3 f32", (16, 8, 256), TF32_FLOP_PER_S, 3,
             10)):
        kernel = fa.bwd_variant(dtype, hd).kernel
        name = BWD_ROWS[kernel]
        kernels = fa.BWD_KERNELS[kernel]
        q, k, v, do = bwd_inputs(gen, dtype, b, s, s, h, kv, hd, dev)
        res = check_bwd_case(q, k, v, do)
        o, lse = res["o"], res["lse"]

        def call():
            return fa.flash_attention_bwd(q, k, v, o, do, lse)

        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        ot = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(ot, (qt, kt, vt), dot,
                                       retain_graph=True)

        turns = {}
        in_turns(turns, f"{name} [{path}]", call, library, iters=iters)
        by_kernel = {kn: device_us(call, kn, calls=5) for kn in kernels}
        flops = 10 * b * h * hd * pairs
        entry = record(
            report, name, path, err=res["err"], ms=turns["ms"],
            plain_ms=cuda_ms(lambda: flash_bwd_ref(q, k, v, o, do, lse),
                             iters=3, warmup=1),
            library_ms=turns["library_ms"],
            nbytes=4 * q.nbytes + 4 * k.nbytes + lse.nbytes,
            flops=products * flops, flop_rate=rate,
            note=f", B {b} S {s} {h}/{kv} heads of {hd} causal "
                 f"{str(dtype)[6:]}",
            dev_us=sum(by_kernel.values()))
        design = BWD_DESIGN_PRODUCTS[kernel]
        entry.update(turns, planted_fault=res["planted_fault"],
                     device_us_by_kernel=by_kernel, floor_products=design,
                     floor_ms=design / 5 * entry["bound_ms"])
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        entry["floor_share"] = entry["floor_ms"] / entry["ms"]
        cores = ""
        if dtype == torch.float32:
            entry["bound_ms_cuda_cores"] = flops / F32_FLOP_PER_S * 1e3
            cores = (f", {entry['bound_ms_cuda_cores'] / entry['ms']:.4f} of "
                     f"one float32 product on the CUDA cores "
                     f"{entry['bound_ms_cuda_cores']:.6f} ms")
        print(f"kernel {name} [{path}]: device us by kernel "
              f"{json.dumps({kn: round(us, 2) for kn, us in by_kernel.items()})}"
              f"; {entry['bound_share']:.4f} of the five-product bound "
              f"{entry['bound_ms']:.6f} ms, {entry['floor_share']:.4f} of the "
              f"{design}-product floor {entry['floor_ms']:.6f} ms{cores}")
        out[path] = entry
        del q, k, v, do, o, lse, res, qt, kt, vt, ot, dot
    faults = [e["planted_fault"] for e in out.values()]
    worst = dict.fromkeys(BWD_ROWS.values(), 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        dead = 0
        for case in FLASH_BWD_CASES:
            b_, sq, sk, h_, kv_, hd_, causal, window, q_offset = case
            q, k, v, do = bwd_inputs(gen, dtype, b_, sq, sk, h_, kv_, hd_,
                                     dev)
            res = check_bwd_case(q, k, v, do, causal=causal, window=window,
                                 q_offset=q_offset)
            name = BWD_ROWS[fa.bwd_variant(dtype, hd_).kernel]
            worst[name] = max(worst[name], res["err"])
            dead += res["dead_rows"]
            faults.append(res["planted_fault"])
        if not dead:
            raise AssertionError("no backward case has a row that sees no "
                                 "key")
    for name, err in worst.items():
        report[name]["max_abs_err_cases"] = err
    print(f"kernel flash_attention_bwd: {len(FLASH_BWD_CASES)} cases in bf16 "
          f"and float32 (window 100, q_offset 256 / 60 / -30 / -40, rows "
          f"that see no key, hd 64, 120, 128, 136, 192 and 256, g 1 to 9, "
          f"bidirectional) within {BWD_TOL[torch.bfloat16]} (bf16, of the "
          f"largest gradient) and {BWD_TOL[torch.float32]} (float32): worst "
          f"by kernel {json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}")
    print(f"kernel flash_attention_bwd: bf16 and float32 bit-identical "
          f"between calls; the planted faults (q_offset shifted by one, the "
          f"causal mask on the bidirectional case) break every limit "
          f"(smallest {min(faults):.3g})")
    return out


def flash_lse_times(report: dict, gen, dev="cuda") -> dict:
    """Rows 7a and 7b at the sequence forward's shapes (B 8 x S 1024, 32/8
    heads of 128, causal): device time and wrapper time with the lse not
    asked for and asked for, in turns; the output the same bits."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        row, path, kernel, _, _ = FLASH_ROWS[dtype]
        q, k, v, _ = bwd_inputs(gen, dtype, 8, 1024, 1024, 32, 8, 128, dev)
        if not torch.equal(fa.flash_attention(q, k, v),
                           fa.flash_attention(q, k, v, return_lse=True)[0]):
            raise AssertionError(f"{row}: asking for the lse changed the "
                                 f"output")
        iters = 100 if dtype == torch.bfloat16 else 20
        t = dict(off_device_us=[], on_device_us=[], off_ms=[], on_ms=[])
        for _ in range(2):
            t["off_device_us"].append(device_us(
                lambda: fa.flash_attention(q, k, v), kernel, calls=10))
            t["on_device_us"].append(device_us(
                lambda: fa.flash_attention(q, k, v, return_lse=True), kernel,
                calls=10))
            t["off_ms"].append(cuda_ms(lambda: fa.flash_attention(q, k, v),
                                       iters=iters))
            t["on_ms"].append(cuda_ms(
                lambda: fa.flash_attention(q, k, v, return_lse=True),
                iters=iters))
        entry = {key: min(vals) for key, vals in t.items()}
        report[row]["by_path"][path]["lse"] = entry
        out[row] = entry
        print(f"kernel {row} [lse off / on, B 8 S 1024]: device "
              f"{entry['off_device_us']:.2f} / {entry['on_device_us']:.2f} "
              f"us, wrapper {entry['off_ms']:.4f} / {entry['on_ms']:.4f} ms")
        del q, k, v
    return out


def hold_train_launches(report: dict, path: str, counts: dict,
                        want: dict) -> None:
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")
    count_path(report, path, counts)


def split_step(run, state, batch) -> dict:
    """One more training step taken apart: CUDA events around the forward
    (with the loss), the backward (the remat recompute included) and the
    optimizer, and the profiler's device time of each flash kernel."""
    from torch.profiler import ProfilerActivity, profile
    cfg = run.model
    flat, treedef = tree.flatten(state.params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev[0].record()
        leaves = [p.detach().requires_grad_() for p in flat]
        loss, _ = transformer.loss_fn(cfg, tree.unflatten(treedef, leaves),
                                      batch, run.remat)
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        adamw.adamw_update(run.optim, tree.unflatten(treedef, list(grads)),
                           state.opt, state.params)
        ev[3].record()
        ev[3].synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = device_events(prof)
    device = sum(us for _, us in kernels) / 1e3
    flash = {key: sum(us for name, us in kernels if key in name) / 1e3
             for key in (fa.WGMMA, *fa.BWD_KERNELS[fa.BWD_WGMMA])}
    return dict(forward_ms=ev[0].elapsed_time(ev[1]),
                backward_ms=ev[1].elapsed_time(ev[2]),
                optimizer_ms=ev[2].elapsed_time(ev[3]), wall_ms=wall,
                device_ms=device, device_busy_share=device / wall,
                kernel_launches=len(kernels), flash_device_ms=flash)


def timed_steps(step_fn, state, batch, steps: int):
    """``steps`` training steps on one batch, each timed on the host clock
    between synchronizes -> (state, ms of each, loss of each)."""
    times, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    return state, times, losses


def train_full(report: dict, dev="cuda"):
    """granite-3-8b at full width, 4 layers, bf16, weights from seed 0,
    ``remat="block"``: a warm-up step and 5 timed ones on one repeated
    batch of the port's ``SyntheticLM`` (B 4 x S 1024); each layer a step
    launches the forward kernel twice (the forward and the backward's remat
    recompute) and the backward kernel once."""
    layers, b, s, steps = (TRAIN[k] for k in ("layers", "batch", "seq",
                                              "steps"))
    cfg = dataclasses.replace(configs.get_config("granite-3-8b"),
                              num_layers=layers)
    run = RunConfig(model=cfg, shape=ShapeConfig("train", s, b, "train"),
                    optim=OptimConfig(warmup_steps=1), remat="block")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = train_step.make_train_state(run, gen, device=dev)
    n_params = sum(x.numel() for x in tree.leaves(state.params))
    batch = to_device(SyntheticLM(cfg, b, s, seed=0).batch_at(0), dev)
    step_fn = train_step.build_train_step(run)
    t0 = time.perf_counter()
    state, first = step_fn(state, batch)
    first_loss = float(first["loss"])
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, times, losses = timed_steps(step_fn, state, batch, steps)
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_attention=2 * layers * steps,
                flash_attention_bwd=layers * steps)
    hold_train_launches(report, "train", read_launches(), want)
    with torch.no_grad():
        final, _ = transformer.loss_fn(cfg, state.params, batch)
    final_loss = float(final)
    if not all(np.isfinite(losses)) or not final_loss < first_loss:
        raise AssertionError(f"train: the loss on a repeated batch went from "
                             f"{first_loss} to {losses} then {final_loss}")
    if not all(torch.isfinite(x).all() for x in tree.leaves(state.params)):
        raise AssertionError("train: non-finite parameters")
    ms = statistics.median(times)
    out = dict(layers=layers, params=n_params, batch=b, seq=s,
               first_loss=first_loss, losses=losses, final_loss=final_loss,
               warmup_step_s=warm_s, step_ms=times, ms_per_step=ms,
               tokens_per_s=b * s / (ms / 1e3), peak_gb=peak,
               flash_launches_per_layer_step=dict(forward=2, backward=1),
               split=split_step(run, state, batch))
    print("train:", json.dumps(out))
    return run, state, batch, out


def train_reduced_f32(report: dict, dev="cuda", arch: str = "granite-3-8b",
                      path: str = "train reduced f32",
                      row: str = "flash_attention_bwd_f32",
                      adamw_slack: bool = False, **overrides) -> dict:
    """One step of reduced ``arch`` in float32 on the card (the float32
    flash kernels, forward and backward; the backward's launches counted
    under ``row``) against the same step on the CPU (the plain versions)
    from the same state: loss, grad norm, parameters, m and v within 1e-4.
    AdamW's first step moves a parameter by lr (g / (|g| + eps) + wd p),
    g = m / (1 - b1) the clipped gradient, so where |g| is near eps a
    difference dg between the card's and the CPU's gradient (their float32
    sums in another order) moves it by up to lr eps |dg| / (|g| + eps)^2,
    lr |dg| / eps where the two signs differ.  With ``adamw_slack`` each
    parameter's limit is 1e-4 plus that; without, 1e-4 alone.  The
    parameter that moved most against its limit is printed with both
    gradients.  ``overrides`` replace fields of the reduced config."""
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32",
                              **overrides)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 64, 4, "train"),
                    optim=OptimConfig(lr=3e-3, warmup_steps=1))
    gen = torch.Generator()
    gen.manual_seed(0)
    cpu_state = train_step.make_train_state(run, gen, device="cpu")
    card_state = tree.tree_map(lambda x: x.to(dev), cpu_state)
    data = SyntheticLM(cfg, 4, 64, seed=0).batch_at(0)
    step_fn = train_step.build_train_step(run)
    cpu_state, cpu_m = step_fn(cpu_state, to_device(data, "cpu"))
    reset_launches()
    card_state, card_m = step_fn(card_state, to_device(data, dev))
    # the forward and the backward's remat recompute, then the backward
    want = dict.fromkeys(KERNELS, 0)
    want.update({"flash_attention_f32": 2 * cfg.num_layers,
                 row: cfg.num_layers})
    counts = read_launches()
    if fa.flash_attention.launches != 2 * cfg.num_layers:
        raise AssertionError(f"{path}: {fa.flash_attention.launches} "
                             f"forward launches, expected "
                             f"{2 * cfg.num_layers}")
    hold_train_launches(report, path, counts, want)
    errs = {}
    for key in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(card_m[key].cpu(), cpu_m[key],
                                   **TRAIN_REDUCED_TOL)
        errs[key] = float((card_m[key].cpu() - cpu_m[key]).abs())
    for name in ("m", "v"):
        errs[name] = 0.0
        for x, y in zip(tree.leaves(getattr(card_state.opt, name)),
                        tree.leaves(getattr(cpu_state.opt, name))):
            torch.testing.assert_close(x.cpu(), y, **TRAIN_REDUCED_TOL)
            errs[name] = max(errs[name], float((x.cpu() - y).abs().max()))
    lr, eps = float(cpu_m["lr"]), run.optim.eps
    errs["params"], worst = 0.0, None
    for (leaf, x), y, mx, my in zip(
            tree.leaves_with_path(card_state.params),
            tree.leaves(cpu_state.params), tree.leaves(card_state.opt.m),
            tree.leaves(cpu_state.opt.m)):
        d = (x.cpu() - y).abs()
        limit = (TRAIN_REDUCED_TOL["atol"]
                 + TRAIN_REDUCED_TOL["rtol"] * y.abs())
        gx, gy = mx.cpu() / (1 - run.optim.b1), my / (1 - run.optim.b1)
        if adamw_slack:
            g_lo = torch.where(gx * gy > 0,
                               torch.minimum(gx.abs(), gy.abs()), 0.0)
            limit = limit + lr * eps * (gx - gy).abs() / (g_lo + eps) ** 2
        if not bool((d <= limit).all()):
            raise AssertionError(f"{path}: parameter {leaf} moved past its "
                                 f"limit: {float(d.max())}")
        i = int(torch.argmax(d / limit))
        share = float(d.flatten()[i] / limit.flatten()[i])
        errs["params"] = max(errs["params"], float(d.max()))
        if worst is None or share > worst["share_of_limit"]:
            at = [int(j) for j in np.unravel_index(i, tuple(d.shape))]
            worst = dict(leaf=leaf, at=at, share_of_limit=share,
                         moved=float(d.flatten()[i]),
                         limit=float(limit.flatten()[i]),
                         grad_card=float(gx.flatten()[i]),
                         grad_cpu=float(gy.flatten()[i]))
    print(f"{path}: the parameter that moved most against its limit "
          f"(lr {lr}, eps {eps}): {json.dumps(worst)}")
    print(f"{path}: one step on the card == on the CPU within "
          f"{TRAIN_REDUCED_TOL}"
          f"{' plus AdamW slack' if adamw_slack else ''}: {errs}")
    return dict(errs, worst_param=worst)


def train_gemma3(report: dict, dev="cuda") -> dict:
    """gemma3-12b at full width, 1 layer, bf16, weights from seed 0,
    ``remat="block"``: a warm-up step and 2 more on one repeated batch of
    ``SyntheticLM`` (B 2 x S 1024); its heads of 256 send the backward to
    the split-hd wgmma kernel (one launch a layer a step, two of the
    forward)."""
    layers, b, s, steps = (TRAIN_GEMMA3[k] for k in ("layers", "batch",
                                                     "seq", "steps"))
    cfg = dataclasses.replace(configs.get_config("gemma3-12b"),
                              num_layers=layers)
    run = RunConfig(model=cfg, shape=ShapeConfig("train", s, b, "train"),
                    optim=OptimConfig(warmup_steps=1), remat="block")
    if fa.bwd_variant(torch.bfloat16, cfg.head_dim).kernel != fa.BWD_WGMMA256:
        raise AssertionError("train gemma3: its heads no longer take the "
                             "split-hd wgmma backward")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = train_step.make_train_state(run, gen, device=dev)
    batch = to_device(SyntheticLM(cfg, b, s, seed=0).batch_at(0), dev)
    step_fn = train_step.build_train_step(run)
    state, first = step_fn(state, batch)
    first_loss = float(first["loss"])
    reset_launches()
    state, times, losses = timed_steps(step_fn, state, batch, steps)
    want = dict.fromkeys(KERNELS, 0)
    want.update(flash_attention=2 * layers * steps,
                flash_attention_bwd_wgmma256=layers * steps)
    hold_train_launches(report, "train gemma3 bf16", read_launches(), want)
    if not all(np.isfinite(losses)) or not losses[-1] < first_loss:
        raise AssertionError(f"train gemma3: the loss on a repeated batch "
                             f"went from {first_loss} to {losses}")
    out = dict(layers=layers, batch=b, seq=s, first_loss=first_loss,
               losses=losses, step_ms=times,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del state, batch
    torch.cuda.empty_cache()
    print("train gemma3:", json.dumps(out))
    return out


def train_pool(report: dict, run, state, batch, dev="cuda") -> dict:
    """The AdamW moments of the first layer (and the embedding) through
    the pool: m and v each in a ``zero_bridge`` store over 4 logical memory
    nodes (the loopback path, pages of 16,384 float32), on one control
    plane with room for a failed node's pages on the survivors.  A step
    that pulls them, updates and pushes them back gives parameters, m and
    v bit-identical to the step that keeps them locally; a checkpoint of
    the moments is saved, node 2 fails, ``rehome_after_failure`` restores
    both stores from the checkpoint image, and the next pulls return it bit
    for bit with no page homed on node 2.  Each pull launches one gather
    and each push one scatter."""
    layers, nodes, page = (TRAIN[k] for k in ("pool_layers", "pool_nodes",
                                              "page_elems"))
    failed = TRAIN["failed_node"]
    cfg = dataclasses.replace(run.model, num_layers=layers)

    def first(t):
        return dict(t, layers=t["layers"][:layers])

    def copy(t):
        return tree.tree_map(torch.clone, t)

    def same(a, b) -> bool:
        return all(torch.equal(x, y)
                   for x, y in zip(tree.leaves(a), tree.leaves(b)))

    t_start = time.perf_counter()
    params, m, v = (first(t) for t in (state.params, state.opt.m,
                                       state.opt.v))
    flat, treedef = tree.flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    loss, _ = transformer.loss_fn(cfg, tree.unflatten(treedef, leaves), batch)
    grads = tree.unflatten(treedef, list(torch.autograd.grad(loss, leaves)))
    del leaves, loss
    n_pages = zero_bridge.TreePacker.plan(m, page).num_pages
    ppn = -(-2 * n_pages // (nodes - 1))
    cp = ControlPlane(nodes, ppn, 2 * n_pages)
    reset_launches()
    t0 = time.perf_counter()
    m_store = zero_bridge.create_store(m, page_elems=page, cp=cp)
    v_store = zero_bridge.create_store(v, page_elems=page, cp=cp)
    sync(dev)
    create_s = time.perf_counter() - t0
    count = state.opt.count.clone()
    p_local, m_local, v_local = copy(params), copy(m), copy(v)
    adamw.adamw_update(run.optim, grads, adamw.AdamWState(m_local, v_local,
                                                          count), p_local)
    p_pool = copy(params)
    t0 = time.perf_counter()
    m_pulled = zero_bridge.pull_tree(m_store)
    v_pulled = zero_bridge.pull_tree(v_store)
    adamw.adamw_update(run.optim, grads, adamw.AdamWState(m_pulled, v_pulled,
                                                          count), p_pool)
    m_store = zero_bridge.push_tree(m_store, m_pulled)
    v_store = zero_bridge.push_tree(v_store, v_pulled)
    sync(dev)
    step_s = time.perf_counter() - t0
    del m_pulled, v_pulled
    if not (same(p_pool, p_local) and same(zero_bridge.pull_tree(m_store),
                                           m_local)
            and same(zero_bridge.pull_tree(v_store), v_local)):
        raise AssertionError("train pool: the step through the pool differs "
                             "from the local step")
    del p_pool, grads
    ckpt_dir = ROOT / "build" / "smoke_checkpoint"
    t0 = time.perf_counter()
    try:
        # float32 moments hardly compress: level 0 stores them
        ckpt = CheckpointManager(str(ckpt_dir), keep=1, compression_level=0)
        image = {"m": m_local, "v": v_local}
        ckpt.save(1, image, extra={"step": 1})
        restored, _ = ckpt.restore(image)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_s = time.perf_counter() - t0
    home_before = np.bincount(cp.table().home.cpu().numpy()[:n_pages],
                              minlength=nodes)
    m_store = zero_bridge.rehome_after_failure(m_store, cp, failed,
                                               restored["m"])
    v_store = zero_bridge.rehome_after_failure(v_store, cp, failed,
                                               restored["v"])
    homes = cp.table().home
    if bool((homes == failed).any()):
        raise AssertionError(f"train pool: pages still homed on node "
                             f"{failed}")
    if not (same(zero_bridge.pull_tree(m_store), m_local)
            and same(zero_bridge.pull_tree(v_store), v_local)):
        raise AssertionError("train pool: a pull after the re-homing differs "
                             "from the checkpoint image")
    counts = read_launches()
    want = dict.fromkeys(KERNELS, 0)
    want.update(gather_pages=6, scatter_pages=6)   # 6 pulls, 6 pushes
    hold_train_launches(report, "train pool", counts, want)
    out = dict(layers=layers, pages_per_tree=n_pages, pages_per_node=ppn,
               pool_gb=2 * m_store.pool.nbytes / 1e9,
               pages_on_node_before=home_before.tolist(),
               pages_on_node_after=np.bincount(
                   homes.cpu().numpy()[:n_pages], minlength=nodes).tolist(),
               create_s=create_s, pool_step_s=step_s, checkpoint_s=ckpt_s,
               seconds=time.perf_counter() - t_start,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("train pool:", json.dumps(out))
    return out


def train_phase(report: dict, dev="cuda") -> dict:
    """Phase 11: the backward kernels, training at full width, the float32
    step against the CPU, the moments through the pool, one gemma3-12b
    layer's training steps."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    out = dict(bwd=check_flash_bwd(report, gen, dev),
               lse=flash_lse_times(report, gen, dev))
    torch.cuda.empty_cache()
    run, state, batch, out["full"] = train_full(report, dev)
    out["pool"] = train_pool(report, run, state, batch, dev)
    del state, batch
    torch.cuda.empty_cache()
    out["reduced_f32"] = train_reduced_f32(report, dev)
    # reduced gemma3-12b at its own heads of 256: float32 above hd 128
    # takes the split-hd TF32 backward; some of its gradients lie under
    # AdamW's eps
    out["reduced_f32_gemma3"] = train_reduced_f32(
        report, dev, "gemma3-12b", "train reduced f32 gemma3 heads",
        "flash_attention_bwd_tf32_256", adamw_slack=True, head_dim=256,
        num_layers=1)
    out["gemma3"] = train_gemma3(report, dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"train phase: {out['seconds']:.1f} s")
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {', '.join(_build.sources())} in "
          f"{time.perf_counter() - t0:.1f} s")

    report = {name: dict(name=name, route="cuda", source=k["source"],
                         replaces=k["replaces"], launches=0, by_path={})
              for name, k in KERNELS.items()}
    t_phase = time.perf_counter()
    profiled = check_kernels(report)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    rates, more = check_stream_passes(report, gen)
    print(f"stream local rates, MiB/s ({card}):",
          json.dumps({k: round(v, 1) for k, v in rates.items()}))
    profile_deferred(profiled + more)
    del profiled, more
    check_flash(report, gen)
    check_paged(report, gen)
    print(f"kernel checks: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    cfg, params, gen = full_params()
    _, ctx = full_width(report, cfg, params, gen)
    print(f"decode phase, pull: {time.perf_counter() - t_phase:.1f} s")
    t_sub = time.perf_counter()
    push_paths(report, ctx)
    print(f"decode phase, push: {time.perf_counter() - t_sub:.1f} s")
    t_sub = time.perf_counter()
    telemetry_runs(report, ctx)
    print(f"decode phase, telemetry: {time.perf_counter() - t_sub:.1f} s")
    del ctx
    torch.cuda.empty_cache()
    reduced_f32()
    print(f"decode phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    forward_phase(report, cfg, params)
    print(f"forward phase: {time.perf_counter() - t_phase:.1f} s")
    serve_phase(report, cfg, params)
    engines_phase(report, cfg, params, card)
    del params
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    forward_reduced_f32(report)
    stream_bridge(report)
    print(f"reduced forward and stream phases: "
          f"{time.perf_counter() - t_phase:.1f} s")
    programs_swap()
    control_phase(report, card)
    dense_phase(report)
    train_phase(report)
    print(f"smoke: {time.perf_counter() - t0:.1f} s after the build started")

    # The top-level numbers of a kernel are those of its headline
    # measurement (the 8-node path's shapes where it runs there); ``by_path``
    # keeps every measurement and path.
    for name, r in report.items():
        r.update({k: v for k, v in
                  r["by_path"][KERNELS[name]["headline"]].items()
                  if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")})

    for name, k in KERNELS.items():
        if not report[name]["launches"]:
            raise AssertionError(f"no path launched {name}")
    print(json.dumps({"kernels": list(report.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
