"""Serving example of the PyTorch/CUDA port: a two-tenant disaggregated pool
under orchestration.

Batched requests decode against the SAME model under three KV placements —
local dense, bridge-pull (paper-faithful) and bridge-push (compute at the
memory) — asserting the outputs agree and reporting step timings.  The
bridge pull then runs again **multi-tenant**: the batch splits between an
interactive "chat" tenant and a batch "crawl" tenant driven through
``repro_torch.orchestrator`` — tenants register, lease pooled pages under
admission control, the decode steps attribute every bridge transfer to its
tenant via the telemetry lane, and the measured per-tenant demand re-fits
the orchestrator's weighted-fair QoS windows.  Attribution is
observational, so the two-tenant decode emits bit-identical tokens.

The model is reduced granite-3-8b in float32 with weights from seed 0, on
the card (``--device cpu`` runs it on the CPU through the kernels' plain
versions).

Run:  PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.config import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.core.control_plane import ControlPlane  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.obs.clock import MonotonicClock  # noqa: E402
from repro_torch.orchestrator import Orchestrator, TenantSpec  # noqa: E402
from repro_torch.serve import step as serve_step_mod  # noqa: E402

BATCH, MAX_LEN, STEPS, PAGE_TOKENS = 4, 64, 24, 8


def decode(run, params, prompt, device, tenant_of_seq=None, max_tenants=0,
           collect_telemetry=False):
    cache_ops = serve_step_mod.make_cache_ops(
        run, max_len=MAX_LEN, page_tokens=PAGE_TOKENS,
        collect_telemetry=collect_telemetry, tenant_of_seq=tenant_of_seq,
        max_tenants=max_tenants, dtype=torch.float32, device=device)
    state = serve_step_mod.init_serve_state(run, BATCH, cache_ops)
    step = serve_step_mod.build_serve_step(run, cache_ops)
    tokens = prompt
    out = []
    clock = MonotonicClock()
    t0 = clock.now_us()
    for _ in range(STEPS):
        tokens, state = step(params, state, tokens)
        out.append(tokens)
    toks = torch.stack(out, 1).cpu().numpy()       # waits for the device
    return toks, (clock.now_us() - t0) / 1e6 / STEPS, state


def two_tenant_demo(run, params, prompt, baseline, device) -> dict:
    """Drive the same bridge_pull decode as two orchestrated tenants."""
    # sequence b belongs to tenant b % 2: chat gets 0 and 2, crawl 1 and 3
    tenant_of_seq = np.arange(BATCH) % 2
    cp = ControlPlane(1, BATCH * (MAX_LEN // PAGE_TOKENS),
                      num_logical=BATCH * (MAX_LEN // PAGE_TOKENS),
                      device=device)
    orc = Orchestrator(cp, budget=run.bridge.epoch_budget, control_period=1,
                       max_tenants=2, migrate=False)
    orc.register(TenantSpec(0, "chat", qos="interactive", share=3.0))
    orc.register(TenantSpec(1, "crawl", qos="batch", share=1.0))
    for tid in (0, 1):
        dec, lease = orc.request_lease(
            tid, int((tenant_of_seq == tid).sum()) * (MAX_LEN // PAGE_TOKENS))
        assert dec.admitted and lease is not None

    toks, sec, state = decode(run, params, prompt, device,
                              tenant_of_seq=tenant_of_seq, max_tenants=2,
                              collect_telemetry=True)
    np.testing.assert_array_equal(baseline, toks)
    telem = serve_step_mod.collect_state_telemetry(state)
    rep = orc.step(telem)
    served = telem.tenant_served.sum(0).tolist()
    print(f"two-tenant    {sec * 1e3:7.1f} ms/step   chat served "
          f"{served[0]} pages, crawl {served[1]} "
          f"(windows after re-fit: {rep['windows']})")
    print(orc.describe())
    print("OK: two-tenant bridge decode is bit-identical (attribution is "
          "observational)")
    return dict(served=served, windows=rep["windows"])


def main(device="cuda") -> dict:
    cfg = dataclasses.replace(configs.get_reduced("granite-3-8b"),
                              dtype="float32")
    shape = ShapeConfig("example", MAX_LEN, BATCH, "decode")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen, device=device)
    prompt = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=device)

    results = {}
    for kv in ("local", "bridge_pull", "bridge_push"):
        run = RunConfig(model=cfg, shape=shape, kv_placement=kv)
        toks, sec, _ = decode(run, params, prompt, device)
        results[kv] = toks
        print(f"{kv:12s}  {sec * 1e3:7.1f} ms/step   "
              f"sample: {toks[0][:10].tolist()}")

    np.testing.assert_array_equal(results["local"], results["bridge_pull"])
    np.testing.assert_array_equal(results["local"], results["bridge_push"])
    print("OK: all three KV placements decode identical tokens")

    run = RunConfig(model=cfg, shape=shape, kv_placement="bridge_pull")
    return dict(two_tenant_demo(run, params, prompt, results["bridge_pull"],
                                device), tokens=results["local"])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error("--device cuda, but torch finds no CUDA device")
    main(args.device)
