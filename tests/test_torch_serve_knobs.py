"""The port's ``make_cache_ops`` honours every bridge knob of ``RunConfig``.

A bridge placement carries ``run.bridge.fused`` and
``run.bridge.edge_buffer`` to its ``BridgeCacheOps`` (``fused=False``: the
unfused engines; ``edge_buffer=False``: the bufferless bridge), and a
reduced granite-3-8b decode in float32 under either, over 1 and 3 memory
nodes, pull and push, emits the fused engine's tokens with logits within
1e-4; the launcher's ``--no-fused`` reaches ``run.bridge.fused``.  The
default knobs and the placements without the bridge still build.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.config import BridgeConfig, RunConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.serve import step as serve_step
from repro_torch.serve.cache_ops import BridgeCacheOps

torch.set_num_threads(1)


def run_config(kv: str, **bridge) -> RunConfig:
    return RunConfig(model=configs.get_reduced("granite-3-8b"),
                     shape=ShapeConfig("test", 32, 2, "decode"),
                     kv_placement=kv, bridge=BridgeConfig(**bridge))


@pytest.mark.parametrize("kv", ["bridge_pull", "bridge_push"])
@pytest.mark.parametrize("knob", ["fused", "edge_buffer"])
def test_make_cache_ops_carries_the_engine_knobs(kv, knob):
    ops = serve_step.make_cache_ops(run_config(kv, **{knob: False},
                                               channels=2),
                                    max_len=32, page_tokens=8, num_nodes=2,
                                    dtype=torch.float32, device="cpu")
    assert isinstance(ops, BridgeCacheOps)
    assert ops.mode == kv.split("_")[1]
    assert getattr(ops, knob) is False
    other = {"fused": "edge_buffer", "edge_buffer": "fused"}[knob]
    assert getattr(ops, other) is True and ops.channels == 2


def decode_tokens(run: RunConfig, num_nodes: int, steps: int = 12):
    """A reduced granite-3-8b greedy decode in float32 on the CPU (2
    layers, weights from seed 0, a 4-token prompt): (tokens, logits)."""
    cfg = run.model
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = transformer.init_params(cfg, gen, device="cpu")
    ops = serve_step.make_cache_ops(run, max_len=24, page_tokens=4,
                                    num_nodes=num_nodes, dtype=torch.float32,
                                    device="cpu")
    state = serve_step.init_serve_state(run, 3, ops)
    prompt = torch.tensor([[5, 9, 2], [17, 3, 40], [8, 8, 1], [30, 2, 11]],
                          dtype=torch.int32)
    tokens, emitted, logits_all = None, [], []
    for i in range(steps):
        if i < prompt.shape[0]:
            tokens = prompt[i]
        logits, state = transformer.decode_step(cfg, params, state, tokens,
                                                ops)
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        emitted.append(tokens)
        logits_all.append(logits)
    return torch.stack(emitted), torch.stack(logits_all)


@pytest.mark.parametrize("num_nodes", [1, 3])
@pytest.mark.parametrize("kv", ["bridge_pull", "bridge_push"])
@pytest.mark.parametrize("engine", [dict(fused=False),
                                    dict(fused=False, channels=2),
                                    dict(edge_buffer=False, channels=2)],
                         ids=["unfused", "unfused-channels2", "bufferless"])
def test_unfused_and_bufferless_decode_match_fused(engine, kv, num_nodes):
    base = run_config(kv)
    cfg = dataclasses.replace(base.model, dtype="float32", num_layers=2)
    fused = dataclasses.replace(base, model=cfg)
    other = dataclasses.replace(fused, bridge=BridgeConfig(**engine))
    want_tokens, want_logits = decode_tokens(fused, num_nodes)
    got_tokens, got_logits = decode_tokens(other, num_nodes)
    assert torch.equal(got_tokens, want_tokens)
    torch.testing.assert_close(got_logits, want_logits, rtol=1e-4, atol=1e-4)


def test_no_fused_reaches_the_run_config():
    from repro_torch.launch import serve
    for argv, fused in (([], True), (["--no-fused"], False)):
        args = serve.build_parser().parse_args(
            ["--arch", "granite-3-8b", "--reduced", "--kv", "bridge_pull"]
            + argv)
        run = serve.make_run(configs.get_reduced("granite-3-8b"), args)
        assert run.bridge.fused is fused
        assert run.bridge.edge_buffer is True


@pytest.mark.parametrize("kv", ["bridge_pull", "bridge_push"])
def test_default_bridge_knobs_build(kv):
    run = run_config(kv)
    assert run.bridge.fused and run.bridge.edge_buffer
    ops = serve_step.make_cache_ops(run, max_len=32, page_tokens=8,
                                    num_nodes=2, dtype=torch.float32,
                                    device="cpu")
    assert isinstance(ops, BridgeCacheOps)
    assert ops.fused and ops.edge_buffer


@pytest.mark.parametrize("kv", ["local", "ring"])
def test_placements_without_the_bridge_ignore_the_knobs(kv):
    run = run_config(kv, fused=False, edge_buffer=False)
    ops = serve_step.make_cache_ops(run, max_len=32, dtype=torch.float32,
                                    device="cpu")
    assert not isinstance(ops, BridgeCacheOps)
