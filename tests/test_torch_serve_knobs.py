"""The port's ``make_cache_ops`` refuses the bridge knobs it cannot honour.

The port runs the fused, edge-buffered bridge engine only.  A bridge
placement that asks for ``run.bridge.fused=False`` (the reference's
unfused engine) or ``run.bridge.edge_buffer=False`` (its bufferless one)
must raise ``NotImplementedError``, not run the fused engine in its place;
the default knobs and the placements without the bridge still build.
"""
import pytest
import torch

from repro_torch import configs
from repro_torch.config import BridgeConfig, RunConfig, ShapeConfig
from repro_torch.serve import step as serve_step
from repro_torch.serve.cache_ops import BridgeCacheOps


def run_config(kv: str, **bridge) -> RunConfig:
    return RunConfig(model=configs.get_reduced("granite-3-8b"),
                     shape=ShapeConfig("test", 32, 2, "decode"),
                     kv_placement=kv, bridge=BridgeConfig(**bridge))


@pytest.mark.parametrize("kv", ["bridge_pull", "bridge_push"])
@pytest.mark.parametrize("knob", ["fused", "edge_buffer"])
def test_unported_bridge_engines_raise(kv, knob):
    with pytest.raises(NotImplementedError, match=f"run.bridge.{knob}=False"):
        serve_step.make_cache_ops(run_config(kv, **{knob: False}),
                                  max_len=32, page_tokens=8,
                                  dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("kv", ["bridge_pull", "bridge_push"])
def test_default_bridge_knobs_build(kv):
    run = run_config(kv)
    assert run.bridge.fused and run.bridge.edge_buffer
    ops = serve_step.make_cache_ops(run, max_len=32, page_tokens=8,
                                    num_nodes=2, dtype=torch.float32,
                                    device="cpu")
    assert isinstance(ops, BridgeCacheOps)


@pytest.mark.parametrize("kv", ["local", "ring"])
def test_placements_without_the_bridge_ignore_the_knobs(kv):
    run = run_config(kv, fused=False, edge_buffer=False)
    ops = serve_step.make_cache_ops(run, max_len=32, dtype=torch.float32,
                                    device="cpu")
    assert not isinstance(ops, BridgeCacheOps)
