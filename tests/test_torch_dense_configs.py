"""Port parity of the three dense configs: h2o-danube-3-4b, gemma3-12b and
starcoder2-7b, reduced, in float32.

Each reduced config (h2o: 2 sliding-window layers, head_dim 32; gemma3: 12
layers, 5 sliding-window layers to 1 global, logit softcap 30, GeGLU;
starcoder2: 2 full layers, LayerNorm, a non-GLU GELU FFN) takes the JAX
package's parameters, carried across by ``weights.from_reference``.  At
B 2 and S 96, past the reduced 64-token window:

* the port's sequence forward is held to the JAX forward
  (``attn_impl="xla"``) at 2e-5;
* the port's teacher-forced decode over the same 96 tokens under ``local``,
  ``ring``, ``bridge_pull`` and ``bridge_push`` (the pull on one memory
  node, the push striped over 8) is held to the JAX ``local`` decode at
  2e-5, step by step.  h2o's sliding-window layers keep a local ring under
  every placement, so its bridge placements carry no pool at all.

The JAX decode step is jitted once per config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import RunConfig as JRunConfig, ShapeConfig as JShape
from repro.models import transformer as jtransformer
from repro.serve import step as jstep

from repro_torch import configs as tconfigs, weights
from repro_torch.config import BridgeConfig as TBridge
from repro_torch.config import RunConfig as TRunConfig, ShapeConfig as TShape
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import step as tstep

ARCHS = ("h2o-danube-3-4b", "gemma3-12b", "starcoder2-7b")
BATCH, SEQ, PAGE_TOKENS = 2, 96, 16
TOL = dict(rtol=2e-5, atol=2e-5)
PLACEMENTS = (("local", 1), ("ring", 1), ("bridge_pull", 1),
              ("bridge_push", 8))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: on a host whose cores the suite's other workers
    keep busy, these tiny float32 ops run several times faster on one
    thread than on many."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), dtype="float32")
    params = jtransformer.init_params(jcfg, jax.random.key(0))
    t_params = weights.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return arch, jcfg, tcfg, params, t_params, toks


@pytest.fixture(scope="module")
def jax_decode(model):
    """The JAX ``local`` decode's logits [S, B, V], teacher-forced."""
    _, jcfg, _, params, _, toks = model
    run = JRunConfig(model=jcfg, shape=JShape("t", SEQ, BATCH, "decode"),
                     kv_placement="local")
    ops = jstep.make_cache_ops(run, mesh=None, max_len=SEQ,
                               page_tokens=PAGE_TOKENS, dtype=jnp.float32)
    state = jstep.init_serve_state(run, BATCH, ops)
    step = jax.jit(lambda p, s, t: jtransformer.decode_step(jcfg, p, s, t,
                                                            ops))
    out = []
    for i in range(SEQ):
        logits, state = step(params, state, jnp.asarray(toks[:, i]))
        out.append(np.asarray(logits))
    return np.stack(out)


def test_forward_matches_reference(model):
    arch, jcfg, tcfg, params, t_params, toks = model
    want, _ = jtransformer.forward(jcfg, params, {"tokens": toks},
                                   attn_impl="xla")
    got, aux = ttransformer.forward(tcfg, t_params,
                                    {"tokens": torch.from_numpy(toks)})
    assert aux == {} and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               err_msg=arch, **TOL)


@pytest.mark.parametrize("kv,num_nodes", PLACEMENTS)
def test_decode_matches_reference(model, jax_decode, kv, num_nodes):
    arch, _, tcfg, _, t_params, toks = model
    run = TRunConfig(model=tcfg, shape=TShape("t", SEQ, BATCH, "decode"),
                     kv_placement=kv, bridge=TBridge())
    ops = tstep.make_cache_ops(run, SEQ, PAGE_TOKENS, num_nodes=num_nodes,
                               dtype=torch.float32, device="cpu")
    state = tstep.init_serve_state(run, BATCH, ops)
    pooled = ["paged" in st for st in state["layers"]]
    bridged = kv.startswith("bridge")
    # only full-attention layers reach the pool: gemma3's global layers,
    # every starcoder2 layer, no h2o layer
    assert pooled == [bridged and k != "swa" for k in tcfg.layers], arch
    for i in range(SEQ):
        logits, state = ttransformer.decode_step(
            tcfg, t_params, state, torch.from_numpy(toks[:, i]), ops)
        np.testing.assert_allclose(logits.numpy(), jax_decode[i],
                                   err_msg=f"{arch} {kv} step {i}", **TOL)
