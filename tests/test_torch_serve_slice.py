"""Port parity of the whole slice: reduced granite-3-8b, bridge_pull decode.

The JAX package's parameters for ``reduced("granite-3-8b")`` in float32
(2 layers, d_model 128) are carried across with ``weights.from_reference``;
both packages then decode the same prompt greedily for 24 steps at
``page_tokens=8``, ``max_len=64``.  Logits agree per step at 1e-4 (float32;
the attention's online softmax and the matmuls sum in another order than
XLA's) and the token sequences are identical.  The port's bridge_pull runs
on one memory node and striped over 8 (and 3, with two channels), against
the reference's one-node bridge_pull and its ``local`` placement.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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
from repro_torch.kernels import _build, bridge_attention, bridge_gather
from repro_torch.models import transformer as ttransformer
from repro_torch.serve import step as tstep

REPO = Path(__file__).resolve().parents[1]
BATCH, MAX_LEN, STEPS, PAGE_TOKENS = 4, 64, 24, 8
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = dataclasses.replace(jconfigs.get_reduced("granite-3-8b"),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_reduced("granite-3-8b"),
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = jtransformer.init_params(jcfg, jax.random.key(0))
    params_np = jax.tree.map(np.asarray, params)
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, BATCH).astype(np.int32)
    return jcfg, tcfg, params, params_np, prompt


def jax_decode(cfg, params, kv, prompt):
    run = JRunConfig(model=cfg, shape=JShape("t", MAX_LEN, BATCH, "decode"),
                     kv_placement=kv)
    ops = jstep.make_cache_ops(run, mesh=None, max_len=MAX_LEN,
                               page_tokens=PAGE_TOKENS, dtype=jnp.float32)
    state = jstep.init_serve_state(run, BATCH, ops)
    step = jax.jit(lambda p, s, t: jtransformer.decode_step(cfg, p, s, t, ops))
    tokens, all_logits, all_tokens = jnp.asarray(prompt), [], []
    for _ in range(STEPS):
        logits, state = step(params, state, tokens)
        tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        all_logits.append(np.asarray(logits))
        all_tokens.append(np.asarray(tokens))
    return np.stack(all_logits), np.stack(all_tokens, 1)


def port_decode(cfg, params, kv, prompt, num_nodes=1, channels=1):
    run = TRunConfig(model=cfg, shape=TShape("t", MAX_LEN, BATCH, "decode"),
                     kv_placement=kv, bridge=TBridge(channels=channels))
    ops = tstep.make_cache_ops(run, MAX_LEN, PAGE_TOKENS,
                               num_nodes=num_nodes, dtype=torch.float32,
                               device="cpu")
    state = tstep.init_serve_state(run, BATCH, ops)
    tokens, all_logits, all_tokens = torch.from_numpy(prompt), [], []
    for _ in range(STEPS):
        logits, state = ttransformer.decode_step(cfg, params, state, tokens,
                                                 ops)
        tokens = torch.argmax(logits, -1).to(torch.int32)
        all_logits.append(logits.numpy())
        all_tokens.append(tokens.numpy())
    return np.stack(all_logits), np.stack(all_tokens, 1)


def port_serve_tokens(cfg, params, kv, prompt):
    """Greedy tokens of the port's serve step (what the launcher runs)."""
    run = TRunConfig(model=cfg, shape=TShape("t", MAX_LEN, BATCH, "decode"),
                     kv_placement=kv)
    ops = tstep.make_cache_ops(run, MAX_LEN, PAGE_TOKENS,
                               dtype=torch.float32, device="cpu")
    state = tstep.init_serve_state(run, BATCH, ops)
    serve_step = tstep.build_serve_step(run, ops)
    tokens, out = torch.from_numpy(prompt), []
    for _ in range(STEPS):
        tokens, state = serve_step(params, state, tokens)
        out.append(tokens.numpy())
    return np.stack(out, 1)


@pytest.mark.parametrize("kv", ["bridge_pull", "local"])
def test_slice_matches_reference(slice_setup, kv):
    """bridge_pull is the slice; local is the placement it is checked
    against on the card, so it must match the reference too."""
    jcfg, tcfg, params, params_np, prompt = slice_setup
    j_logits, j_tokens = jax_decode(jcfg, params, kv, prompt)
    t_params = weights.from_reference(params_np, tcfg, device="cpu")
    t_logits, t_tokens = port_decode(tcfg, t_params, kv, prompt)
    for step in range(STEPS):
        np.testing.assert_allclose(t_logits[step], j_logits[step],
                                   err_msg=f"step {step}", **LOGIT_TOL)
    assert np.array_equal(t_tokens, j_tokens)


@pytest.fixture(scope="module")
def jax_local(slice_setup):
    jcfg, _, params, _, prompt = slice_setup
    return jax_decode(jcfg, params, "local", prompt)


@pytest.mark.parametrize("num_nodes,channels", [(8, 1), (3, 2)])
def test_nnode_slice_matches_reference(slice_setup, jax_local, num_nodes,
                                       channels):
    """bridge_pull with the KV pool striped over memory nodes (the batch of
    4 splits unevenly over 3 and leaves 4 of 8 nodes idle) against the
    reference's ``local`` placement: identical tokens, logits at 1e-4."""
    _, tcfg, _, params_np, prompt = slice_setup
    j_logits, j_tokens = jax_local
    t_params = weights.from_reference(params_np, tcfg, device="cpu")
    t_logits, t_tokens = port_decode(tcfg, t_params, "bridge_pull", prompt,
                                     num_nodes=num_nodes, channels=channels)
    for step in range(STEPS):
        np.testing.assert_allclose(t_logits[step], j_logits[step],
                                   err_msg=f"step {step}", **LOGIT_TOL)
    assert np.array_equal(t_tokens, j_tokens)


def test_local_and_bridge_pull_emit_identical_tokens(slice_setup):
    """The contract of examples/serve_decode.py, held by the port alone:
    the KV placement never changes what is decoded."""
    _, tcfg, _, _, prompt = slice_setup
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    params = ttransformer.init_params(tcfg, gen, device="cpu")
    local = port_serve_tokens(tcfg, params, "local", prompt)
    pulled = port_serve_tokens(tcfg, params, "bridge_pull", prompt)
    assert local.shape == (BATCH, STEPS)
    assert np.array_equal(local, pulled)


def test_from_reference_layout(slice_setup):
    _, tcfg, _, params_np, _ = slice_setup
    p = weights.from_reference(params_np, tcfg, device="cpu")
    assert len(p["layers"]) == tcfg.num_layers
    assert tuple(p["embed"].shape) == (tcfg.padded_vocab, tcfg.d_model)
    assert "lm_head" not in p                     # tied embeddings
    stacked = params_np["periods"]["pos0"]
    for li, layer in enumerate(p["layers"]):
        assert np.array_equal(layer["attn"]["wq"].numpy(),
                              stacked["attn"]["wq"][li])
        assert np.array_equal(layer["ffn"]["wo"].numpy(),
                              stacked["ffn"]["wo"][li])
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    fresh = ttransformer.init_params(tcfg, gen, device="cpu")
    for name, w in p["layers"][1]["ffn"].items():
        assert fresh["layers"][1]["ffn"][name].shape == w.shape


def test_unregistered_arch_names_later_slice():
    with pytest.raises(KeyError, match="later slice"):
        tconfigs.get_config("recurrentgemma-9b")
    assert tconfigs.get_config("granite-3-8b").num_layers == 40


_BLOCK_REFERENCE = r'''
import importlib, importlib.util, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")

sys.meta_path.insert(0, Block())
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
print("IMPORTS OK")
'''


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, its launcher and chip_smoke.py import
    with jax and the reference package made unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", _BLOCK_REFERENCE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "IMPORTS OK" in res.stdout


def test_port_sources_name_neither_jax_nor_reference():
    """Static scan: no import of jax or repro anywhere in the port's files,
    lazy imports inside functions included."""
    import ast
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            assert not set(roots) & {"jax", "jaxlib", "repro"}, (path, roots)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU reaches the kernel or an exception:
    here (no CUDA) every wrapper raises on meta tensors."""
    meta = dict(device="meta")
    pool = torch.empty((4, 2, 8), **meta)
    ids = torch.empty((3,), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        bridge_gather.gather_pages(pool, ids)
    with pytest.raises(ValueError, match="CUDA"):
        bridge_gather.scatter_pages(pool, ids, torch.empty((3, 2, 8), **meta))
    ids2 = torch.empty((2, 3), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        bridge_gather.pull_commit(pool, torch.empty((2, 2, 3, 2, 8), **meta),
                                  ids2, ids2)
    with pytest.raises(ValueError, match="CUDA"):
        bridge_gather.push_commit(
            pool, torch.empty((2, 2, 3), dtype=torch.int32, **meta),
            torch.empty((2, 5, 2, 8), **meta),
            torch.empty((2,), dtype=torch.int32, **meta), channels=1, cb=3)
    q = torch.empty((2, 4, 8), **meta)
    pages = torch.empty((3, 2, 2, 8), **meta)
    with pytest.raises(ValueError, match="CUDA"):
        bridge_attention.stream_decode_accumulate(
            q, pages, pages, ids, ids, torch.empty((2, 4), **meta),
            torch.empty((2, 4), **meta), torch.empty((2, 4, 8), **meta))
    assert bridge_gather.gather_pages.launches == 0
    assert bridge_gather.pull_commit.launches == 0
    assert bridge_gather.push_commit.launches == 0
    assert bridge_attention.stream_decode_accumulate.launches == 0


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "TOOLKIT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    assert _build.sources() == ["bridge_attention", "bridge_gather",
                               "flash_attention",
                               "flash_attention_bwd_tf32",
                               "flash_attention_bwd_tf32_256",
                               "flash_attention_bwd_wgmma",
                               "flash_attention_bwd_wgmma256",
                               "flash_attention_wgmma", "paged_attention",
                               "stream"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.bind("bridge_gather", "repro_gather_pages", "7q")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_kernel_library_name_hashes_headers_and_flags(monkeypatch, tmp_path):
    """An edit to a shared header or to the compiler flags names a new
    library, so a stale build is never loaded."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("k")
    assert _build._lib_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build._lib_path("k")
    assert second != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build._lib_path("k") not in (first, second)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "granite-3-8b", "--reduced", "--device", "cpu",
                "--kv", "bridge_pull", "--batch", "2", "--steps", "3",
                "--max-len", "16", "--page-tokens", "4"])
    out = capsys.readouterr().out
    assert "kv=bridge_pull batch=2 steps=3 device=cpu" in out
    assert "ms/step" in out


def test_launcher_local_runs_past_max_len_on_cpu(capsys):
    """20 steps of a 16-position local cache: the writes past max_len drop,
    as the reference's launcher with the same flags does, and decoding goes
    on to print its tokens."""
    from repro_torch.launch import serve
    serve.main(["--arch", "granite-3-8b", "--reduced", "--device", "cpu",
                "--kv", "local", "--batch", "2", "--steps", "20",
                "--max-len", "16"])
    out = capsys.readouterr().out
    assert "kv=local batch=2 steps=20 device=cpu" in out
    sample = out.split("sample:")[1].strip()
    assert len(sample.strip("[]").split(",")) == 16


def test_launcher_runs_nnode_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "granite-3-8b", "--reduced", "--device", "cpu",
                "--kv", "bridge_pull", "--batch", "3", "--steps", "9",
                "--max-len", "16", "--page-tokens", "4", "--num-nodes", "8",
                "--channels", "2"])
    out = capsys.readouterr().out
    assert "bridge: num_nodes=8 channels=2" in out
    assert "ms/step" in out


@pytest.mark.parametrize("fn", ["rmsnorm", "layernorm", "rope", "silu",
                                "gelu", "unembed"])
def test_layers_match_reference(fn):
    """The port's shared layers against the reference's, float32 at 1e-5."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    pos = rng.integers(0, 500, (3, 5)).astype(np.int32)
    table = rng.standard_normal((32, 16)).astype(np.float32)
    tx = torch.from_numpy(x)
    if fn in ("rmsnorm", "layernorm"):
        want = getattr(jl, fn)(jnp.asarray(x), jnp.asarray(scale))
        got = getattr(tl, fn)(tx, torch.from_numpy(scale))
    elif fn == "rope":
        want = jl.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
        got = tl.rope(tx, torch.from_numpy(pos), 10_000.0)
    elif fn == "unembed":
        want = jl.unembed(jnp.asarray(x), jnp.asarray(table), softcap=30.0)
        got = tl.unembed(tx, torch.from_numpy(table), softcap=30.0)
    else:
        want = jl.act_fn(fn)(jnp.asarray(x))
        got = tl.act_fn(fn)(tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
