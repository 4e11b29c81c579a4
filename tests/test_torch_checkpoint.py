"""Port parity: the checkpoint managers.

The port's ``CheckpointManager`` and ``AsyncCheckpointManager`` against the
reference's properties (roundtrip, retention, resume at the exact step, a
crash mid-save keeps the previous checkpoint, a missing leaf raises, async
ordering, the snapshot isolated from a later in-place update) and against
the reference itself: a checkpoint either package writes, the other reads
back bit for bit (same layout, manifest paths and codec), bf16 included.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager

from repro_torch import tree as ttree
from repro_torch.checkpoint import AsyncCheckpointManager, CheckpointManager
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.step import TrainState


def tree_of(seed, shapes=((4, 8), (3,), ())):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.normal(size=shapes[0]).astype(np.float32)),
        "b": {"c": torch.from_numpy(
                  rng.normal(size=shapes[1]).astype(np.float32)),
              "count": torch.tensor(int(rng.integers(0, 100)),
                                    dtype=torch.int32)},
        "d": torch.from_numpy(
            rng.normal(size=shapes[0]).astype(np.float32)).to(torch.bfloat16),
    }


def assert_tree_equal(a, b):
    la, lb = ttree.leaves(a), ttree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = tree_of(0)
    mgr.save(10, tree, extra={"step": 10, "note": "x"})
    restored, extra = mgr.restore(tree)
    assert_tree_equal(tree, restored)
    assert extra["step"] == 10


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (5, 10, 15, 20):
        mgr.save(s, tree_of(s))
    assert mgr.latest_step() == 20
    assert mgr.steps() == [15, 20]


def test_resume_restores_exact_step(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t1, t2 = tree_of(1), tree_of(2)
    mgr.save(1, t1, extra={"step": 1})
    mgr.save(2, t2, extra={"step": 2})
    r1, e1 = mgr.restore(t1, step=1)
    assert_tree_equal(t1, r1)
    assert e1["step"] == 1
    r2, _ = mgr.restore(t2)
    assert_tree_equal(t2, r2)


def test_crash_mid_save_preserves_previous(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = tree_of(3)
    mgr.save(1, tree)
    crash = pathlib.Path(tmp_path) / "step_2.tmp"
    crash.mkdir()
    (crash / "manifest.json").write_text("{corrupt")
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(tree)
    assert_tree_equal(tree, restored)
    mgr.save(2, tree)
    assert mgr.latest_step() == 2


def test_missing_leaf_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="zz"):
        mgr.restore({"a": torch.zeros(2), "zz": torch.zeros(3)})


def test_train_state_roundtrip_keeps_paths_and_dtypes(tmp_path):
    """A TrainState (bf16 parameters, float32 moments, int32 scalars) comes
    back equal, under the paths ``jax.tree_util.keystr`` gives the
    reference's TrainState."""
    p = tree_of(4)
    state = TrainState(params={"w": p["d"], "layers": [p["a"], p["b"]]},
                       opt=AdamWState(m={"w": p["a"]}, v={"w": p["a"] * 2},
                                      count=torch.tensor(3,
                                                         dtype=torch.int32)),
                       step=torch.tensor(3, dtype=torch.int32))
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, state, extra={"step": 3})
    restored, _ = mgr.restore(state)
    assert isinstance(restored, TrainState) and restored.ef_residual is None
    assert_tree_equal(state, restored)
    manifest = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert [item["path"] for item in manifest["leaves"]] == [
        ".params['layers'][0]", ".params['layers'][1]['c']",
        ".params['layers'][1]['count']", ".params['w']", ".opt.m['w']",
        ".opt.v['w']", ".opt.count", ".step"]
    assert manifest["leaves"][3]["dtype"] == "bfloat16"


def test_both_packages_read_each_others_checkpoints(tmp_path):
    """Same layout: the reference restores what the port wrote and the
    port restores what the reference wrote, bit for bit."""
    tree = tree_of(5)
    CheckpointManager(tmp_path / "port").save(7, tree, extra={"step": 7})
    jtemplate = {"a": jnp.zeros((4, 8)),
                 "b": {"c": jnp.zeros(3), "count": jnp.zeros((), jnp.int32)},
                 "d": jnp.zeros((4, 8), jnp.bfloat16)}
    got, extra = JCheckpointManager(tmp_path / "port").restore(jtemplate)
    assert extra == {"step": 7}
    for (path, x), y in zip(ttree.leaves_with_path(tree),
                            jax.tree.leaves(got)):
        want = x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
        assert str(y.dtype) == str(x.dtype).replace("torch.", ""), path
        np.testing.assert_array_equal(np.asarray(y, np.float32)
                                      if x.dtype == torch.bfloat16 else y,
                                      want)

    jtree = jax.tree.map(jnp.asarray, {
        "a": np.arange(6, dtype=np.float32).reshape(2, 3),
        "z": np.asarray([1, -2], np.int32)})
    jtree["h"] = jnp.asarray([1.5, -0.25], jnp.bfloat16)
    JCheckpointManager(tmp_path / "ref").save(2, jtree, extra={"step": 2})
    template = {"a": torch.zeros(2, 3), "z": torch.zeros(2, dtype=torch.int32),
                "h": torch.zeros(2, dtype=torch.bfloat16)}
    back, _ = CheckpointManager(tmp_path / "ref").restore(template)
    assert torch.equal(back["a"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(back["z"], torch.tensor([1, -2], dtype=torch.int32))
    assert torch.equal(back["h"], torch.tensor([1.5, -0.25],
                                               dtype=torch.bfloat16))


def test_async_roundtrip_and_ordering(tmp_path):
    mgr = AsyncCheckpointManager(tmp_path, keep=2)
    trees = {s: tree_of(s) for s in (1, 2, 3)}
    for s in (1, 2, 3):
        mgr.save(s, trees[s], extra={"step": s})
    mgr.wait()
    assert mgr.latest_step() == 3
    assert mgr.steps() == [2, 3]
    restored, extra = mgr.restore(trees[3])
    assert_tree_equal(trees[3], restored)
    assert extra["step"] == 3


def test_async_snapshot_isolated_from_in_place_update(tmp_path):
    """The port's optimizer updates the state in place where the reference
    donates it: an update right after save() must not reach the image."""
    mgr = AsyncCheckpointManager(tmp_path)
    tree = {"w": torch.arange(8, dtype=torch.float32),
            "h": torch.arange(8, dtype=torch.float32).to(torch.bfloat16)}
    mgr.save(5, tree, extra={"step": 5})
    for x in tree.values():
        x.mul_(0).sub_(1)
    mgr.wait()
    restored, _ = mgr.restore({"w": torch.zeros(8),
                               "h": torch.zeros(8, dtype=torch.bfloat16)})
    assert torch.equal(restored["w"], torch.arange(8, dtype=torch.float32))
    assert torch.equal(restored["h"].float(), torch.arange(8.0))
