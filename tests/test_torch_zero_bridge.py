"""Port parity: the memory pool, the ZeRO store through the bridge and the
elastic trainer.

For a dict of arrays the port's ``TreePacker`` gives the reference's offsets
and counts (leaves in ``jax.tree`` order), and after ``create_store`` on
equal control planes (4 logical memory nodes, the loopback path) the port's
table and pool hold the reference's bits.  ``pull_tree`` / ``push_tree``
round trips bit for bit, their in-band counters equal the reference's and
the port's host oracle; ``rehome_after_failure`` leaves the reference's
table and pool; the fused 4-node engine (``num_nodes=4``) pulls what the
loopback path pulls.  The ``ElasticTrainer`` recovers with the reference's
events, step numbers and history, and ``examples/train_lm_torch.py`` runs
to its end on the CPU.
"""
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import pool as jpool
from repro.core import zero_bridge as jzb
from repro.core.control_plane import ControlPlane as JControlPlane
from repro.ft.elastic import ElasticTrainer as JElasticTrainer

from repro_torch import tree as ttree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import pool as tpool
from repro_torch.core import ref as tref
from repro_torch.core import zero_bridge as tzb
from repro_torch.core.control_plane import ControlPlane
from repro_torch.ft.elastic import ElasticTrainer, FailureEvent

from test_torch_telemetry import assert_counters_equal

ROOT = Path(__file__).resolve().parents[1]
PAGE = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(37, 11)) * scale).astype(np.float32),
            "b": (rng.normal(size=(5,)) * scale).astype(np.float32),
            "emb": (rng.normal(size=(3, 40)) * scale).astype(np.float32),
            "a": (rng.normal(size=(64,)) * scale).astype(np.float32)}


def planes(ppn=40, num_logical=200):
    return (JControlPlane(4, ppn, num_logical),
            ControlPlane(4, ppn, num_logical, device="cpu"))


def torch_tree(a):
    return {k: torch.from_numpy(v.copy()) for k, v in a.items()}


def assert_tables_equal(ttable, jtable):
    assert np.array_equal(ttable.home.numpy(), np.asarray(jtable.home))
    assert np.array_equal(ttable.slot.numpy(), np.asarray(jtable.slot))


def test_tree_packer_and_store_match_reference():
    a = arrays(0)
    jp = jzb.TreePacker.plan({k: jnp.asarray(v) for k, v in a.items()}, PAGE)
    tp = tzb.TreePacker.plan(torch_tree(a), PAGE)
    assert (tp.offsets, tp.counts, tp.num_pages) == (jp.offsets, jp.counts,
                                                     jp.num_pages)
    assert tp.shapes == jp.shapes
    jcp, tcp = planes()
    jstore = jzb.create_store({k: jnp.asarray(v) for k, v in a.items()},
                              mesh=None, page_elems=PAGE, cp=jcp)
    tstore = tzb.create_store(torch_tree(a), page_elems=PAGE, cp=tcp)
    assert tstore.table_nodes == jstore.table_nodes == 4
    assert_tables_equal(tstore.table, jstore.table)
    assert np.array_equal(tstore.pool.numpy(), np.asarray(jstore.pool))
    assert tstore.pool.dtype == torch.float32
    assert tcp.occupancy().tolist() == jcp.occupancy().tolist()


def test_pull_push_roundtrip_and_counters():
    a, b = arrays(1), arrays(2, scale=3.0)
    jcp, tcp = planes()
    jstore = jzb.create_store({k: jnp.asarray(v) for k, v in a.items()},
                              mesh=None, page_elems=PAGE, cp=jcp,
                              tenant_id=2, max_tenants=4)
    tstore = tzb.create_store(torch_tree(a), page_elems=PAGE, cp=tcp,
                              tenant_id=2, max_tenants=4)
    got, telem = tzb.pull_tree(tstore, collect_telemetry=True)
    for k in a:
        assert torch.equal(got[k], torch.from_numpy(a[k]))
    _, jtelem = jzb.pull_tree(jstore, mesh=None, collect_telemetry=True)
    assert_counters_equal(telem, jtelem, "pull")
    want = tzb._node_requests(tstore.packer.num_pages, 1, "cpu")
    oracle = tref.expected_transfer_telemetry(
        want, tstore.table, tstore.program, num_nodes=4,
        budget=tstore.budget, tenant_ids=torch.full_like(want, 2),
        max_tenants=4)
    assert_counters_equal(telem, oracle, "pull vs oracle")

    tstore, telem = tzb.push_tree(tstore, torch_tree(b),
                                  collect_telemetry=True)
    jstore, jtelem = jzb.push_tree(
        jstore, {k: jnp.asarray(v) for k, v in b.items()}, mesh=None,
        collect_telemetry=True)
    assert_counters_equal(telem, jtelem, "push")
    assert np.array_equal(tstore.pool.numpy(), np.asarray(jstore.pool))
    back = tzb.pull_tree(tstore)
    assert all(torch.equal(back[k], torch.from_numpy(b[k])) for k in b)


def test_rehome_after_failure_matches_reference():
    a, restore = arrays(3), arrays(4)
    jcp, tcp = planes()
    jstore = jzb.create_store({k: jnp.asarray(v) for k, v in a.items()},
                              mesh=None, page_elems=PAGE, cp=jcp)
    tstore = tzb.create_store(torch_tree(a), page_elems=PAGE, cp=tcp)
    jstore = jzb.rehome_after_failure(
        jstore, jcp, 2, {k: jnp.asarray(v) for k, v in restore.items()},
        mesh=None)
    tstore = tzb.rehome_after_failure(tstore, tcp, 2, torch_tree(restore))
    assert_tables_equal(tstore.table, jstore.table)
    assert not (tstore.table.home == 2).any()
    assert np.array_equal(tstore.pool.numpy(), np.asarray(jstore.pool))
    back = tzb.pull_tree(tstore)
    assert all(torch.equal(back[k], torch.from_numpy(restore[k]))
               for k in restore)
    program = tcp.route_program()
    assert tzb.with_program(tstore, program).program is program


def test_nnode_engine_pulls_what_the_loopback_path_pulls():
    a = arrays(5)
    stores = {n: tzb.create_store(torch_tree(a), num_nodes=n,
                                  page_elems=PAGE,
                                  cp=ControlPlane(4, 40, 200, device="cpu"))
              for n in (1, 4)}
    assert torch.equal(stores[1].pool, stores[4].pool)
    got = {n: tzb.pull_tree(s) for n, s in stores.items()}
    for k in a:
        assert torch.equal(got[4][k], got[1][k])
        assert torch.equal(got[1][k], torch.from_numpy(a[k]))


def test_pool_write_and_read_local_match_reference():
    rng = np.random.default_rng(6)
    pages = rng.normal(size=(5, 8)).astype(np.float32)
    slots = np.array([3, -1, 11, 0, 7], np.int32)
    jp = jpool.write_local(jpool.make_pool(2, 6, 8, jnp.float32),
                           jnp.asarray(slots), jnp.asarray(pages))
    tp = tpool.write_local(tpool.make_pool(2, 6, 8, torch.float32,
                                           device="cpu"),
                           torch.from_numpy(slots), torch.from_numpy(pages))
    assert np.array_equal(tp.pages.numpy(), np.asarray(jp.pages))
    assert tp.node_view(2).shape == (2, 6, 8)
    ids = np.array([0, -1, 11, 3], np.int32)
    assert np.array_equal(
        tpool.read_local(tp, torch.from_numpy(ids)).numpy(),
        np.asarray(jpool.read_local(jp, jnp.asarray(ids))))


# -- elastic trainer -------------------------------------------------------

def counting_step(state, batch):
    return {"x": state["x"] + batch["inc"]}, {"loss": 1.0 / (state["x"] + 1)}


def batches(make):
    while True:
        yield {"inc": make(1.0)}


@pytest.mark.parametrize("schedule", [{17: 1}, {12: 3, 25: 0}])
def test_elastic_recovery_matches_reference(tmp_path, schedule):
    runs = {}
    for name, (mgr, cp_cls, trainer_cls, make, kw) in {
            "jax": (JCheckpointManager, JControlPlane, JElasticTrainer,
                    jnp.asarray, {}),
            "port": (CheckpointManager, ControlPlane, ElasticTrainer,
                     torch.tensor, dict(device="cpu"))}.items():
        cp = cp_cls(num_nodes=4, pages_per_node=8, num_logical=16, **kw)
        cp.allocate(8)
        trainer = trainer_cls(step_fn=counting_step,
                              ckpt=mgr(tmp_path / name), cp=cp,
                              ckpt_every=10)
        state, hist = trainer.run({"x": make(0.0)}, batches(make),
                                  num_steps=30,
                                  failure_schedule=dict(schedule))
        runs[name] = (float(state["x"]), hist,
                      [(e.node, e.at_step, e.kind) for e in trainer.events],
                      np.asarray(cp.table().home).tolist(),
                      [n.alive for n in cp.nodes])
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == 30.0


def test_elastic_link_failure_and_rate_limits():
    cp = ControlPlane(num_nodes=4, pages_per_node=8, num_logical=8,
                      device="cpu")
    trainer = ElasticTrainer(step_fn=counting_step, ckpt=None, cp=cp)
    for _ in range(8):
        for n in range(4):
            cp.record_step_time(n, 0.1 if n != 3 else 0.3)
    assert list(trainer.rate_limits(static_budget=8)) == [8, 8, 8, 4]
    program = trainer.handle_link_failure(step=4, direction=1)
    assert program is not None
    assert trainer.events == [FailureEvent(-1, 4, kind="link_lost",
                                           direction=1)]


def test_failure_without_checkpoint_raises(tmp_path):
    trainer = ElasticTrainer(step_fn=counting_step,
                             ckpt=CheckpointManager(tmp_path), ckpt_every=100)
    with pytest.raises(RuntimeError, match="no checkpoint"):
        trainer.run({"x": torch.tensor(0.0)}, batches(torch.tensor),
                    num_steps=10, failure_schedule={3: 0})


@functools.lru_cache(maxsize=None)
def example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_example_runs_on_cpu(capsys):
    """The example at its own size: the moments in a 4-node store, node 2
    lost at step 35, restored from step 20; the loss falls and no page is
    homed on node 2 afterwards (the example asserts both)."""
    history, events = example().main(["--device", "cpu"])
    assert [(e.kind, e.node, e.at_step) for e in events] == [
        ("node_lost", 2, 35), ("restored", 2, 20)]
    assert len(history) == 75
    assert "OK: trained through a node failure" in capsys.readouterr().out
