"""Port parity of the loopback path's ``table_nodes``.

On one device the pool may model ``table_nodes`` logical memory nodes,
node-major: request row i is logical requester i, a route program for
``table_nodes`` nodes drops what it does not wire, and the counters classify
each row's requests on that logical ring.  The port's ``pull_pages`` /
``push_pages`` (``num_nodes=1, table_nodes=tn``) against the JAX package's
(``mesh=None, table_nodes=tn``), pages and every counter bit for bit, for
tn in {2, 4, 8} under the unidirectional, pruned, link-avoiding and
hierarchical programs (and none), unthrottled and throttled with a tenant
lane; then the port's ``pull_pages_ref`` / ``push_pages_ref`` against the
JAX ones, request rows other than ``tn``, and the ``ValueError`` cases.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bridge as jbridge
from repro.core import ref as jref
from repro.core import steering as js
from repro.core.topology import Topology as JTopo

from repro_torch.core import bridge as tbridge
from repro_torch.core import ref as tref
from repro_torch.core import steering as ts
from repro_torch.core.topology import Topology as TTopo

from test_torch_bridge_nnode import random_table, to_torch
from test_torch_telemetry import assert_counters_equal

PAGE = (2, 3)
BUDGET = 4
MAX_TENANTS = 3


def programs(tn):
    """(JAX program, port program, JAX topology, port topology) by name."""
    sizes = [tn // 2, tn - tn // 2]
    jbi = js.bidirectional_program(tn)
    tbi = ts.bidirectional_program(tn, device="cpu")
    live = [1, tn - 1] if tn > 2 else [1]
    return {
        "none": (None, None, None, None),
        "uni": (js.unidirectional_program(tn),
                ts.unidirectional_program(tn, device="cpu"), None, None),
        "pruned": (js.pruned_program(jbi, live),
                   ts.pruned_program(tbi, live), None, None),
        "link": (js.link_avoiding_program(tn, -1),
                 ts.link_avoiding_program(tn, -1, device="cpu"), None, None),
        "hier": (js.hierarchical_program(JTopo.from_sizes(sizes)),
                 ts.hierarchical_program(TTopo.from_sizes(sizes),
                                         device="cpu"),
                 JTopo.from_sizes(sizes), TTopo.from_sizes(sizes)),
    }


def case(seed, tn, rows, r=11, ppn=5):
    rng = np.random.default_rng(seed)
    num_logical = tn * ppn - 2
    jtable, ttable = random_table(rng, num_logical, tn, ppn)
    want = rng.integers(-1, num_logical, size=(rows, r)).astype(np.int32)
    tenants = rng.integers(-1, MAX_TENANTS + 1,
                           size=(rows, r)).astype(np.int32)
    pool = rng.standard_normal((tn * ppn,) + PAGE).astype(np.float32)
    payload = rng.standard_normal((rows, r) + PAGE).astype(np.float32)
    return rng, jtable, ttable, want, tenants, pool, payload


@functools.lru_cache(maxsize=None)
def jax_transfer(op, tn, topo_sizes, masked):
    """The JAX loopback ``pull_pages`` / ``push_pages`` with counters,
    jitted once per node count, fabric and program presence (the program,
    budget and tenant lane are runtime inputs; eager dispatch would compile
    every op per shape)."""
    topo = None if topo_sizes is None else JTopo.from_sizes(topo_sizes)
    fn = jbridge.pull_pages if op == "pull" else jbridge.push_pages
    kw = dict(mesh=None, budget=BUDGET, table_nodes=tn, topology=topo,
              collect_telemetry=True, max_tenants=MAX_TENANTS)
    if masked:
        return jax.jit(functools.partial(fn, **kw))
    return jax.jit(lambda *a, program, **k: fn(*a, **kw, **k))


def both(jtable, ttable, tn, jprog, tprog, jtopo, ttopo, pool, want,
         payload, *, active=None, tenants=None):
    """Pull then push through both packages; the port's pages, pool and
    counters held to the JAX ones.  Returns the port's counters."""
    sizes = None if jtopo is None else tuple(jtopo.group_sizes.tolist())
    lane = np.zeros_like(want) if tenants is None else tenants
    jkw = dict(program=jprog,
               active_budget=jnp.int32(BUDGET if active is None else active))
    tkw = dict(budget=BUDGET, table_nodes=tn, program=tprog, topology=ttopo,
               collect_telemetry=True, max_tenants=MAX_TENANTS,
               active_budget=active)
    j_pages, j_pull = jax_transfer("pull", tn, sizes, jprog is not None)(
        jnp.asarray(pool), jnp.asarray(want), jtable,
        tenant_ids=jnp.asarray(lane), **jkw)
    t_pages, t_pull = tbridge.pull_pages(
        to_torch(pool), to_torch(want), ttable,
        tenant_ids=None if tenants is None else to_torch(tenants), **tkw)
    assert np.array_equal(t_pages.numpy(), np.asarray(j_pages))
    assert_counters_equal(t_pull, j_pull, "pull")
    j_pool, j_push = jax_transfer("push", tn, sizes, jprog is not None)(
        jnp.asarray(pool), jnp.asarray(want), jnp.asarray(payload), jtable,
        tenant_ids=jnp.asarray(np.zeros_like(want)), **jkw)
    t_pool, t_push = tbridge.push_pages(
        to_torch(pool), to_torch(want), to_torch(payload), ttable, **tkw)
    assert np.array_equal(t_pool.numpy(), np.asarray(j_pool))
    assert_counters_equal(t_push, j_push, "push")
    return t_pages, t_pull, t_pool


@pytest.mark.parametrize("kind", ["none", "uni", "pruned", "link", "hier"])
@pytest.mark.parametrize("tn", [2, 4, 8])
def test_loopback_table_nodes_matches_reference(tn, kind):
    """Unthrottled without a program, throttled (one active budget for
    every row) with a tenant lane under each program: pages, pool and
    counters bit for bit; the counters also equal the port's host oracle on
    the logical ring."""
    _, jtable, ttable, want, tenants, pool, payload = case(tn * 10 + len(kind),
                                                           tn, tn)
    jprog, tprog, jtopo, ttopo = programs(tn)[kind]
    active, lane = (None, None) if kind == "none" else (2, tenants)
    _, t_pull, _ = both(jtable, ttable, tn, jprog, tprog, jtopo, ttopo,
                        pool, want, payload, active=active, tenants=lane)
    assert_counters_equal(t_pull, tref.expected_transfer_telemetry(
        to_torch(want), ttable, tprog, num_nodes=tn, budget=BUDGET,
        active_budget=active, topology=ttopo, tenant_ids=lane,
        max_tenants=MAX_TENANTS), "oracle")


@pytest.mark.parametrize("tn", [2, 4, 8])
def test_loopback_table_nodes_oracles_match_reference(tn):
    """The port's ``pull_pages_ref`` / ``push_pages_ref`` against the JAX
    ones and against the loopback bridge, with and without a program; the
    writes hit distinct pages (a bridge push has one writer a page)."""
    rng, jtable, ttable, want, _, pool, pay = case(100 + tn, tn, tn)
    ppn = pool.shape[0] // tn
    # distinct pages, FREE holes between them
    ids = rng.permutation(tn * ppn - 2)[:(want.size + 1) // 2]
    dest = np.full(want.size, -1, np.int32)
    dest[:2 * ids.size:2] = ids
    dest = dest.reshape(want.shape)
    jpull = jax.jit(jref.pull_pages_ref, static_argnums=3)
    jpush = jax.jit(jref.push_pages_ref, static_argnums=4)
    for name in ("none", "pruned", "hier"):
        jprog, tprog, _, _ = programs(tn)[name]
        got = tref.pull_pages_ref(to_torch(pool), to_torch(want), ttable, ppn,
                                  tprog)
        assert np.array_equal(got.numpy(), np.asarray(jpull(
            jnp.asarray(pool), jnp.asarray(want), jtable, ppn, jprog)))
        assert torch.equal(got, tbridge.pull_pages(
            to_torch(pool), to_torch(want), ttable, budget=BUDGET,
            table_nodes=tn, program=tprog))
        got = tref.push_pages_ref(to_torch(pool), to_torch(dest),
                                  to_torch(pay), ttable, ppn, tprog)
        assert np.array_equal(got.numpy(), np.asarray(jpush(
            jnp.asarray(pool), jnp.asarray(dest), jnp.asarray(pay), jtable,
            ppn, jprog)))
        assert torch.equal(got, tbridge.push_pages(
            to_torch(pool), to_torch(dest), to_torch(pay), ttable,
            budget=BUDGET, table_nodes=tn, program=tprog))


def test_push_pages_ref_later_write_wins():
    """Two writes to one page: the later one in row-major order lands."""
    _, _, ttable, _, _, pool, _ = case(7, 2, 2)
    dest = torch.tensor([[3, 4], [3, -1]], dtype=torch.int32)
    pay = torch.arange(4 * 6, dtype=torch.float32).view((2, 2) + PAGE)
    got = tref.push_pages_ref(to_torch(pool), dest, pay, ttable,
                              pool.shape[0] // 2)
    row = int(tref.flat_index(ttable, torch.tensor([3]), pool.shape[0] // 2))
    if row >= 0:
        assert torch.equal(got[row], pay[1, 0])


@pytest.mark.parametrize("tn,rows", [(2, 3)])
def test_loopback_rows_other_than_table_nodes(tn, rows):
    """More request rows than logical nodes: a row past the last rank reads
    that rank's program and fabric tables."""
    _, jtable, ttable, want, tenants, pool, payload = case(tn + rows, tn,
                                                           rows)
    jprog, tprog, jtopo, ttopo = programs(tn)["hier"]
    both(jtable, ttable, tn, jprog, tprog, jtopo, ttopo, pool, want, payload,
         active=3, tenants=tenants)


def test_table_nodes_refusals():
    """A program for another node count, and ``table_nodes`` other than the
    N-node engine's node count, raise as in the reference."""
    _, _, ttable, want, _, pool, payload = case(3, 4, 4)
    prog3 = ts.bidirectional_program(3, device="cpu")
    with pytest.raises(ValueError, match="slots"):
        tbridge.pull_pages(to_torch(pool), to_torch(want), ttable,
                           table_nodes=4, program=prog3)
    with pytest.raises(ValueError, match="slots"):
        tbridge.push_pages(to_torch(pool), to_torch(want), to_torch(payload),
                           ttable, table_nodes=4, program=prog3)
    with pytest.raises(ValueError, match="table has 2 nodes"):
        tbridge.pull_pages(to_torch(pool), to_torch(want), ttable,
                           num_nodes=4, table_nodes=2)
    with pytest.raises(ValueError, match="table has 8 nodes"):
        tbridge.push_pages(to_torch(pool), to_torch(want), to_torch(payload),
                           ttable, num_nodes=4, table_nodes=8)
    with pytest.raises(ValueError, match="topology spans"):
        tbridge.pull_pages(to_torch(pool), to_torch(want), ttable,
                           table_nodes=4, collect_telemetry=True,
                           topology=TTopo.flat(3))
