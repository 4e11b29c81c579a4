"""Port parity of the in-band telemetry (the measurement plane).

The counters of the port's ``pull_pages`` / ``push_pages`` against the JAX
package's oracle ``ref.expected_transfer_telemetry`` and the port's own copy
of it (``repro_torch.core.ref``), bit for bit: on the loopback path (also
against JAX's own loopback counters) and on N in {2, 3, 5, 8} nodes, under
every route-program constructor, random tables with unmapped pages,
throttled ``active_budget`` and ``overprovision`` 1 and 2, tenant lanes
with ids outside ``[0, max_tenants)``, and channels 1 and 2 (the pages are
held to the reference's pipelined oracles at the same time).  Then
``pair_hops_device``, the aggregators, and ``kvbridge.append`` /
``decode_attention_pull`` with telemetry against the JAX ones.  Counters
compare exactly; attention outputs at float32 1e-5.
"""
from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bridge as jbridge
from repro.core import kvbridge as jkv
from repro.core import ref as jref
from repro.core.memport import MemPortTable as JTable
from repro.core.topology import Topology as JTopo, pair_hops_device as jhops
from repro.telemetry import counters as jcounters
from repro.telemetry.aggregate import TelemetryAggregator as JAgg

from repro_torch.core import bridge as tbridge
from repro_torch.core import kvbridge as tkv
from repro_torch.core import ref as tref
from repro_torch.core.memport import MemPortTable as TTable
from repro_torch.core.topology import Topology as TTopo, pair_hops_device
from repro_torch.telemetry import counters as tcounters
from repro_torch.telemetry.aggregate import TelemetryAggregator as TAgg

from test_torch_bridge_nnode import (program_variants, random_table, to_numpy,
                                     to_torch)

PAGE = (2, 3)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)


def assert_counters_equal(got, want, msg=""):
    """Every field equal in shape and value, int32 on the port's side."""
    for f in fields(jcounters.BridgeTelemetry):
        g = getattr(got, f.name)
        if torch.is_tensor(g):
            assert g.dtype == torch.int32, (msg, f.name, g.dtype)
            g = g.numpy()
        w = np.asarray(getattr(want, f.name))
        assert g.shape == w.shape and np.array_equal(g, w), (
            msg, f.name, g, w)


def topologies(n):
    """The flat fabric, and the two-board one the hierarchical program of
    ``program_variants`` is compiled for."""
    sizes = [n // 2, n - n // 2] if n > 2 else [1, 1]
    return {"flat": (None, None),
            "boards": (JTopo.from_sizes(sizes), TTopo.from_sizes(sizes))}


def oracles(ids, jtable, ttable, jprog, tprog, **kw):
    """The JAX oracle, held equal to the port's copy of it."""
    jtopo, ttopo = kw.pop("topologies")
    want = jref.expected_transfer_telemetry(ids, jtable, jprog,
                                            topology=jtopo, **kw)
    mine = tref.expected_transfer_telemetry(ids, ttable, tprog,
                                            topology=ttopo, **kw)
    assert_counters_equal(mine, want, "port oracle")
    return want


# ---------------------------------------------------------------------------
# The N-node engine's counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_nnode_counters_match_oracle(n, channels):
    rng = np.random.default_rng(100 * n + channels)
    ppn, budget, r, max_tenants = 6, 4, 10, 3
    num_logical = n * ppn - 2
    jtable, ttable = random_table(rng, num_logical, n, ppn)
    want = rng.integers(-1, num_logical, size=(n, r)).astype(np.int32)
    tenants = rng.integers(-2, max_tenants + 2, size=(n, r)).astype(np.int32)
    pool = rng.standard_normal((n * ppn,) + PAGE).astype(np.float32)
    payload = rng.standard_normal((n, r) + PAGE).astype(np.float32)
    dest = rng.permutation(num_logical)[:n * r // 2].reshape(n, r // 2)
    dest = dest.astype(np.int32)
    ab = rng.integers(0, budget, size=n).astype(np.int32)
    for tname, topos in topologies(n).items():
        for pname, jprog, tprog in program_variants(n):
            if pname == "hier" and tname == "flat":
                continue        # a hierarchical program needs its boards
            for ov, active in ((1, None), (1, ab), (2, ab)):
                tab = None if active is None else to_torch(active)
                kw = dict(num_nodes=n, budget=budget, channels=channels,
                          overprovision=ov, active_budget=tab,
                          program=tprog, collect_telemetry=True,
                          topology=topos[1], max_tenants=max_tenants)
                got, telem = tbridge.pull_pages(
                    to_torch(pool), to_torch(want), ttable,
                    tenant_ids=to_torch(tenants), **kw)
                exp = jref.pull_pages_pipelined_ref(
                    jnp.asarray(pool), jnp.asarray(want), jtable, ppn, jprog,
                    budget=budget, channels=channels, active_budget=active,
                    overprovision=ov)
                assert np.array_equal(got.numpy(), np.asarray(exp))
                okw = dict(num_nodes=n, budget=budget, active_budget=active,
                           overprovision=ov, topologies=topos)
                assert_counters_equal(telem, oracles(
                    want, jtable, ttable, jprog, tprog, tenant_ids=tenants,
                    max_tenants=max_tenants, **okw), (tname, pname, ov))
                assert np.array_equal(telem.tenant_served.sum(-1).numpy(),
                                      telem.served_total().numpy())
                pool_t = to_torch(pool)
                got, telem = tbridge.push_pages(
                    pool_t, to_torch(dest), to_torch(payload[:, :r // 2]),
                    ttable, **kw)
                exp = jref.push_pages_pipelined_ref(
                    jnp.asarray(pool), jnp.asarray(dest),
                    jnp.asarray(payload[:, :r // 2]), jtable, ppn, jprog,
                    budget=budget, channels=channels, active_budget=active,
                    overprovision=ov)
                assert got is pool_t and np.array_equal(got.numpy(),
                                                        np.asarray(exp))
                assert_counters_equal(telem, oracles(
                    dest, jtable, ttable, jprog, tprog,
                    max_tenants=max_tenants, **okw), (tname, pname, "push"))


def test_default_tenant_width_and_lane():
    """``max_tenants=0`` is the default width; no lane is all tenant 0."""
    n, ppn = 4, 3
    rng = np.random.default_rng(3)
    jtable, ttable = random_table(rng, n * ppn, n, ppn, unmapped=0.0)
    want = rng.integers(-1, n * ppn, size=(n, 5)).astype(np.int32)
    _, telem = tbridge.pull_pages(torch.zeros((n * ppn,) + PAGE),
                                  to_torch(want), ttable, num_nodes=n,
                                  collect_telemetry=True)
    assert telem.max_tenants == jcounters.DEFAULT_MAX_TENANTS
    assert telem.num_nodes == n
    exp = jref.expected_transfer_telemetry(want, jtable, None, num_nodes=n,
                                           budget=8)
    assert_counters_equal(telem, exp)
    assert telem.tenant_served[:, 1:].sum() == 0


@pytest.mark.parametrize("n", [1, 3, 8])
def test_oracle_helpers_match_reference(n):
    """The port's copies of ``flat_index``, ``served_mask`` (no program,
    and every program on N nodes) and ``rate_limit_mask``."""
    rng = np.random.default_rng(40 + n)
    ppn = 5
    jtable, ttable = random_table(rng, n * ppn - 1, n, ppn)
    ids = rng.integers(-1, n * ppn - 1, size=(n, 9)).astype(np.int32)
    assert np.array_equal(
        tref.flat_index(ttable, to_torch(ids), ppn).numpy(),
        np.asarray(jref.flat_index(jtable, jnp.asarray(ids), ppn)))
    programs = [(None, None)] + ([(j, t) for _, j, t in program_variants(n)]
                                 if n > 1 else [])
    for jprog, tprog in programs:
        assert np.array_equal(
            tref.served_mask(ttable, to_torch(ids), tprog).numpy(),
            np.asarray(jref.served_mask(jtable, jnp.asarray(ids), jprog)))
    for r, budget, ab, ov in ((0, 4, 2, 1), (11, 4, 3, 1), (11, 4, 1, 2),
                              (9, 3, np.array([5, 1]), 1)):
        assert np.array_equal(tref.rate_limit_mask(r, budget, ab, ov),
                              jref.rate_limit_mask(r, budget, ab, ov))


# ---------------------------------------------------------------------------
# The loopback path's counters
# ---------------------------------------------------------------------------

def loopback_table(rng, num_logical):
    home = np.where(rng.random(num_logical) < 0.15, -1, 0).astype(np.int32)
    slot = rng.permutation(num_logical).astype(np.int32)
    return (JTable(home=jnp.asarray(home), slot=jnp.asarray(slot)),
            TTable(home=torch.from_numpy(home), slot=torch.from_numpy(slot)))


@pytest.mark.parametrize("rows,ov,active", [(1, 1, None), (3, 1, 2),
                                            (4, 2, 1), (2, 2, 3)])
def test_loopback_counters_match_reference(rows, ov, active):
    """Row i of the request list is logical requester i on a one-node
    ring: the port's counters against JAX's own loopback counters
    (``mesh=None``) and both oracles, pull and push."""
    rng = np.random.default_rng(rows * 7 + ov)
    num_logical, budget, r, mt = 24, 4, 9, 2
    jtable, ttable = loopback_table(rng, num_logical)
    want = rng.integers(-1, num_logical, size=(rows, r)).astype(np.int32)
    tenants = rng.integers(-1, mt + 2, size=(rows, r)).astype(np.int32)
    pool = rng.standard_normal((num_logical,) + PAGE).astype(np.float32)
    jkw = dict(budget=budget, overprovision=ov, collect_telemetry=True,
               max_tenants=mt,
               active_budget=None if active is None else jnp.int32(active))
    tkw = dict(budget=budget, overprovision=ov, collect_telemetry=True,
               max_tenants=mt, active_budget=active)
    j_pages, j_telem = jbridge.pull_pages(
        jnp.asarray(pool), jnp.asarray(want), jtable, mesh=None,
        tenant_ids=jnp.asarray(tenants), **jkw)
    t_pages, t_telem = tbridge.pull_pages(
        to_torch(pool), to_torch(want), ttable,
        tenant_ids=to_torch(tenants), **tkw)
    assert np.array_equal(t_pages.numpy(), np.asarray(j_pages))
    assert_counters_equal(t_telem, j_telem, "pull")
    assert_counters_equal(t_telem, oracles(
        want, jtable, ttable, None, None, num_nodes=1, budget=budget,
        active_budget=active, overprovision=ov, tenant_ids=tenants,
        max_tenants=mt, topologies=(None, None)))
    payload = rng.standard_normal((rows, r) + PAGE).astype(np.float32)
    j_pool, j_telem = jbridge.push_pages(
        jnp.asarray(pool), jnp.asarray(want), jnp.asarray(payload), jtable,
        mesh=None, **jkw)
    t_pool, t_telem = tbridge.push_pages(
        to_torch(pool), to_torch(want), to_torch(payload), ttable, **tkw)
    assert np.array_equal(t_pool.numpy(), np.asarray(j_pool))
    assert_counters_equal(t_telem, j_telem, "push")


# ---------------------------------------------------------------------------
# Topology tables, the aggregator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [[5], [2, 2], [1, 3, 2], [4, 4]])
def test_pair_hops_device_matches_host_and_reference(sizes):
    """The device tables, ``pair_hops_device`` and the pair table the
    counters read, against the host ``pair_hops`` and the JAX mirror."""
    jt, tt = JTopo.from_sizes(sizes), TTopo.from_sizes(sizes)
    n = tt.num_nodes
    tables = tt.tables("cpu")
    assert tables is tt.tables("cpu")            # made once per device
    jtables = jt.tables()
    for f in ("group", "local_rank", "group_size"):
        assert np.array_equal(getattr(tables, f).numpy(),
                              np.asarray(getattr(jtables, f)))
    req, home = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pairs = tt.pair_table("cpu")                 # what the counters read
    assert pairs is tt.pair_table("cpu")
    for side, sign in enumerate((1, -1)):
        sg = np.full(home.shape, sign)
        hb, hr = tt.pair_hops(req, home, sign)
        assert np.array_equal(pairs[side].numpy(), np.stack(
            [tt.pair_intra(req, home), hb, hr], -1))
        intra, board, rack = pair_hops_device(
            tables, tt.num_groups, torch.from_numpy(req),
            torch.from_numpy(home), torch.from_numpy(sg))
        hb, hr = tt.pair_hops(req, home, sign)
        assert np.array_equal(board.numpy(), hb)
        assert np.array_equal(rack.numpy(), hr)
        assert np.array_equal(intra.numpy(), tt.pair_intra(req, home))
        for i in range(n):
            ji, jb, jr = jhops(jtables, jt.num_groups, i,
                               jnp.asarray(home[i]), jnp.asarray(sg[i]))
            ti, tb, tr = pair_hops_device(tables, tt.num_groups, i,
                                          torch.from_numpy(home[i]),
                                          torch.from_numpy(sg[i]))
            for a, b in ((ti, ji), (tb, jb), (tr, jr)):
                assert np.array_equal(a.numpy(), np.asarray(b))


def test_aggregators_agree():
    """Both aggregators fed the same counter sequence (the N-node pulls
    of a few random transfers, and idle steps) give equal views and the
    same ``describe()``."""
    n, ppn, mt = 5, 4, 3
    rng = np.random.default_rng(9)
    jtable, ttable = random_table(rng, n * ppn, n, ppn)
    _, jprog, tprog = program_variants(n)[5]          # hierarchical
    jtopo, ttopo = topologies(n)["boards"]
    j_agg = JAgg(n, page_bytes=96, alpha=0.5, max_tenants=mt)
    t_agg = TAgg(n, page_bytes=96, alpha=0.5, max_tenants=mt)
    for step in range(4):
        want = rng.integers(-1, n * ppn, size=(n, 7)).astype(np.int32)
        ten = rng.integers(0, mt, size=(n, 7)).astype(np.int32)
        ab = rng.integers(1, 4, size=n).astype(np.int32)
        _, telem = tbridge.pull_pages(
            torch.zeros((n * ppn,) + PAGE), to_torch(want), ttable,
            num_nodes=n, budget=3, active_budget=to_torch(ab),
            program=tprog, collect_telemetry=True, topology=ttopo,
            tenant_ids=to_torch(ten), max_tenants=mt)
        if step == 2:
            telem = tcounters.zeros(n, (n,), mt, device="cpu")
        t_agg.update(telem)
        j_agg.update(jcounters.BridgeTelemetry(
            *(jnp.asarray(getattr(telem, f.name).numpy())
              for f in fields(telem))))
    assert t_agg.describe() == j_agg.describe()
    for view in ("traffic_matrix", "distance_pages", "distance_intra_pages",
                 "link_pages", "link_utilization", "epoch_occupancy",
                 "tier_pages", "tier_hops", "tier_utilization",
                 "tenant_pages", "tenant_demand", "tenant_spill_rate",
                 "spill_rate", "drop_rate", "live_distances",
                 "traffic_bytes", "distance_bytes", "tenant_bytes"):
        t_v, j_v = getattr(t_agg, view)(), getattr(j_agg, view)()
        np.testing.assert_equal(t_v, j_v, err_msg=view)
    assert t_agg.dominant_requester(2) == j_agg.dominant_requester(2)
    with pytest.raises(ValueError, match="tenants"):
        TAgg(n, max_tenants=mt + 1).update(telem)


# ---------------------------------------------------------------------------
# The paged KV cache with telemetry (one node)
# ---------------------------------------------------------------------------

def test_kvbridge_telemetry_matches_reference():
    """Append and pull with telemetry on the loopback path, against the JAX
    kvbridge: the same pools, attention within 1e-5 and the same counters
    (k and v summed each round, rounds summed in order), tenants b % 2."""
    rng = np.random.default_rng(21)
    b, t, kv, hd, h, max_len, budget = 3, 4, 2, 8, 4, 16, 4
    max_pages = max_len // t
    slots = b * max_pages
    jtable = JTable.striped(slots, 1, slots)
    ttable = TTable.striped(slots, 1, slots, device="cpu")
    zeros = np.zeros((slots, t, kv, hd), np.float32)
    tails = np.zeros((b, t, kv, hd), np.float32)
    j_layer = jkv.PagedKVLayer(*(jnp.asarray(x) for x in (zeros, zeros,
                                                           tails, tails)))
    t_layer = tkv.PagedKVLayer(*(to_torch(x) for x in (zeros, zeros, tails,
                                                        tails)))
    tenants = np.arange(b) % 2
    lengths = np.array([3, 7, 10], np.int32)
    kw = dict(page_tokens=t, max_pages=max_pages, budget=budget,
              collect_telemetry=True, max_tenants=2)
    j_total = t_total = None
    for step in range(4):
        k_new = rng.standard_normal((b, kv, hd)).astype(np.float32)
        v_new = rng.standard_normal((b, kv, hd)).astype(np.float32)
        q = rng.standard_normal((b, h, hd)).astype(np.float32)
        ln = lengths + step
        j_layer, j_app = jkv.append(
            j_layer, jtable, jnp.asarray(ln), jnp.asarray(k_new),
            jnp.asarray(v_new), mesh=None,
            tenant_of_seq=jnp.asarray(tenants), **kw)
        t_layer, t_app = tkv.append(
            t_layer, ttable, torch.from_numpy(ln), torch.from_numpy(k_new),
            torch.from_numpy(v_new),
            tenant_of_seq=torch.from_numpy(tenants), **kw)
        assert_counters_equal(t_app, j_app, f"append {step}")
        j_out, j_pull = jkv.decode_attention_pull(
            jnp.asarray(q), j_layer, jtable, jnp.asarray(ln + 1), mesh=None,
            tenant_of_seq=jnp.asarray(tenants), **kw)
        t_out, t_pull = tkv.decode_attention_pull(
            torch.from_numpy(q), t_layer, ttable, torch.from_numpy(ln + 1),
            tenant_of_seq=torch.from_numpy(tenants), **kw)
        assert_counters_equal(t_pull, j_pull, f"pull {step}")
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                   **ATTN_TOL)
        j_step = jcounters.add(j_app, j_pull)
        j_total = j_step if j_total is None else jcounters.add(j_total,
                                                                j_step)
        t_step = tcounters.add(t_app, t_pull)
        t_total = t_step if t_total is None else tcounters.add(t_total,
                                                                t_step)
    assert np.array_equal(to_numpy(t_layer.k_pool), np.asarray(j_layer.k_pool))
    assert_counters_equal(t_total, j_total, "total")
    assert int(t_total.served_total().sum()) > 0
    assert t_total.tenant_served[0, 1] > 0         # tenant 1 pulled pages
