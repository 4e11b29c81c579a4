"""The port's N-node bridge against the JAX fused engine on 8 CPU devices.

Runs JAX ``bridge.pull_pages`` / ``push_pages`` (``fused=True``) on a real
8-device mesh with the "a2a" exchange lowering forced (the TPU's lowering,
whose commit goes through ``bridge_gather.pull_commit`` / ``push_commit``),
with the bidirectional and the hierarchical route program at channels 2,
throttled per node and not, and holds the port's one-device N-node engine
(its plain versions, on the CPU) to the same pages and the same in-band
counters (``collect_telemetry``, a tenant lane, the program's topology),
bit for bit.  Then it holds the port's 8-node ``decode_attention_push`` to
the JAX one on the mesh, or, where the JAX one fails on this jax, to the
dense oracle (and prints the JAX error).

The device count is fixed before jax initialises, so this runs in its own
process:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fused_a2a_8dev.py

``tests/test_torch_bridge_nnode.py`` runs it and expects ``ALL OK``.
"""
import os

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    + os.environ.get("XLA_FLAGS", ""))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from dataclasses import fields  # noqa: E402

from repro.core import bridge as jbridge  # noqa: E402
from repro.core import kvbridge as jkv  # noqa: E402
from repro.core import steering as jsteer  # noqa: E402
from repro.core.memport import MemPortTable as JTable  # noqa: E402
from repro.core.topology import Topology as JTopo  # noqa: E402

from repro_torch.core import bridge as tbridge  # noqa: E402
from repro_torch.core import kvbridge as tkv  # noqa: E402
from repro_torch.core import steering as tsteer  # noqa: E402
from repro_torch.core.memport import MemPortTable as TTable  # noqa: E402
from repro_torch.core.topology import Topology as TTopo  # noqa: E402


def same_counters(got, want, msg):
    for f in fields(want):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f"{msg} {f.name}")


def push_attention(mesh):
    """The 8-node push attention over a pool striped over 8 nodes: the
    port against the JAX one on the mesh (or the dense oracle)."""
    n, b, t, kv, hd, h, max_pages = 8, 8, 4, 2, 8, 4, 4
    rng = np.random.default_rng(12)
    spn = b * max_pages // n
    table = TTable.striped(b * max_pages, n, spn, device="cpu")
    lengths = np.array([0, 3, 4, 7, 9, 12, 15, 16], np.int32)
    k = rng.normal(size=(b, max_pages * t, kv, hd)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    pools = [np.zeros((n * spn, t, kv, hd), np.float32) for _ in range(2)]
    tails = [np.zeros((b, t, kv, hd), np.float32) for _ in range(2)]
    for seq in range(b):
        for p in range(max_pages):
            h_, s_ = (int(x[seq * max_pages + p]) for x in (table.home,
                                                            table.slot))
            full = p < lengths[seq] // t
            for dense, pool, tail in zip((k, v), pools, tails):
                chunk = dense[seq, p * t:(p + 1) * t]
                if full:
                    pool[h_ * spn + s_] = chunk
                elif p == lengths[seq] // t:
                    n_tail = lengths[seq] - p * t
                    tail[seq, :n_tail] = chunk[:n_tail]
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    got = tkv.decode_attention_push(
        torch.from_numpy(q),
        tkv.PagedKVLayer(*(torch.from_numpy(a) for a in pools + tails)),
        table, torch.from_numpy(lengths), page_tokens=t,
        max_pages=max_pages, num_nodes=n).numpy()
    dense = np.asarray(jkv.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)))
    np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)
    try:
        push = jax.jit(lambda q_, layer, ln: jkv.decode_attention_push(
            q_, layer, JTable.striped(b * max_pages, n, spn), ln,
            page_tokens=t, max_pages=max_pages, mesh=mesh))
        want = np.asarray(push(
            jnp.asarray(q),
            jkv.PagedKVLayer(*(jnp.asarray(a) for a in pools + tails)),
            jnp.asarray(lengths)))
    except Exception as err:  # noqa: BLE001 - the reference's own failure
        print(f"push attention: JAX 8-device decode_attention_push failed "
              f"({type(err).__name__}: {str(err).splitlines()[0][:200]}); "
              f"held to the dense oracle")
        return
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    print("push attention: matches the JAX 8-device decode_attention_push")


def main():
    assert jax.device_count() == 8, jax.devices()
    jbridge._FUSED_EXCHANGE = "a2a"
    mesh = jax.make_mesh((8,), ("data",))
    n, ppn, page, budget, channels = 8, 8, (2, 4), 3, 2
    rng = np.random.default_rng(11)
    pool = rng.normal(size=(n * ppn,) + page).astype(np.float32)
    num_logical = 56
    jtable = JTable.striped(num_logical, n, ppn)
    ttable = TTable.striped(num_logical, n, ppn, device="cpu")
    want = rng.integers(-1, num_logical, size=(n, 7)).astype(np.int32)
    dest = rng.permutation(num_logical)[: n * 5].reshape(n, 5).astype(
        np.int32)
    dest[3, 4] = dest[3, 1]              # a duplicate write within a node
    payload = rng.normal(size=(n, 5) + page).astype(np.float32)
    programs = {
        "bidirectional": (jsteer.bidirectional_program(n),
                          tsteer.bidirectional_program(n, device="cpu")),
        "hierarchical": (jsteer.hierarchical_program(JTopo.boards(2, 4)),
                         tsteer.hierarchical_program(TTopo.boards(2, 4),
                                                     device="cpu")),
    }
    topologies = {"bidirectional": (None, None),
                  "hierarchical": (JTopo.boards(2, 4), TTopo.boards(2, 4))}
    budgets = {"full": None, "throttled": np.array([3, 1, 2, 3, 0, 2, 1, 3],
                                                   np.int32)}
    tenants = rng.integers(-1, 4, size=want.shape).astype(np.int32)
    with jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh:
        for pname, (jprog, tprog) in programs.items():
            for bname, ab in budgets.items():
                jtopo, ttopo = topologies[pname]
                kw = dict(budget=budget, channels=channels,
                          collect_telemetry=True, max_tenants=3)
                jab = None if ab is None else jnp.asarray(ab)
                tab = None if ab is None else torch.from_numpy(ab)
                got, got_t = tbridge.pull_pages(
                    torch.from_numpy(pool), torch.from_numpy(want), ttable,
                    num_nodes=n, program=tprog, active_budget=tab,
                    topology=ttopo, tenant_ids=torch.from_numpy(tenants),
                    **kw)
                # jit: one compile instead of the engine's ops one by one
                exp, exp_t = jax.jit(lambda p_, w_, t_, a_: jbridge.pull_pages(
                    p_, w_, jtable, mesh=mesh, program=jprog,
                    active_budget=a_, topology=jtopo, tenant_ids=t_,
                    fused=True, **kw))(jnp.asarray(pool), jnp.asarray(want),
                                       jnp.asarray(tenants), jab)
                np.testing.assert_array_equal(got.numpy(), np.asarray(exp),
                                              err_msg=f"pull {pname} {bname}")
                same_counters(got_t, exp_t, f"pull {pname} {bname}")
                print(f"ok: pull {pname} {bname} (pages and counters)")
                got, got_t = tbridge.push_pages(
                    torch.from_numpy(pool.copy()), torch.from_numpy(dest),
                    torch.from_numpy(payload), ttable, num_nodes=n,
                    program=tprog, active_budget=tab, topology=ttopo, **kw)
                exp, exp_t = jax.jit(lambda p_, d_, y_, a_: jbridge.push_pages(
                    p_, d_, y_, jtable, mesh=mesh, program=jprog,
                    active_budget=a_, topology=jtopo, fused=True,
                    **kw))(jnp.asarray(pool), jnp.asarray(dest),
                           jnp.asarray(payload), jab)
                np.testing.assert_array_equal(got.numpy(), np.asarray(exp),
                                              err_msg=f"push {pname} {bname}")
                same_counters(got_t, exp_t, f"push {pname} {bname}")
                print(f"ok: push {pname} {bname} (pages and counters)")
        push_attention(mesh)
    print("ALL OK")


if __name__ == "__main__":
    main()
