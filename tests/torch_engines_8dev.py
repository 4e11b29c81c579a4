"""The port's unfused bridge engine against the JAX ones on 8 CPU devices.

Runs JAX ``bridge.pull_pages`` / ``push_pages`` on a real 8-device mesh with
``fused=False`` at channels 1 (the serial engine) and 2 (the pipelined
one), and with ``edge_buffer=False`` at channels 2 (the bufferless bridge,
which runs serial whatever ``channels`` says), under the unidirectional
and the hierarchical route program, throttled per node and not, and holds
the port's one unfused engine (``fused=False`` on the CPU, at the same
``channels``) to the same pages and the same in-band counters
(``collect_telemetry``, a tenant lane, the program's topology), bit for
bit.

The device count is fixed before jax initialises, so this runs in its own
process:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_engines_8dev.py

``tests/test_torch_bridge_engines.py`` runs it and expects ``ALL OK``.
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
from repro.core import steering as jsteer  # noqa: E402
from repro.core.memport import MemPortTable as JTable  # noqa: E402
from repro.core.topology import Topology as JTopo  # noqa: E402

from repro_torch.core import bridge as tbridge  # noqa: E402
from repro_torch.core import steering as tsteer  # noqa: E402
from repro_torch.core.memport import MemPortTable as TTable  # noqa: E402
from repro_torch.core.topology import Topology as TTopo  # noqa: E402

# (name, the reference's engine knobs, the port's): a bufferless bridge is
# the port's unfused engine
ENGINES = [("serial", dict(fused=False, channels=1),
            dict(fused=False, channels=1)),
           ("pipelined", dict(fused=False, channels=2),
            dict(fused=False, channels=2)),
           ("bufferless", dict(edge_buffer=False, channels=2),
            dict(fused=False, channels=2))]


def same_counters(got, want, msg):
    for f in fields(want):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f"{msg} {f.name}")


def main():
    assert jax.device_count() == 8, jax.devices()
    torch.set_num_threads(1)
    mesh = jax.make_mesh((8,), ("data",))
    n, ppn, page, budget = 8, 8, (2, 4), 3
    rng = np.random.default_rng(21)
    pool = rng.normal(size=(n * ppn,) + page).astype(np.float32)
    pool[rng.random(pool.shape) < 0.05] = -0.0
    num_logical = 60
    flat = rng.permutation(n * ppn)[:num_logical]
    home, slot = (flat // ppn).astype(np.int32), (flat % ppn).astype(np.int32)
    home[[3, 17]] = slot[[3, 17]] = -1                  # unmapped pages
    jtable = JTable(home=jnp.asarray(home), slot=jnp.asarray(slot))
    ttable = TTable(home=torch.from_numpy(home), slot=torch.from_numpy(slot))
    want = rng.integers(-1, num_logical, size=(n, 7)).astype(np.int32)
    dest = rng.permutation(num_logical)[: n * 5].reshape(n, 5).astype(
        np.int32)
    dest[3, 4] = dest[3, 1]              # a duplicate write within a node
    payload = rng.normal(size=(n, 5) + page).astype(np.float32)
    programs = {
        "unidirectional": (jsteer.unidirectional_program(n),
                           tsteer.unidirectional_program(n, device="cpu")),
        "hierarchical": (jsteer.hierarchical_program(JTopo.boards(2, 4)),
                         tsteer.hierarchical_program(TTopo.boards(2, 4),
                                                     device="cpu")),
    }
    topologies = {"unidirectional": (None, None),
                  "hierarchical": (JTopo.boards(2, 4), TTopo.boards(2, 4))}
    ab = np.array([3, 1, 2, 3, 0, 2, 1, 3], np.int32)
    tenants = rng.integers(-1, 4, size=want.shape).astype(np.int32)
    tel = dict(budget=budget, collect_telemetry=True, max_tenants=3)
    with jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh:
        for ename, knobs, tknobs in ENGINES:
            # one compile per engine and program: the rate limiter and the
            # tenant lane are runtime inputs
            for pname, (jprog, tprog) in programs.items():
                jtopo, ttopo = topologies[pname]
                kw, tkw = dict(tel, **knobs), dict(tel, **tknobs)
                pull = jax.jit(lambda p_, w_, t_, a_: jbridge.pull_pages(
                    p_, w_, jtable, mesh=mesh, program=jprog,
                    active_budget=a_, topology=jtopo, tenant_ids=t_, **kw))
                push = jax.jit(lambda p_, d_, y_, a_: jbridge.push_pages(
                    p_, d_, y_, jtable, mesh=mesh, program=jprog,
                    active_budget=a_, topology=jtopo, **kw))
                for bname, a in (("full", np.full(n, budget, np.int32)),
                                 ("throttled", ab)):
                    label = f"{ename} {pname} {bname}"
                    got, got_t = tbridge.pull_pages(
                        torch.from_numpy(pool), torch.from_numpy(want),
                        ttable, num_nodes=n, program=tprog,
                        active_budget=torch.from_numpy(a), topology=ttopo,
                        tenant_ids=torch.from_numpy(tenants), **tkw)
                    exp, exp_t = pull(jnp.asarray(pool), jnp.asarray(want),
                                      jnp.asarray(tenants), jnp.asarray(a))
                    np.testing.assert_array_equal(
                        got.numpy().view(np.int32),
                        np.asarray(exp).view(np.int32),
                        err_msg=f"pull {label}")
                    same_counters(got_t, exp_t, f"pull {label}")
                    got, got_t = tbridge.push_pages(
                        torch.from_numpy(pool.copy()), torch.from_numpy(dest),
                        torch.from_numpy(payload), ttable, num_nodes=n,
                        program=tprog, active_budget=torch.from_numpy(a),
                        topology=ttopo, **tkw)
                    exp, exp_t = push(jnp.asarray(pool), jnp.asarray(dest),
                                      jnp.asarray(payload), jnp.asarray(a))
                    np.testing.assert_array_equal(
                        got.numpy().view(np.int32),
                        np.asarray(exp).view(np.int32),
                        err_msg=f"push {label}")
                    same_counters(got_t, exp_t, f"push {label}")
                    print(f"ok: {label} (pull and push, pages and counters)")
    print("ALL OK")


if __name__ == "__main__":
    main()
