"""The port's N-node bridge against the JAX fused engine on 8 CPU devices.

Runs JAX ``bridge.pull_pages`` / ``push_pages`` (``fused=True``) on a real
8-device mesh with the "a2a" exchange lowering forced (the TPU's lowering,
whose commit goes through ``bridge_gather.pull_commit`` / ``push_commit``),
with the bidirectional and the hierarchical route program at channels 2,
throttled per node and not, and holds the port's one-device N-node engine
(its plain versions, on the CPU) to the same pages, bit for bit.

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

from repro.core import bridge as jbridge  # noqa: E402
from repro.core import steering as jsteer  # noqa: E402
from repro.core.memport import MemPortTable as JTable  # noqa: E402
from repro.core.topology import Topology as JTopo  # noqa: E402

from repro_torch.core import bridge as tbridge  # noqa: E402
from repro_torch.core import steering as tsteer  # noqa: E402
from repro_torch.core.memport import MemPortTable as TTable  # noqa: E402
from repro_torch.core.topology import Topology as TTopo  # noqa: E402


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
    budgets = {"full": None, "throttled": np.array([3, 1, 2, 3, 0, 2, 1, 3],
                                                   np.int32)}
    with jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh:
        for pname, (jprog, tprog) in programs.items():
            for bname, ab in budgets.items():
                kw = dict(budget=budget, channels=channels)
                jab = None if ab is None else jnp.asarray(ab)
                tab = None if ab is None else torch.from_numpy(ab)
                got = tbridge.pull_pages(
                    torch.from_numpy(pool), torch.from_numpy(want), ttable,
                    num_nodes=n, program=tprog, active_budget=tab, **kw)
                exp = jbridge.pull_pages(
                    jnp.asarray(pool), jnp.asarray(want), jtable, mesh=mesh,
                    program=jprog, active_budget=jab, fused=True, **kw)
                np.testing.assert_array_equal(got.numpy(), np.asarray(exp),
                                              err_msg=f"pull {pname} {bname}")
                print(f"ok: pull {pname} {bname}")
                got = tbridge.push_pages(
                    torch.from_numpy(pool.copy()), torch.from_numpy(dest),
                    torch.from_numpy(payload), ttable, num_nodes=n,
                    program=tprog, active_budget=tab, **kw)
                exp = jbridge.push_pages(
                    jnp.asarray(pool), jnp.asarray(dest),
                    jnp.asarray(payload), jtable, mesh=mesh, program=jprog,
                    active_budget=jab, fused=True, **kw)
                np.testing.assert_array_equal(got.numpy(), np.asarray(exp),
                                              err_msg=f"push {pname} {bname}")
                print(f"ok: push {pname} {bname}")
    print("ALL OK")


if __name__ == "__main__":
    main()
