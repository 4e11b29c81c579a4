"""Port parity of the static route-program verifier.

The port's ``check_program`` / ``check_transfer_window`` /
``verify_program`` against the JAX package's: the same findings (rule ids,
severities, messages, loci) on every program constructor, on hand-broken
programs (one per rule) and on random arrays, on a flat and a two-board
fabric, with and without a required serve set.  The port's ``coverage``
equals the port's own runtime oracle ``core/ref.served_mask`` on every
(requester, home) pair, as the reference's property suite asserts for the
JAX pair.
"""
import numpy as np
import pytest
import torch

from repro.analysis import program_check as jpc
from repro.analysis.findings import ProgramVerificationError as JError
from repro.core import steering as js
from repro.core.topology import Topology as JTopo

from repro_torch.analysis import program_check as tpc
from repro_torch.analysis.findings import ProgramVerificationError
from repro_torch.core import ref as tref
from repro_torch.core import steering as ts
from repro_torch.core.memport import MemPortTable
from repro_torch.core.topology import Topology as TTopo

from test_torch_bridge_nnode import program_variants


def pair(off, epoch, live, rank_epoch):
    """The same four arrays as a JAX and a port RouteProgram."""
    arrays = [np.asarray(a) for a in (off, epoch, live, rank_epoch)]
    j = js.RouteProgram(offsets=arrays[0].astype(np.int32),
                        epoch=arrays[1].astype(np.int32),
                        live=arrays[2].astype(bool),
                        rank_epoch=arrays[3].astype(np.int32))
    t = ts.RouteProgram(*(torch.from_numpy(a.astype(np.int32))
                          for a in (arrays[0], arrays[1])),
                        torch.from_numpy(arrays[2].astype(bool)),
                        torch.from_numpy(arrays[3].astype(np.int32)))
    return j, t


def arrays(prog):
    return [np.asarray(getattr(prog, f)).copy()
            for f in ("offsets", "epoch", "live", "rank_epoch")]


def broken_programs(n):
    """One hand-broken program per rule, from the bidirectional and the
    hierarchical schedules of an n-node ring."""
    bi = arrays(js.bidirectional_program(n))
    hier = arrays(js.hierarchical_program(JTopo.boards(2, n // 2)))
    out = {}

    def edit(name, base, fn):
        a = [x.copy() for x in base]
        fn(a)
        out[name] = a

    edit("PC101", bi, lambda a: a.__setitem__(3, a[3][:, :-1]))
    edit("PC102", bi, lambda a: a[0].__setitem__(2, 5))
    edit("PC103", bi, lambda a: a[0].__setitem__(1, 0))
    edit("PC103b", bi, lambda a: a[0].__setitem__(1, n + 3))
    edit("PC104", bi, lambda a: (a[2].__setitem__(0, False)))
    edit("PC105", bi, lambda a: a[3].__setitem__(1, -1))
    edit("PC106", bi, lambda a: a[1].__setitem__(0, 3))
    edit("PC107", bi, lambda a: a[3].__setitem__((2, 1), 2 * n))
    edit("PC107b", bi, lambda a: a[3].__setitem__((2, 1), -3))
    edit("PC108", hier, lambda a: a[3].__setitem__(
        a[3] == a[3].max(), a[3].max() - 1))
    edit("PC109", bi, lambda a: (a[1].__setitem__(1, 0),
                                 a[3].__setitem__(1, 0)))
    return out


def assert_same_findings(got, want, what=""):
    assert [f.as_dict() for f in got] == [f.as_dict() for f in want], what
    assert [str(f) for f in got] == [str(f) for f in want], what


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_constructors_check_as_in_reference(n):
    """Every constructor's program on a flat and a two-board fabric, with
    and without the all-pairs serve set."""
    sizes = [n // 2, n - n // 2]
    fabrics = [(None, None), (JTopo.flat(n), TTopo.flat(n)),
               (JTopo.from_sizes(sizes), TTopo.from_sizes(sizes))]
    full = np.ones((n - 1, n), bool)
    for name, jprog, tprog in program_variants(n):
        for jtopo, ttopo in fabrics:
            for req in (None, full):
                assert_same_findings(
                    tpc.check_program(tprog, ttopo, required_pairs=req),
                    jpc.check_program(jprog, jtopo, required_pairs=req),
                    (name, req is None))


def test_broken_programs_find_as_in_reference():
    """One program broken per rule: the same findings, every rule found,
    and ``verify_program`` raising with the reference's message."""
    n = 8
    topos = (JTopo.boards(2, 4), TTopo.boards(2, 4))
    found = set()
    for name, a in broken_programs(n).items():
        jprog, tprog = pair(*a)
        for jtopo, ttopo in ((None, None), topos):
            got = tpc.check_program(tprog, ttopo)
            assert_same_findings(got, jpc.check_program(jprog, jtopo), name)
            found |= {f.rule for f in got}
        with pytest.raises(JError) as want:
            jpc.verify_program(jprog, topos[0])
        with pytest.raises(ProgramVerificationError) as err:
            tpc.verify_program(tprog, topos[1])
        assert str(err.value) == str(want.value)
    req = np.ones((n - 1, n), bool)
    jprog, tprog = pair(*arrays(js.pruned_program(
        js.bidirectional_program(n), [1, 2])))
    got = tpc.check_program(tprog, required_pairs=req)
    assert_same_findings(got, jpc.check_program(jprog, required_pairs=req))
    found |= {f.rule for f in got}
    got = tpc.check_program(tprog, required_pairs=req[:, :-1])
    assert_same_findings(got, jpc.check_program(
        jprog, required_pairs=req[:, :-1]))
    assert found == {f"PC1{k:02d}" for k in range(1, 11)}


@pytest.mark.parametrize("seed", range(6))
def test_random_programs_find_as_in_reference(seed):
    """Random arrays (most of them unsound) on a flat and a two-board
    fabric."""
    rng = np.random.default_rng(seed)
    n = int(rng.choice([3, 4, 6, 8]))
    sizes = [n // 2, n - n // 2]
    for _ in range(20):
        off = rng.integers(-n, n + 1, size=n - 1)
        live = rng.random(n - 1) < 0.7
        rank_epoch = rng.integers(-2, 2 * n, size=(n - 1, n))
        rank_epoch[rng.random(rank_epoch.shape) < 0.4] = -1
        epoch = rng.integers(-1, n, size=n - 1)
        jprog, tprog = pair(off, epoch, live, rank_epoch)
        req = rng.random((n - 1, n)) < 0.5
        for jtopo, ttopo in ((None, None), (JTopo.from_sizes(sizes),
                                            TTopo.from_sizes(sizes))):
            assert_same_findings(
                tpc.check_program(tprog, ttopo, required_pairs=req),
                jpc.check_program(jprog, jtopo, required_pairs=req))
        assert np.array_equal(tpc.coverage(tprog), jpc.coverage(jprog))


def test_transfer_window_as_in_reference():
    rng = np.random.default_rng(4)
    cases = [(10, 0, None, 1), (10, 4, None, 0)]
    for _ in range(40):
        ab = rng.integers(-2, 10, size=int(rng.integers(1, 5)))
        cases.append((int(rng.integers(0, 40)), int(rng.integers(1, 9)),
                      ab, int(rng.integers(0, 3))))
    for reqs, budget, ab, ov in cases:
        got = tpc.check_transfer_window(
            reqs, budget, None if ab is None else torch.from_numpy(ab), ov)
        assert_same_findings(got, jpc.check_transfer_window(
            reqs, budget, ab, ov))


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_coverage_equals_served_mask(n):
    """For every program constructor and requester r, a request to every
    home h is served by the runtime oracle iff it is loopback or the
    static coverage wires (distance (h - r) mod n, r)."""
    table = MemPortTable.blocked(n, n, 1, device="cpu")
    ids = torch.arange(n, dtype=torch.int32).repeat(n, 1)   # row r: 0..n-1
    r = np.arange(n)[:, None]
    d = (np.arange(n)[None, :] - r) % n
    for name, _, tprog in program_variants(n):
        cov = tpc.coverage(tprog)
        want = (d == 0) | cov[np.maximum(d - 1, 0), np.broadcast_to(r, d.shape)]
        got = tref.served_mask(table, ids, tprog).numpy()
        assert np.array_equal(got, want), name
