"""Port parity of the analytical bridge model (``core/perfmodel.py``).

Every public function of the port against the JAX package's at relative
1e-12 with identical constants: the paper model (``PAPER_HW``, Fig. 3's
table and penalties), the route accounting and the latency model under
every program constructor on a flat and a two-board fabric (worst case
and measured loads, bufferless, pipelined channels), and the device
projection, compared with a reference ``TpuHW`` built from the port's
``DEVICE_HW`` values.  Then the paper pins of ``tests/test_perfmodel.py``
on the port, and the ``Calibrator`` over one sample sequence: the same
theta, predictions and fitted record.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import perfmodel as jpm
from repro.core.topology import Topology as JTopo

from repro_torch.core import perfmodel as tpm
from repro_torch.core.topology import Topology as TTopo

from test_torch_bridge_nnode import program_variants

REL = 1e-12


def jax_hw(d=tpm.DEVICE_HW):
    """The reference's TpuHW with the field values of a port DeviceHW."""
    return jpm.TpuHW(peak_bf16_tflops=d.peak_bf16_tflops,
                     hbm_gbps=d.hbm_gbps, ici_link_gbps=d.link_gbps,
                     ici_links=d.links, ici_hop_latency_us=d.hop_latency_us,
                     outstanding_pages=d.outstanding_pages)


def close(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)


def fabrics(n):
    sizes = [n // 2, n - n // 2]
    return [(None, None), (JTopo.flat(n), TTopo.flat(n)),
            (JTopo.from_sizes(sizes), TTopo.from_sizes(sizes))]


def test_paper_model_matches_reference():
    assert dataclasses.asdict(tpm.PAPER_HW) == dataclasses.asdict(
        jpm.PAPER_HW)
    assert tpm.STREAM_KERNELS == jpm.STREAM_KERNELS
    assert tpm.RTT_PIPELINE_CYCLES == jpm.RTT_PIPELINE_CYCLES
    assert tpm.FEATURE_NAMES == jpm.FEATURE_NAMES
    for kernel in tpm.STREAM_KERNELS:
        for cores in (1, 2, 3, 4):
            for remote in (False, True):
                close(tpm.stream_bandwidth_mibps(kernel, cores, remote),
                      jpm.stream_bandwidth_mibps(kernel, cores, remote))
                close(tpm.mem_bandwidth_mibps(tpm.PAPER_HW, cores, remote),
                      jpm.mem_bandwidth_mibps(jpm.PAPER_HW, cores, remote))
            close(tpm.penalty(kernel, cores), jpm.penalty(kernel, cores))
    assert tpm.stream_table() == jpm.stream_table()
    hw = tpm.BridgeHW(outstanding=5.0, flop_time_ns=11.0)
    assert tpm.stream_table(hw, 6) == jpm.stream_table(
        jpm.BridgeHW(outstanding=5.0, flop_time_ns=11.0), 6)


def test_paper_pins_hold_on_the_port():
    """The faithfulness pins of the reference suite, on the port."""
    assert abs(tpm.PAPER_HW.rtt_ns - 800.0) < 1.0
    assert tpm.PAPER_HW.link_payload_mibps == pytest.approx(1280.0)
    assert tpm.stream_bandwidth_mibps("copy", 1, remote=True) == (
        pytest.approx(562.0, rel=0.02))
    assert tpm.penalty("copy", 1) == pytest.approx(0.47, abs=0.01)
    assert tpm.penalty("scale", 1) == pytest.approx(0.25, abs=0.01)
    assert sum(tpm.RTT_PIPELINE_CYCLES.values()) == 134


def test_device_projection_matches_reference():
    """The card's record in the reference's formulas: same roles of
    fields, the data sheet's HBM and bf16 peak."""
    d = tpm.DEVICE_HW
    assert (d.hbm_gbps, d.peak_bf16_tflops) == (3350.0, 989.0)
    for hw in (d, tpm.DeviceHW(link_gbps=7.0, hop_latency_us=3.0,
                               outstanding_pages=3)):
        for page in (4096, 1 << 15, 1 << 18):
            for hops in (1, 2, 5):
                close(tpm.remote_page_bandwidth_gbps(page, hops, hw),
                      jpm.tpu_remote_page_bandwidth_gbps(page, hops,
                                                         jax_hw(hw)))
            for kernel in tpm.STREAM_KERNELS:
                close(tpm.device_stream_penalty(kernel, page, hw),
                      jpm.tpu_stream_penalty(kernel, page, jax_hw(hw)))
    for w, r in ((3.0, 5.0), (5.0, 3.0), (0.0, 2.0)):
        for c in (1, 2, 8):
            close(tpm._overlap_round_us(w, r, c),
                  jpm._overlap_round_us(w, r, c))


@pytest.mark.parametrize("n", [5, 8])
def test_route_model_matches_reference(n):
    """Route accounting, bytes, round and transfer latency and the
    calibrator's features under every program on every fabric."""
    rng = np.random.default_rng(n)
    hw = tpm.DeviceHW(link_gbps=40.0, hop_latency_us=0.7)
    jhw = jax_hw(hw)
    for name, jprog, tprog in program_variants(n):
        assert tpm.route_epoch_stats(tprog) == jpm.route_epoch_stats(jprog)
        loads = rng.integers(0, 9, size=n - 1).astype(float)
        intra = np.floor(loads * rng.random(n - 1))
        for budget in (1, 4):
            for slot in (None, loads):
                close(tpm.predict_round_bytes(tprog, 4096, budget, slot),
                      jpm.predict_round_bytes(jprog, 4096, budget, slot))
        for jtopo, ttopo in fabrics(n):
            if ttopo is not None:
                assert tpm.hierarchical_route_stats(tprog, ttopo) == (
                    jpm.hierarchical_route_stats(jprog, jtopo))
            for kw in (dict(), dict(slot_pages=loads),
                       dict(slot_pages=loads, slot_intra_pages=intra),
                       dict(edge_buffer=False), dict(channels=4)):
                args = (4096, 8)
                close(tpm.predict_round_latency_us(
                    tprog, *args, hw=hw, topology=ttopo, **kw),
                    jpm.predict_round_latency_us(
                        jprog, *args, hw=jhw, topology=jtopo, **kw))
                close(tpm.predict_transfer_latency_us(
                    tprog, *args, 37, hw=hw, topology=ttopo,
                    overprovision=2, **kw),
                    jpm.predict_transfer_latency_us(
                        jprog, *args, 37, hw=jhw, topology=jtopo,
                        overprovision=2, **kw))
                fkw = {k: v for k, v in kw.items() if k != "edge_buffer"}
                close(tpm.route_features(tprog, 4096, 8, rounds=3,
                                         topology=ttopo, **fkw),
                      jpm.route_features(jprog, 4096, 8, rounds=3,
                                         topology=jtopo, **fkw))
        with pytest.raises(ValueError):
            tpm.predict_round_bytes(tprog, 4096, 2, np.ones(n))


def test_calibrator_matches_reference():
    """One RLS sample sequence (a forgetting factor, a covariance reset):
    the same theta, errors, predictions, constants and fitted record."""
    rng = np.random.default_rng(11)
    progs = program_variants(8)
    jtopo, ttopo = fabrics(8)[2]
    mine = tpm.Calibrator(forgetting=0.98, min_samples=4)
    ref = jpm.Calibrator(jax_hw(), forgetting=0.98, min_samples=4)
    close(mine.theta, ref.theta)
    for i in range(24):
        _, jprog, tprog = progs[i % len(progs)]
        kw = dict(rounds=int(rng.integers(1, 9)),
                  channels=int(rng.choice([1, 2, 4])))
        x = tpm.route_features(tprog, 1 << 15, 8, topology=ttopo, **kw)
        close(x, jpm.route_features(jprog, 1 << 15, 8, topology=jtopo,
                                    **kw))
        span = float(x @ [0.9, 2.5, 3.0, 4.0, 11.0] + rng.normal(0, 0.5))
        assert mine.observe(x, span) == ref.observe(x, span)
        assert np.array_equal(mine.theta, ref.theta)
        assert mine.fitted == ref.fitted
        if i == 12:
            mine.reset_covariance()
            ref.reset_covariance()
        for t, j in ((mine.predict_us(x), ref.predict_us(x)),
                     (mine.static_predict_us(x), ref.static_predict_us(x)),
                     (mine.predict_round_latency_us(tprog, 4096, 8),
                      ref.predict_round_latency_us(jprog, 4096, 8)),
                     (mine.predict_transfer_latency_us(tprog, 4096, 8, 50),
                      ref.predict_transfer_latency_us(jprog, 4096, 8, 50))):
            assert t == j
    assert mine.constants() == ref.constants()
    assert (mine.chunk_overhead_us, mine.base_overhead_us) == (
        ref.chunk_overhead_us, ref.base_overhead_us)
    assert isinstance(mine.hw(), tpm.DeviceHW)
    assert jax_hw(mine.hw()) == ref.hw()
    with pytest.raises(ValueError):
        mine.observe(np.ones(3), 1.0)
