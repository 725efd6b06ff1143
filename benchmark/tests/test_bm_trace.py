"""The trace arithmetic on hand-made traces: the device's busy time is the
union of its operations' intervals, idle gaps go to the host event that
spans them, and the metrics that read the trace."""

import types

import pytest

from harness import runner
from harness.trace import Op, Trace, gaps, union_ns

US = 1000


def hand_trace():
    ops = [
        Op("user_annotation", "window", 0, 100 * US),
        Op("kernel", "k_a", 10 * US, 30 * US),
        Op("kernel", "k_b", 20 * US, 40 * US),  # overlaps k_a
        Op("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 50 * US, 60 * US),
        Op("gpu_memset", "Memset (Device)", 55 * US, 58 * US),  # inside the copy
        Op("kernel", "k_a", 90 * US, 120 * US),  # runs past the window
        Op("kernel", "k_before", -20 * US, -5 * US),  # before it
        Op("cpu_op", "frame", 0, 100 * US),
        Op("cpu_op", "aten::nonzero", 60 * US, 90 * US),
        Op("cuda_runtime", "cudaStreamSynchronize", 62 * US, 89 * US),
    ]
    return Trace(ops, 0, 100 * US)


def test_union_and_gaps():
    assert union_ns([(0, 10), (5, 20), (30, 40), (35, 36)], 0, 100) == 30
    assert union_ns([(-10, 10), (90, 200)], 0, 100) == 20
    assert gaps([(10, 20), (15, 30), (50, 60)], 0, 100) == [(0, 10), (30, 50), (60, 100)]


def test_busy_is_the_union_not_the_sum():
    t = hand_trace()
    # k_a + k_b cover 10-40, the copy 50-60 (the set inside it), k_a 90-100
    assert t.busy_s == pytest.approx(50e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert sum(o.end - o.start for o in t.device) > 50 * US


def test_idle_gaps_by_host_activity():
    t = hand_trace()
    got = dict(t.idle_gaps())
    # 0-10 and 40-50 under "frame", 60-90 under the synchronise inside nonzero
    assert got["cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert got["frame"] == pytest.approx(20e-6)
    assert sum(got.values()) == pytest.approx(50e-6)


def test_trace_metrics():
    t = hand_trace()
    run = types.SimpleNamespace(trace=t, frame_ids=[0, 1], state={})
    idle = runner.load_metric("device_idle_pct").read(run)
    assert idle == pytest.approx(50.0)
    up = runner.load_metric("upload_ms").read(run)
    assert up == pytest.approx(10e-3 / 2)
    assert t.seconds(lambda n: n == "k_a") == pytest.approx(30e-6)
    assert t.top_ops(1)[0][0] == "k_a"


def k1_run(routes, kernels):
    ops = [Op("user_annotation", "window", 0, 100 * US)]
    ops += [Op("kernel", name, 10 * US * i, 10 * US * i + 5 * US)
            for i, name in enumerate(kernels)]
    return types.SimpleNamespace(trace=Trace(ops, 0, 100 * US), routes=routes,
                                 state={"k1_bound_s": 2e-6})


def test_k1_reads_only_where_no_kernel_shares_its_names():
    k1 = runner.load_metric("k1_roofline_pct")
    names = ["void splat::level_set_tiles<float>(...)",
             "void splat::occupancy_mask_kernel<float, false>(...)"]
    # 2 us of bound over the 10 us of K1 and its pre-pass
    assert k1.read(k1_run({0: "dense", 3: "slab"}, names)) == pytest.approx(20.0)
    assert k1.read(k1_run({0: "dense", 1: "subdomain"}, names)) is None  # K3's sweep
    assert k1.read(k1_run({0: "dense"}, names + ["void pair_sweep_tiles<float>(...)"])) is None
    assert k1.read(k1_run(None, names)) is None  # routes unknown
    assert k1.read(k1_run({0: "dense"}, ["k_other"])) is None  # no K1 time traced
