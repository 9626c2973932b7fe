"""The yardstick's arithmetic against counts worked by hand: the kernels'
work, the window's rate and tail, and the device's idle share from a
synthetic trace."""
from __future__ import annotations

import json
import statistics

import pytest

from benchmark.readings import Readings, Step, p95, spread
from benchmark.registry import Registry
from benchmark.run import ROOT
from benchmark.tracing import HostOp, TraceSummary, gaps, merged, union_length

PEAKS = json.loads((ROOT / "benchmark" / "peaks.json").read_text())


@pytest.fixture(scope="module")
def registry():
    return Registry(ROOT)


def test_b1_cost_by_hand(registry):
    b1 = registry.roofline("b1")
    # b = 1, hw = 2, K = 3 (N = 6), c = 4, with lf: QK^T 2*2*6*4 = 96 FLOP,
    # two PV products 96 each -> 288; bytes: bf16 query 2*4, key / xf / lf
    # 3 * 6*4 in, out_x / out_l 2 * 2*4 out -> 2 * (8 + 72 + 16) = 192,
    # masses 4 * 2*3 = 24 -> 216
    flops, nbytes = b1.cost(1, 2, 3, 4, True, 2)
    assert flops == 288 and nbytes == 216
    flops, nbytes = b1.cost(1, 2, 3, 4, False, 4)
    # one value tensor: 2 * 96 FLOP; f32: 4 * (8 + 8 + 24 + 24) + 24
    assert flops == 192 and nbytes == 280


def test_b1_least_time_from_recorded_shapes(registry):
    b1 = registry.roofline("b1")
    shapes = [[8, 16384, 128], [8, 131072, 128], [8, 131072, 128], [8, 131072, 128], []]
    flops, nbytes = b1.cost(8, 16384, 8, 128, True, 2)
    want = max(flops / PEAKS["bf16_flops_per_s"], nbytes / PEAKS["bytes_per_s"])
    assert b1.least_seconds(shapes, 2, PEAKS) == pytest.approx(want)
    assert flops / PEAKS["bf16_flops_per_s"] > nbytes / PEAKS["bytes_per_s"]   # bound by operations
    no_lf = [[8, 16384, 128], [8, 131072, 128], [8, 131072, 128], [0], []]
    assert b1.least_seconds(no_lf, 2, PEAKS) < b1.least_seconds(shapes, 2, PEAKS)


def test_b2_counts_only_pairs_inside_the_map(registry):
    b2 = registry.roofline("b2")
    # a 2 x 3 map, md 1, stride 1: shifts (dy, dx) in {-1, 0, 1}^2; pairs
    # inside the map: (2 - |dy|) * (3 - |dx|) -> rows 1, 2, 1 times columns
    # 2, 3, 2 -> 4 * 7 = 28 pairs; 2 FLOP a channel; c = 5, b = 1
    flops, nbytes = b2.cost(1, 5, 2, 3, 1, 1, 4)
    assert flops == 2 * 5 * 28
    # f1, f2: 2 * 5 * 6 values; out: 9 * 6; f32
    assert nbytes == 4 * (2 * 5 * 6 + 9 * 6)
    # stride 2 with md 2: the same 3 x 3 grid of shifts, now of 2 px
    assert b2.displacements(2, 2) == [(dy, dx) for dy in (-2, 0, 2) for dx in (-2, 0, 2)]
    flops2, _ = b2.cost(1, 5, 2, 3, 2, 2, 4)
    assert flops2 == 2 * 5 * ((2 + 0 + 0) * (3 + 1 + 1))


def test_b2_least_time_is_three_tf32_products_per_f32_one(registry):
    b2 = registry.roofline("b2")
    flops, nbytes = b2.cost(48, 256, 32, 64, 20, 2, 4)
    ops_s = 3 * flops / PEAKS["tf32_flops_per_s"]
    assert b2.least_seconds(48, 256, 32, 64, 20, 2, 4, PEAKS) == pytest.approx(
        max(ops_s, nbytes / PEAKS["bytes_per_s"]))


def readings(latencies_ms, gap_s=0.0, frames=8):
    t, steps = 100.0, []
    for ms in latencies_ms:
        steps.append(Step(t, t + ms / 1e3, frames))
        t += ms / 1e3 + gap_s
    return Readings(setup_s=12.0, steps=steps, window_start=100.0, window_end=steps[-1].end)


def test_rate_is_all_frames_over_the_whole_window(registry):
    r = readings([100.0] * 9 + [1000.0], gap_s=0.01)
    window = 9 * 0.1 + 1.0 + 9 * 0.01
    assert r.window_s == pytest.approx(window)
    assert registry.metric("frames_per_s").read(r) == pytest.approx(80 / window)
    assert registry.metric("train_frames_per_s").read(r) == pytest.approx(80 / window)
    assert registry.metric("setup_s").read(r) == 12.0


def test_p95_is_the_tail_of_every_step(registry):
    lat = [float(i) for i in range(1, 201)]   # 1 .. 200 ms
    r = readings(lat)
    # inclusive quantiles: position 0.95 * 199 = 189.05 between 190 and 191
    assert registry.metric("frame_p95_ms").read(r) == pytest.approx(190.05)
    assert p95(lat) == pytest.approx(190.05)
    # one slow reset among the steps moves the tail
    assert p95(lat[:-1] + [5000.0]) >= p95(lat)


def test_spread_is_interquartile_over_median():
    values = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert spread(values) == pytest.approx((q3 - q1) / 12.5)


def test_union_of_overlapping_kernels_counts_once():
    intervals = [(0, 10), (5, 15), (20, 30), (30, 32), (40, 41)]
    assert merged(intervals) == [(0, 15), (20, 32), (40, 41)]
    assert union_length(intervals) == 15 + 12 + 1
    assert gaps(intervals) == [(15, 20), (32, 40)]


def test_idle_share_and_breakdown_from_a_synthetic_trace(registry):
    device = [(0.0, 400.0, "conv"), (100.0, 300.0, "copy"), (600.0, 900.0, "conv"),
              (900.0, 950.0, "attention")]
    host = [HostOp("bench.step", 0.0, 1000.0, False), HostOp("cudaMemcpyAsync", 400.0, 600.0, False)]
    tr = TraceSummary(window_s=1000e-6, device=device, host=host)
    tr.busy_s = union_length([(s, e) for s, e, _ in device]) / 1e6
    assert tr.busy_s == pytest.approx(750e-6)      # 400 + 350, the copy inside the conv
    r = readings([1.0])
    r.trace = tr
    assert registry.metric("device_idle_share.serve").read(r) == pytest.approx(25.0)
    assert registry.metric("device_idle_share.train").read(r) == pytest.approx(25.0)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["conv", pytest.approx(700e-6)]
    assert b["idle_gaps"] == [["cudaMemcpyAsync", pytest.approx(200e-6)]]
    assert tr.device_seconds(("attention",)) == pytest.approx(50e-6)


def test_b1_roofline_reads_the_operator_and_nothing_without_it(registry):
    reader = registry.metric("b1_roofline.serve")
    shapes = [[1, 64, 128], [1, 512, 128], [1, 512, 128], [1, 512, 128], []]
    least = registry.roofline("b1").least_seconds(shapes, 2, PEAKS)
    host = [HostOp("fsv::flash_ref_attention", 0.0, 10.0, False, 2e6 * least, shapes),
            HostOp("fsv::flash_ref_attention", 1.0, 9.0, True, 2e6 * least, shapes)]
    r = readings([1.0])
    r.peaks, r.roofline = PEAKS, registry.roofline
    r.trace = TraceSummary(window_s=1.0, device=[], host=host)
    assert reader.read(r) == pytest.approx(50.0)     # the nested call is not counted again
    r.trace = TraceSummary(window_s=1.0, device=[], host=[])
    assert reader.read(r) is None


def test_mfu_counts_every_step_of_the_window(registry):
    r = readings([100.0] * 4)
    r.peaks = PEAKS
    r.steps[0].kind = "reset"
    r.flops = {"reset": 1e12, "first": 2e12, "step": 3e12}
    want = 100 * (3e12 + 3 * 3e12) / r.window_s / PEAKS["bf16_flops_per_s"]
    assert registry.metric("mfu.serve").read(r) == pytest.approx(want)
    r.flops = {"sequence": 5e12}
    assert registry.metric("mfu.train").read(r) == pytest.approx(
        100 * 4 * 5e12 / r.window_s / PEAKS["bf16_flops_per_s"])
    r.flops = {}
    assert registry.metric("mfu.serve").read(r) is None
