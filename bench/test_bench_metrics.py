"""The metric arithmetic: points over the window, a p95 over every request,
the roofline's bytes and operations for c2c and r2c, the idle union and
the readers' silence where they have nothing to read."""

import math

import pytest
import torch

from bench import devtrace, harness, loops, peaks, registry


def _run(latencies, shape=(64, 2), window_s=2.0, trace=None, work="dft2_c2c"):
    records, t = [], 0.0
    for lat in latencies:
        records.append(loops.Record(shape, 0, t, t, t + lat / 4, t + lat, True))
        t += lat
    return harness.Run(records, window_s, 7.5, 0.0125, 10 * 2 ** 30, 8 * 2 ** 30,
                       2 ** 30, registry.code("work", work).work, trace)


def _read(name, run):
    return registry.code("metrics", name).read(run)


def test_points_per_s_counts_every_point_over_the_window():
    run = _run([0.01] * 10, shape=(64, 2), window_s=0.5)
    assert _read("points_per_s", run) == pytest.approx(10 * 2 * 64 * 64 / 0.5 / 1e6)


def test_points_per_s_leaves_out_failed_requests():
    run = _run([0.01] * 4, window_s=1.0)
    run.records[0].ok = False
    assert _read("points_per_s", run) == pytest.approx(3 * 2 * 64 * 64 / 1e6)


def test_p95_is_the_nearest_rank_over_all_requests():
    lat = [i / 1000 for i in range(1, 101)]          # 1 ... 100 ms
    assert _read("latency_p95_ms", _run(lat[::-1])) == pytest.approx(95.0)
    assert _read("latency_p95_ms", _run([0.004] * 19 + [0.5])) == pytest.approx(4.0)
    assert _read("latency_p95_ms", _run([0.004] * 18 + [0.5, 0.6])) == pytest.approx(500.0)


def test_simple_readers():
    run = _run([0.002, 0.004])
    assert _read("setup_s", run) == 7.5
    assert _read("plan_ms", run) == 12.5
    assert _read("execute_host_ms", run) == pytest.approx((0.5 + 1.0) / 2)


def test_peak_mem_is_the_program_s_peak_and_one_input():
    # 10 GiB at the peak, of which the harness held 8 (inputs, kept
    # answers): the program's 2, and the caller's input of 1.
    assert _read("peak_mem_gib", _run([0.002])) == 3.0
    run = _run([0.002])
    run.peak_bytes = None
    assert _read("peak_mem_gib", run) is None


def test_held_storages_count_once():
    x = torch.zeros(1024, dtype=torch.complex64)
    y = torch.zeros((16, 16), dtype=torch.float32)
    assert harness._storage_bytes([x, x[:10], y.T, None]) == 1024 * 8 + 256 * 4


@pytest.mark.parametrize("n", [4, 8, 64, 1024])
def test_c2c_work(n):
    nbytes, flops = registry.code("work", "dft2_c2c").work(n, 3)
    assert nbytes == 3 * n * n * 16
    assert flops == pytest.approx(3 * 5 * n * n * math.log2(n * n))


@pytest.mark.parametrize("n", [4, 8, 64, 1024])
def test_r2c_work(n):
    nbytes, flops = registry.code("work", "dft2_r2c").work(n, 2)
    assert nbytes == 2 * (n * n * 4 + n * (n // 2 + 1) * 8)
    assert flops == pytest.approx(2 * 2.5 * n * n * math.log2(n * n))


def test_least_time_takes_the_larger_bound():
    assert peaks.least_s(3.35e12, 1.0) == (pytest.approx(1.0), "bytes")
    assert peaks.least_s(1.0, 67e12 * 2) == (pytest.approx(2.0), "operations")
    # 16384² complex: bound by bytes, 4.29 GB at 3.35 TB/s
    s, by = peaks.least_s(*registry.code("work", "dft2_c2c").work(16384, 1))
    assert by == "bytes" and s == pytest.approx(2 ** 28 * 16 / 3.35e12)


@pytest.mark.parametrize("intervals, length", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(5, 6), (0, 1), (0.5, 0.75)], 2.0),
    ([(0, 10), (2, 3), (4, 5)], 10.0),
    ([(0, 1), (1, 2)], 2.0),
])
def test_union(intervals, length):
    assert devtrace.union_us(intervals) == pytest.approx(length)


def _trace():
    ops = [("k1", 10.0, 30.0), ("k2", 25.0, 40.0), ("copy", 60.0, 90.0)]
    spans = [("bench.execute", 0.0, 12.0), ("bench.sync", 12.0, 95.0)]
    host = [("aten::empty", 2.0, 4.0), ("cudaDeviceSynchronize", 40.0, 95.0)]
    return devtrace.Trace((0.0, 100.0), ops, spans, host)


def test_trace_busy_idle_and_ops():
    tr = _trace()
    assert tr.busy_s == pytest.approx(60e-6)
    assert tr.op_s == pytest.approx(65e-6)
    assert tr.window_s == pytest.approx(100e-6)
    assert devtrace.top_ops(tr) == [["copy", pytest.approx(30e-6)],
                                    ["k1", pytest.approx(20e-6)],
                                    ["k2", pytest.approx(15e-6)]]
    gaps = dict((name, s) for name, s in devtrace.idle_gaps(tr))
    assert gaps == {"execute": pytest.approx(10e-6),
                    "sync/cudaDeviceSynchronize": pytest.approx(30e-6)}


def test_trace_readers():
    run = _run([0.01, 0.01], shape=(64, 1), trace=_trace())
    assert _read("kernels_per_call", run) == 1.5
    assert _read("device_idle", run) == pytest.approx(40.0)
    least = 2 * peaks.least_s(*registry.code("work", "dft2_c2c").work(64, 1))[0]
    assert _read("kernels_roofline", run) == pytest.approx(least / 65e-6 * 100)


@pytest.mark.parametrize("name", ["kernels_per_call", "kernels_roofline", "device_idle"])
def test_trace_readers_are_silent_without_device_operations(name):
    assert _read(name, _run([0.01])) is None
    assert _read(name, _run([0.01], trace=devtrace.Trace((0.0, 1.0), []))) is None
