"""The readers of the program's ``repro_torch.*`` spans on hand-built traces:
the API's self time, the launches' host time, and each phase's device time
by pairing launching calls with device operations in order."""

import pytest

from bench import devtrace, harness, loops, program_spans, registry


def _run(trace, requests=1):
    records = [loops.Record((64, 1), 0, i, i, i + 0.5, i + 1.0, True)
               for i in range(requests)]
    return harness.Run(records, 2.0, 7.5, 0.0125, None, 0, 0,
                       registry.code("work", "dft2_c2c").work, trace)


def _read(name, run):
    return registry.code("metrics", name).read(run)


def _request(t0, phase1_launches=1, phase2_launches=1, *, memcpy_at=None):
    """One request's host events from ``t0`` (us): execute, its two phases,
    a launch span a kernel (each with its runtime call), and the device
    operations, one a runtime call, 10 us each (a copy 1 us), run in the
    order of their calls on one stream."""
    host, calls, t = [], [], t0 + 5.0
    spans = []
    for phase, launches in (("phase1", phase1_launches), ("phase2", phase2_launches)):
        p0 = t
        t += 2.0
        for _ in range(launches):
            host.append(("repro_torch.launch", t, t + 4.0))
            calls.append(("cudaLaunchKernelExC", t + 1.0, "k_" + phase, 10.0))
            t += 5.0
        spans.append(("repro_torch." + phase, p0, t))
        t += 3.0
    end = t + 5.0
    if memcpy_at is not None:
        calls.append(("cudaMemcpyAsync", t0 + memcpy_at, "Memcpy DtoD", 1.0))
    device, free = [], 0.0
    for call, at, op, length in sorted(calls, key=lambda c: c[1]):
        host.append((call, at, at + 2.0))
        start = max(at + 40.0, free)
        device.append((op, start, start + length))
        free = start + length
    host += [("repro_torch.execute", t0, end), ("aten::reshape", t0 + 1.0, t0 + 2.0)]
    return host + spans, device, end - t0


def _trace(requests):
    host, device = [], []
    for hs, ds in requests:
        host += hs
        device += ds
    return devtrace.Trace((0.0, 10_000.0), sorted(device, key=lambda o: o[1]), [],
                          sorted(host, key=lambda h: h[1]))


def test_execute_self_time_leaves_out_nested_children():
    host, device, length = _request(0.0)
    run = _run(_trace([(host, device)]))
    # phase1 [5, 12) holds a launch [7, 11); phase2 [15, 22) one [17, 21)
    covered = (12.0 - 5.0) + (22.0 - 15.0)
    assert length == 30.0
    assert program_spans.self_ms(run, program_spans.EXECUTE) == pytest.approx((length - covered) / 1e3)
    assert _read("execute_self_ms", run) == pytest.approx((length - covered) / 1e3)


def test_launch_host_time_sums_every_launch_of_a_request():
    reqs = [_request(0.0, 3, 2)[:2], _request(1000.0, 3, 2)[:2]]
    run = _run(_trace(reqs), requests=2)
    assert _read("launch_host_ms", run) == pytest.approx(5 * 4.0 / 1e3)


def test_phases_take_their_own_launches_and_a_copy_outside_both_counts_in_neither():
    host, device, length = _request(0.0, memcpy_at=13.0)   # between the phases
    run = _run(_trace([(host, device)]))
    assert len(program_spans.launching_calls(run)) == len(run.trace.device_ops) == 3
    assert _read("phase1_device_ms", run) == pytest.approx(10.0 / 1e3)
    assert _read("phase2_device_ms", run) == pytest.approx(10.0 / 1e3)
    assert run.trace.op_s * 1e3 == pytest.approx(21.0 / 1e3)


def test_eight_launches_in_phase_one_and_one_in_phase_two():
    reqs = [_request(0.0, 8, 1)[:2], _request(500.0, 8, 1)[:2]]
    run = _run(_trace(reqs), requests=2)
    assert _read("phase1_device_ms", run) == pytest.approx(8 * 10.0 / 1e3)
    assert _read("phase2_device_ms", run) == pytest.approx(10.0 / 1e3)
    assert (_read("phase1_device_ms", run) + _read("phase2_device_ms", run)
            == pytest.approx(run.trace.op_s * 1e3 / 2))


def test_launches_outside_the_window_are_not_paired():
    host, device, _ = _request(100.0)
    host.append(("cudaLaunchKernel", -50.0, -40.0))        # warm-up, before it
    run = _run(_trace([(host, device)]))
    assert _read("phase1_device_ms", run) == pytest.approx(10.0 / 1e3)


@pytest.mark.parametrize("name", ["phase1_device_ms", "phase2_device_ms"])
def test_phases_are_silent_when_calls_and_operations_do_not_pair(name):
    host, device, _ = _request(0.0)
    run = _run(_trace([(host, device + [("stray", 900.0, 910.0)])]))
    assert _read(name, run) is None
    host, device, _ = _request(0.0)
    run = _run(_trace([(host + [("cudaMemsetAsync", 25.0, 26.0)], device)]))
    assert _read(name, run) is None


@pytest.mark.parametrize("name", ["execute_self_ms", "launch_host_ms",
                                  "phase1_device_ms", "phase2_device_ms"])
def test_readers_are_silent_without_program_spans(name):
    assert _read(name, _run(None)) is None
    host, device, _ = _request(0.0)
    bare = [h for h in host if not h[0].startswith("repro_torch.")]
    assert _read(name, _run(_trace([(bare, device)]))) is None
    assert _read(name, _run(devtrace.Trace((0.0, 1.0), []))) is None


def test_phases_are_silent_without_device_operations():
    host, _, _ = _request(0.0)
    run = _run(_trace([(host, [])]))
    assert _read("phase1_device_ms", run) is None
    assert _read("execute_self_ms", run) is not None
