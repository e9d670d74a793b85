"""The port's spans (``repro_torch._trace.span``): under ``torch.profiler``
``PfftPlan.execute`` records ``repro_torch.execute`` holding
``repro_torch.phase1`` then ``repro_torch.phase2``, fused or not, complex or
real, and the answer is the unprofiled one; with no profiler active no
``record_function`` is built; every kernel launch runs inside
``repro_torch.launch``."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch._trace as trace
from repro_torch.core.api import plan_pfft
from repro_torch.kernels import _build
from repro_torch.kernels.fft import kernel as fft_kernel
from repro_torch.plan.config import PlanConfig

N = 64
METHODS = {"lb": "complex64", "rfft-lb": "float32"}
CONFIGS = {"fused": PlanConfig(radix=4, fused=True), "unfused": None}
NAMES = ("repro_torch.execute", "repro_torch.phase1", "repro_torch.phase2")


def _plan_and_signal(method, config):
    plan = plan_pfft(N, p=4, method=method, tune="off", config=CONFIGS[config],
                     dtype=METHODS[method], device="cpu")
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((N, N), generator=gen, dtype=getattr(torch, METHODS[method]))
    return plan, x


def _spans(prof, names=NAMES):
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name in names), key=lambda s: s[1])


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("method", sorted(METHODS))
def test_execute_records_its_phases_nested_and_in_order(method, config):
    plan, x = _plan_and_signal(method, config)
    want = plan.execute(x)
    calls = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [plan.execute(x) for _ in range(calls)]
    for answer in got:
        assert torch.equal(answer, want)
    spans = _spans(prof)
    assert [s[0] for s in spans] == list(NAMES) * calls
    for i in range(calls):
        (_, e0, e1), (_, a0, a1), (_, b0, b1) = spans[3 * i:3 * i + 3]
        assert e0 <= a0 < a1 <= b0 < b1 <= e1


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("method", sorted(METHODS))
def test_no_record_function_without_a_profiler(method, config, monkeypatch):
    plan, x = _plan_and_signal(method, config)
    want = plan.execute(x)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler")
    monkeypatch.setattr(trace, "record_function", refuse)
    assert torch.equal(plan.execute(x), want)
    assert trace.span("execute") is trace.span("phase1")


def test_the_guard_follows_the_profiler():
    assert not torch.autograd._profiler_enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled()
        assert not isinstance(trace.span("execute"), contextlib.nullcontext)
    assert not torch.autograd._profiler_enabled()
    assert isinstance(trace.span("execute"), contextlib.nullcontext)


class _Library:
    """Stands in for the kernel library: records each call, refuses none."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, torch.autograd._profiler_enabled()))
            return 0
        return call


class _Stream:
    cuda_stream = 0


def test_every_launch_runs_inside_a_launch_span(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    x = torch.zeros(4, 8, dtype=torch.complex64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("phase1"):
            fft_kernel.launch("repro_fft_rows", x, x, rows=4, n=8)
            fft_kernel.launch("repro_fft_rows", x, x, rows=4, n=8)
    fft_kernel.launch("repro_fft_rows", x, x, rows=4, n=8)
    assert [c[0] for c in lib.calls] == ["repro_fft_rows"] * 3
    spans = _spans(prof, ("repro_torch.phase1", "repro_torch.launch"))
    assert [s[0] for s in spans] == ["repro_torch.phase1"] + ["repro_torch.launch"] * 2
    (_, p0, p1), *launches = spans
    assert all(p0 <= a < b <= p1 for _, a, b in launches)
