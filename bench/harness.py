"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the metrics, as the result line reports them.

``run_cell`` takes the card's presence for granted (``run.py`` looks for
it first) so that a test can drive the rest of a run on the CPU: with
``rehearse`` the cell runs at its traffic's tiny ``rehearse`` sizes through
the kernels' plain versions, and its numbers go under ``rehearsal``, never
under a device metric's name.  ``wrap`` puts something else in the
program's place (the control, a planted fault).
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import sys
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from bench import devtrace, loops, peaks, registry, traffic as traffic_mod

__all__ = ["Cell", "FORBIDDEN", "Run", "forbidden_modules", "load_cell",
           "make_inputs", "run_cell"]

# Top-level module names a run may not load: JAX and the JAX package.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
# Seeded inputs a shape, sent in turn, so that an answer left over from the
# previous request of the shape is wrong for the next.
INPUTS_PER_SHAPE = 2
_DTYPES = {"complex64": torch.complex64, "float32": torch.float32}


def forbidden_modules(names=None) -> list[str]:
    """Modules (of ``names``, else those loaded) whose top-level name,
    compared whole, is forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    metrics: list[dict]

    @property
    def shapes(self) -> list[tuple[int, int]]:
        return traffic_mod.shapes(self.traffic)


def load_cell(name: str, trace: bool, rehearse: bool = False) -> Cell:
    spec = registry.benchmark()
    w = registry.workload(spec, name)
    config = registry.config(spec, w["config"])
    t = traffic_mod.validate(registry.data("traffic", w["traffic"]))
    outside = sorted({n for n, _ in traffic_mod.shapes(t)} - set(config["sizes"]))
    if outside:
        raise ValueError(f"{name}: traffic {w['traffic']!r} sends n = {outside}, "
                         f"outside the sizes of configuration {w['config']!r}")
    if rehearse:
        t = traffic_mod.validate({**t, **t["rehearse"]})
    return Cell(name, w, config, t, registry.data("limits", name),
                registry.cell_metrics(spec, name, trace))


def _sub_seed(seed: int, *parts: int) -> int:
    state = np.random.SeedSequence([seed % 2 ** 64, *parts]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def make_inputs(cell: Cell, seed: int, device) -> dict[tuple[int, int], list]:
    """``INPUTS_PER_SHAPE`` signals a shape, made on ``device`` from the
    seed in one call each."""
    dtype = _DTYPES[cell.config["dtype"]]
    out = {}
    for n, b in cell.shapes:
        out[(n, b)] = []
        for slot in range(INPUTS_PER_SHAPE):
            gen = torch.Generator(device=device)
            gen.manual_seed(_sub_seed(seed, n, b, slot))
            out[(n, b)].append(torch.randn((b, n, n), generator=gen, dtype=dtype,
                                           device=device))
    return out


def _storage_bytes(tensors) -> int:
    """The bytes that ``tensors`` hold, each storage counted once."""
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors if isinstance(t, torch.Tensor)}
    return sum(storages.values())


@dataclass
class Run:
    """What the metric readers (``bench/metrics/<name>.py``) read."""
    records: list[loops.Record]
    window_s: float
    setup_s: float
    plan_s: float
    peak_bytes: int | None       # the allocator's peak over the window
    held_bytes: int              # what the harness held through it
    request_bytes: int           # the largest request's input
    work: Callable[[int, int], tuple[float, float]]
    trace: devtrace.Trace | None = None

    @property
    def done(self) -> list[loops.Record]:
        return [r for r in self.records if r.ok]


def _client(device: torch.device, clients: int):
    """Each caller's context and the wait for its answers: with one caller,
    the device's ``synchronize``; with several, a stream each."""
    if device.type != "cuda":
        return lambda: (contextlib.nullcontext(), lambda: None)
    if clients == 1:
        return lambda: (contextlib.nullcontext(), torch.cuda.synchronize)

    def make():
        stream = torch.cuda.Stream(device)
        return torch.cuda.stream(stream), stream.synchronize
    return make


def _check(cell: Cell, inputs, kept, check) -> dict[str, float]:
    """The worst of each compared number over the sampled answers; infinity
    where a shape of the mix has no answer to judge."""
    worst = {name: 0.0 for name in check.NUMBERS}
    for shape in cell.shapes:
        slot, answer = kept.get(shape, (0, None))
        for name, value in check.compare(inputs[shape][slot], answer).items():
            worst[name] = max(worst[name], value)
    return worst


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             rehearse: bool = False, wrap: Callable | None = None,
             started: float | None = None, min_requests: int = 0
             ) -> tuple[dict, list[str], list[str]]:
    """One run: ``(result, notes, check_lines)``.  ``started`` is the
    process's start on ``time.perf_counter``'s clock (``setup_s`` counts
    from it); ``min_requests`` are sent however long they take."""
    started = time.perf_counter() if started is None else started
    cell = load_cell(name, trace, rehearse)
    device = torch.device("cpu" if rehearse else "cuda")
    entry = registry.code("entries", cell.config["entry"])
    check = registry.code("checks", cell.config["check"])
    work = registry.code("work", cell.config["work"]).work
    notes = []

    t_inputs = time.perf_counter()
    inputs = make_inputs(cell, seed, device)
    sides = sorted({n for n, _ in cell.shapes})
    t_plan = time.perf_counter()
    programs, plan_s, paths = entry.open_program(cell.config, sides, device)
    t_warm = time.perf_counter()
    if wrap is not None:
        programs = {n: wrap(fn) for n, fn in programs.items()}
    notes += [f"plan n={n}: {path}" for n, path in paths.items()]

    def call(shape, slot):
        return programs[shape[0]](inputs[shape][slot])

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    held = {}
    for shape in cell.shapes:          # warm every shape the window sends
        for _ in range(2):
            held[shape] = (0, call(shape, 0))
        sync()
    # What the harness holds through the window, beside the program: every
    # input, and an answer a shape kept for the check (set-up's until the
    # window's first of that shape replaces it).
    held_bytes = _storage_bytes([x for xs in inputs.values() for x in xs]
                                + [a for _, a in held.values()])
    request_bytes = max(xs[0].nbytes for xs in inputs.values())
    gc.collect()                       # set-up's garbage, before the window
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - started
    notes.append(f"setup s: start to inputs {t_inputs - started:.2f}, inputs "
                 f"{t_plan - t_inputs:.2f}, program and plans {t_warm - t_plan:.2f}, "
                 f"warm-up {started + setup_s - t_warm:.2f}")

    reservoir = loops.Reservoir(_sub_seed(seed, 3), held)
    held = None
    client = _client(device, int(cell.traffic.get("clients", 1)))
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            window = loops.run_window(cell.traffic, seed, seconds, call, reservoir,
                                      slots=INPUTS_PER_SHAPE, client=client,
                                      span=record_function, min_requests=min_requests)
    else:
        window = loops.run_window(cell.traffic, seed, seconds, call, reservoir,
                                  slots=INPUTS_PER_SHAPE, client=client,
                                  min_requests=min_requests)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    t_trace = time.perf_counter()
    tr = devtrace.from_profiler(prof) if prof is not None else None
    del prof
    if tr is not None:
        notes.append(f"trace: {len(tr.device_ops)} device operations read in "
                     f"{time.perf_counter() - t_trace:.1f} s")

    del programs                        # the program's state, but its answers
    t_check = time.perf_counter()
    numbers = _check(cell, inputs, reservoir.sampled, check)
    reservoir = None
    notes.append(f"reference check: {time.perf_counter() - t_check:.2f} s")

    run = Run(window.records, window.seconds, setup_s, plan_s, peak, held_bytes,
              request_bytes, work, tr)
    values = {}
    for metric in cell.metrics:
        value = registry.code("metrics", metric["name"]).read(run)
        if value is not None:
            values[metric["name"]] = {"value": value, "unit": metric["unit"]}

    lat = sorted(r.latency * 1e3 for r in run.done)
    if lat:
        notes.append(f"latency ms: median {statistics.median(lat)}, "
                     f"min {lat[0]}, max {lat[-1]}, {len(lat)} requests")
    failed = len(window.records) - len(run.done)
    if window.errors:
        notes.append(f"{len(window.errors)} requests failed; the first:\n"
                     + window.errors[0])
    limits = {k: float(cell.limits[k]) for k in check.NUMBERS}
    correct = (failed == 0 and bool(window.records)
               and all(numbers[k] <= limits[k] for k in check.NUMBERS))
    result = {"correct": correct, "attempted": len(window.records),
              "failed": failed}
    if rehearse:
        result.update(metrics={}, rehearsal=values,
                      device={"platform": "cpu", "kind": "cpu", "count": 0,
                              "memory_peak_bytes": 0})
    else:
        result["metrics"] = values
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(device),
                            "count": int(cell.workload["chips"]),
                            "memory_peak_bytes": int(peak),
                            "power_limit": peaks.power_limit()}
        if tr is not None:
            result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
            result["breakdown"] = {"device_ops": devtrace.top_ops(tr),
                                   "idle_gaps": devtrace.idle_gaps(tr)}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in check.NUMBERS}
    lines = [f"check {k}: {numbers[k]!r} limit {limits[k]!r}"
             + ("" if numbers[k] <= limits[k] else "  FAILED")
             for k in check.NUMBERS]
    return result, notes, lines
