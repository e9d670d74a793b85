"""Find what belongs to a cell by its name: its configuration, traffic mix,
correctness limits, and the code files of its entry, work, check and
metrics.  A later cell or metric is new files plus new entries in
``BENCHMARK.json``; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

__all__ = ["BENCH", "ROOT", "benchmark", "cell_metrics", "code", "config",
           "data", "workload"]

# Code files loaded so far, by path: like ``sys.modules``, one load a process.
_LOADED: dict[Path, ModuleType] = {}


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    known = ", ".join(w["name"] for w in spec["workloads"])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {known})")


def config(spec: dict, name: str) -> dict:
    """The configuration's file, with its ``BENCHMARK.json`` entry's name."""
    for c in spec["configs"]:
        if c["name"] == name:
            return {**json.loads((ROOT / c["file"]).read_text()), "name": name}
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def data(kind: str, name: str) -> dict:
    """``bench/<kind>/<name>.json``: a traffic mix or a cell's limits."""
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def code(kind: str, name: str) -> ModuleType:
    """``bench/<kind>/<name>.py``, loaded from its path once a process (a
    name may hold dots, so it is not imported as a package)."""
    path = BENCH / kind / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def _applies(metric: dict, cell: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` prints: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on."""
    e2e = [m for m in spec["end_to_end"] if _applies(m, cell, set())]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if _applies(m, cell, reported)]
