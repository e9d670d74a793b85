"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and lengths, and a file for everything it names by name."""

import json
import re

import pytest

from bench import registry

SPEC = registry.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((registry.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (registry.ROOT / p).is_dir()
    for word in SPEC["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[group]}) == len(SPEC[group])
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        body = json.loads((registry.ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and k in body
                                               for k in c["reduced"])
        for kind in ("entries", "work", "checks"):
            key = {"entries": "entry", "work": "work", "checks": "check"}[kind]
            assert (registry.BENCH / kind / f"{body[key]}.py").is_file()


def test_workloads():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (registry.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (registry.BENCH / "limits" / f"{w['name']}.json").is_file()


def test_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in METRICS:
        assert (registry.BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_sizes_lie_on_the_paper_s_grid(config):
    sizes = registry.config(SPEC, config)["sizes"]
    assert sizes and all(128 <= n <= 64000 and n % 64 == 0 for n in sizes)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_sends_sizes_of_its_configuration(cell):
    w = registry.workload(SPEC, cell)
    sent = {n for n, _ in registry.data("traffic", w["traffic"])["n"]}
    assert sent <= set(registry.config(SPEC, w["config"])["sizes"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = {m["name"] for m in registry.cell_metrics(SPEC, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = registry.cell_metrics(SPEC, cell, True)
    assert layer and all(m["moves"] in e2e for m in layer)


def test_files_under_paths_are_named_from_name_characters():
    for p in SPEC["paths"]:
        for f in (registry.ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = f.relative_to(registry.ROOT).as_posix()
            assert all(NAME.match(part) for part in rel.split("/")), rel
