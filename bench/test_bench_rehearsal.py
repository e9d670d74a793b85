"""A run of every cell end to end on the CPU (a rehearsal: tiny sizes, the
kernels' plain versions), with the timed path broken underneath it, and the
script's own exits: no card, a bare checkout, a forbidden module."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench import harness, registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]
SCRIPT = registry.BENCH / "run.py"


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct(cell, trace):
    result, notes, checks = harness.run_cell(cell, 2 ** 31 + 99, 0.2, trace,
                                             rehearse=True)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert result["metrics"] == {}                 # never a device metric's name
    assert result["device"]["platform"] == "cpu"
    assert list(result)[-1] == "checks"
    assert all(line.startswith("check ") for line in checks)
    names = {m["name"] for m in registry.cell_metrics(registry.benchmark(), cell, trace)}
    assert set(result["rehearsal"]) <= names


def _identity(fn):
    def run(x):
        fn(x)
        w = x.shape[-1] if x.is_complex() else x.shape[-1] // 2 + 1
        return x.to(torch.complex64)[..., :w].contiguous()
    return run


def _stale(fn):
    last = []

    def run(x):
        out = fn(x)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return run


def _half_batch(fn):
    def run(x):
        out = fn(x).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return run


def _altered(fn):
    def run(x):
        out = fn(x).contiguous().clone()
        out.view(-1)[7] += out.abs().mean()
        return out
    return run


FAULTS = {"state_unchanged": _identity, "stale_answer": _stale,
          "half_batch_left_out": _half_batch, "answer_altered": _altered}


def _batched(cell):
    return any(b > 1 for _, b in harness.load_cell(cell, False, rehearse=True).shapes)


# Each fault that a cell can have: half a batch only where requests carry
# more than one signal.
@pytest.mark.parametrize("cell, fault", [
    (cell, fault) for cell in CELLS for fault in sorted(FAULTS)
    if fault != "half_batch_left_out" or _batched(cell)])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    result, _, _ = harness.run_cell(cell, 12345, 0.2, False, rehearse=True,
                                    wrap=FAULTS[fault])
    assert result["correct"] is False


def test_a_failing_program_is_not_correct():
    def broken(fn):
        calls = []

        def run(x):                     # the warm-up's two calls pass
            calls.append(1)
            if len(calls) > 2:
                raise RuntimeError("planted")
            return fn(x)
        return run
    result, notes, _ = harness.run_cell(CELLS[0], 5, 0.1, False, rehearse=True,
                                        wrap=broken)
    assert result["correct"] is False and result["failed"] == result["attempted"] > 0
    assert any("planted" in n for n in notes)


def test_forbidden_modules_compare_whole_top_level_names():
    allowed = ["repro_torch", "repro_torch.core", "jaxtyping", "reproduce", "flaxen",
               "torch", "bench.harness"]
    assert harness.forbidden_modules(allowed) == []
    assert harness.forbidden_modules(allowed + ["repro.core", "jax", "jaxlib.xla",
                                                "flax"]) == [
        "flax", "jax", "jaxlib.xla", "repro.core"]


def test_the_script_rehearses_without_jax():
    """The whole script in a process of its own: exit 0 (it exits 3 if a
    module of JAX or of the JAX package was loaded), the result as the last
    line, the compared numbers as the last lines of standard error."""
    done = subprocess.run([sys.executable, str(SCRIPT), "--workload", CELLS[0],
                           "--seed", str(2 ** 31 + 5), "--seconds", "0.3", "--trace", "1",
                           "--rehearse"], capture_output=True, text=True,
                          cwd=registry.ROOT, env=_env(), timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["metrics"] == {}
    assert done.stderr.strip().splitlines()[-1].startswith("check max_rel: ")


def test_the_script_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the refusal cannot show here")
    done = subprocess.run([sys.executable, str(SCRIPT), "--workload", CELLS[0], "--seed",
                           "1", "--seconds", "1"], capture_output=True, text=True,
                          cwd=registry.ROOT, env=_env(), timeout=300)
    assert done.returncode == 2 and done.stdout == ""
    assert "needs 1 CUDA device" in done.stderr


def test_the_script_fails_without_the_program(tmp_path):
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run([sys.executable, "bench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "0.1", "--rehearse"],
                          capture_output=True, text=True, cwd=tmp_path, env=_env(),
                          timeout=300)
    assert done.returncode != 0 and done.stdout == ""


def test_a_cell_outside_its_configuration_s_sizes_is_refused(monkeypatch):
    cell = harness.load_cell(CELLS[0], False)
    real = registry.data

    def data(kind, name):
        got = real(kind, name)
        return {**got, "n": [[100, 1]]} if kind == "traffic" else got
    monkeypatch.setattr(registry, "data", data)
    with pytest.raises(ValueError, match="outside the sizes"):
        harness.load_cell(cell.name, False, rehearse=True)
