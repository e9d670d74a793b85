"""The port's siblings of the reference's example scripts run to their end on
the host (``--device cpu``: the kernels' plain versions), refuse to start
without a card when no device is given, and import nothing of JAX or of the
reference package."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# script -> (arguments for the host run, a line its output must hold)
EXAMPLES = {
    "fft_convolution_torch.py": (["--n", "64"], "fft-convolution vs full-complex"),
    "pfft1_large_demo_torch.py": ([], "second plan served from wisdom"),
    "serve_fft_demo_torch.py": ([], "served 8 requests"),
    "serve_lm_torch.py": (["--batch", "2", "--prompt-len", "12", "--gen", "4"],
                          "generated 4 tokens/seq"),
    "train_lm_torch.py": (["--steps", "12", "--batch", "4", "--seq", "32"],
                          "loss: "),
}


def run(script: str, args: list[str], **env) -> subprocess.CompletedProcess:
    environ = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="2", **env)
    return subprocess.run([sys.executable, os.path.join(ROOT, "examples", script),
                           *args], capture_output=True, text=True, timeout=300,
                          env=environ, cwd=ROOT)


@pytest.mark.parametrize("script", sorted(EXAMPLES))
def test_example_runs_on_the_host(script):
    args, expect = EXAMPLES[script]
    done = run(script, ["--device", "cpu", *args])
    assert done.returncode == 0, done.stderr[-3000:]
    assert expect in done.stdout, done.stdout[-3000:]
    assert "MISMATCH" not in done.stdout


@pytest.mark.parametrize("arch", ["xlstm_125m", "zamba2_7b"])
def test_serve_lm_example_serves_the_recurrent_archs_on_the_host(arch):
    """xLSTM and Zamba2 at SMOKE size: a prompt of 12 divides both chunks,
    min(16, 12)."""
    args, expect = EXAMPLES["serve_lm_torch.py"]
    done = run("serve_lm_torch.py", ["--device", "cpu", "--arch", arch, *args])
    assert done.returncode == 0, done.stderr[-3000:]
    assert expect in done.stdout, done.stdout[-3000:]


def test_fft2d_pipeline_example_runs_on_gloo_host_ranks():
    """``fft2d_pipeline_torch.py``, the sibling of ``fft2d_pipeline.py``: the
    five variants of ``make_pfft2_fn`` (the last picked by
    ``tune_config(mode="estimate", panels=)``) on 4 gloo ranks of the host,
    each gathered within ``2e-4·N`` of ``numpy.fft.fft2``."""
    n = 128
    done = run("fft2d_pipeline_torch.py", ["--n", str(n), "--ranks", "4"])
    assert done.returncode == 0, done.stderr[-3000:]
    lines = [ln for ln in done.stdout.splitlines() if ln.startswith("distributed pfft2")]
    assert len(lines) == 5 and "estimate-planned" in lines[-1], done.stdout
    for ln in lines:
        assert "shards=4" in ln
        assert float(ln.split("max_err=")[1].split()[0]) <= 2e-4 * n, ln
    assert "collective transpose pattern" in done.stdout
    path = os.path.join(ROOT, "examples", "fft2d_pipeline_torch.py")
    roots = {(node.module or "").split(".")[0]
             for node in ast.walk(ast.parse(open(path).read()))
             if isinstance(node, ast.ImportFrom) and node.level == 0}
    assert "repro_torch" in roots and not {"jax", "repro"} & roots


@pytest.mark.parametrize("script", sorted(EXAMPLES))
def test_example_needs_a_card_by_default(script):
    done = run(script, EXAMPLES[script][0], CUDA_VISIBLE_DEVICES="")
    assert done.returncode != 0
    assert "CUDA" in done.stderr, done.stderr[-3000:]


@pytest.mark.parametrize("script", sorted(EXAMPLES))
def test_example_imports_no_jax_and_nothing_of_the_reference(script):
    path = os.path.join(ROOT, "examples", script)
    banned = {"jax", "jaxlib", "repro", "flax", "optax"}
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots and not banned & roots, roots
