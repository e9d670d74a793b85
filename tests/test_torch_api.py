"""The slice as a whole: ``plan_pfft(...).execute`` of the PyTorch port against
the JAX package's plan on the same FPMs — equal partitions, pad lengths and
schedules, outputs within ``2e-4 * N`` — plus what the port refuses until a
later slice (``mesh=``), its default device, and that it imports nothing of
JAX.  The planner (``tune=``, ``wisdom=``) is ``tests/test_torch_plan.py``'s."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_parity import (both_fpms, both_padding_fpms, complex_signal,
                           to_numpy, to_torch)

import repro.core as ref_core
import repro.plan as ref_plan

import repro_torch
import repro_torch.core as port_core
import repro_torch.plan as port_plan

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
METHODS = ["lb", "fpm", "fpm-pad", "fpm-czt"]
CONFIGS = {"default": None, "library": {}, "stockham": {"radix": 2},
           "kernel": {"radix": 4}, "fused": {"fused": True}}


def plans(n, method, config, *, padding=False, p=3, seed=0):
    ref_fpms, port_fpms = (both_padding_fpms(n) if padding
                           else both_fpms(n, p=p, seed=seed))
    kw = CONFIGS[config]
    a = ref_core.plan_pfft(n, p=p, fpms=ref_fpms, method=method,
                           config=None if kw is None else ref_plan.PlanConfig(**kw))
    b = port_core.plan_pfft(n, p=p, fpms=port_fpms, method=method, device="cpu",
                            config=None if kw is None else port_plan.PlanConfig(**kw))
    return a, b


def same_plan(a, b):
    np.testing.assert_array_equal(a.d, b.d)
    assert a.partition.method == b.partition.method
    if a.pad_lengths is None:
        assert b.pad_lengths is None
    else:
        np.testing.assert_array_equal(a.pad_lengths, b.pad_lengths)
    assert a.schedule.to_dict() == b.schedule.to_dict()
    assert a.schedule.describe() == b.schedule.describe()
    assert a.config.to_dict() == b.config.to_dict()
    assert a.tuning["source"] == b.tuning["source"]
    assert (a.n, a.method, a.dtype) == (b.n, b.method, b.dtype)


@pytest.mark.parametrize("n", [32, 64, 96])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_plan_execute_matches_reference(n, method, config):
    a, b = plans(n, method, config, seed=n)
    same_plan(a, b)
    m = complex_signal(n, n, n)
    want = np.asarray(a.execute(jnp.asarray(m)))
    got = b.execute(to_torch(m))
    assert got.device.type == "cpu" and got.dtype == torch.complex64
    np.testing.assert_allclose(to_numpy(got), want, atol=2e-4 * n)
    if method != "fpm-pad":
        np.testing.assert_allclose(to_numpy(got), np.fft.fft2(m), atol=2e-4 * n)


@pytest.mark.parametrize("config", ["library", "stockham", "kernel", "fused"])
def test_plan_fpm_pad_with_engaged_pads_matches_reference(config):
    """``fused`` drops on the padded method (``normalize_pad``) in both."""
    n = 32
    a, b = plans(n, "fpm-pad", config, padding=True)
    same_plan(a, b)
    assert (b.pad_lengths > n).any() and not b.config.fused
    m = complex_signal(1, n, n)
    np.testing.assert_allclose(to_numpy(b.execute(to_torch(m))),
                               np.asarray(a.execute(jnp.asarray(m))), atol=2e-4 * n)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("config", ["library", "kernel", "fused"])
def test_plan_execute_batch_matches_reference(method, config):
    """Leading batch dims give what the reference's vmap gives."""
    n = 32
    a, b = plans(n, method, config, seed=2)
    m = complex_signal(3, 2, n, n)
    want = np.asarray(a.execute(jnp.asarray(m)))
    got = b.execute(to_torch(m))
    assert got.shape == (2, n, n)
    np.testing.assert_allclose(to_numpy(got), want, atol=2e-4 * n)
    deep = b.execute(to_torch(m.reshape(1, 2, n, n)))
    assert deep.shape == (1, 2, n, n)
    np.testing.assert_array_equal(to_numpy(deep[0]), to_numpy(got))


def test_plan_execute_takes_host_arrays_to_its_device():
    _, b = plans(16, "lb", "kernel")
    m = complex_signal(4, 16, 16)
    got = b.execute(m)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(to_numpy(got), np.fft.fft2(m), atol=2e-4 * 16)


@pytest.mark.parametrize("pad_to", [None, 2, 4])
def test_execute_many_matches_reference(pad_to):
    n = 32
    a, b = plans(n, "fpm", "fused", seed=5)
    ms = [complex_signal(10 + i, n, n) for i in range(3)]
    want = a.execute_many(ms, pad_to=pad_to)
    got = b.execute_many(ms, pad_to=pad_to)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == (n, n)
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4 * n)
    assert b.execute_many([]) == []
    with pytest.raises(ValueError, match="execute_many stacks"):
        b.execute_many([ms[0], ms[1][:, :-1]])


def test_with_schedule_swaps_the_executor():
    n = 64
    a, b = plans(n, "fpm", "library", seed=6, p=4)
    kws = [{"radix": 4}, {}, {"radix": 2}, {"radix": 4}]
    sa = ref_plan.SegmentSchedule.from_parts(
        n, a.d, None, [ref_plan.PlanConfig(**k) for k in kws])
    sb = port_plan.SegmentSchedule.from_parts(
        n, b.d, None, [port_plan.PlanConfig(**k) for k in kws])
    a2, b2 = a.with_schedule(sa), b.with_schedule(sb, tuning={"source": "swap"})
    assert b2.schedule == sb and b2.tuning == {"source": "swap"}
    assert b2.config.to_dict() == a2.config.to_dict()
    assert b.schedule != sb and b.tuning["source"] == "explicit"  # original kept
    assert len(b2._groups) == len(sb.batch_groups()) > 1
    m = complex_signal(7, n, n)
    np.testing.assert_allclose(to_numpy(b2.execute(to_torch(m))),
                               np.asarray(a2.execute(jnp.asarray(m))), atol=2e-4 * n)


def test_plan_holds_its_index_tensors_once():
    _, b = plans(32, "fpm-pad", "kernel", padding=True)
    assert len(b._groups) == len(b.schedule.batch_groups())
    before = [g[3] for g in b._groups]
    b.execute(to_torch(complex_signal(0, 32, 32)))
    assert all(x is y for x, y in zip(before, (g[3] for g in b._groups)))
    assert all(t.device == b.device for t in before)


@pytest.mark.parametrize("case", ["shape", "p", "fpms", "method", "tune", "dtype",
                                  "flags+config"])
def test_plan_errors_equal(case):
    def build(core, plan, sig):
        if case == "shape":
            return core.plan_pfft(8, p=2, method="lb", **dev(core)).execute(sig((9, 9)))
        if case == "p":
            return core.plan_pfft(8, method="lb", **dev(core))
        if case == "fpms":
            return core.plan_pfft(8, p=2, method="fpm", **dev(core))
        if case == "method":
            return core.plan_pfft(8, p=2, method="fft", **dev(core))
        if case == "tune":
            return core.plan_pfft(8, p=2, method="lb", tune="fast", **dev(core))
        if case == "dtype":
            return core.plan_pfft(8, p=2, method="lb", dtype="float32", **dev(core))
        return core.plan_pfft(8, p=2, method="lb", fused=True,
                              config=plan.PlanConfig(), **dev(core))

    def dev(core):
        return {"device": "cpu"} if core is port_core else {}

    with pytest.raises(ValueError):
        build(ref_core, ref_plan, lambda s: jnp.ones(s, jnp.complex64))
    with pytest.raises(ValueError):
        build(port_core, port_plan, lambda s: torch.ones(s, dtype=torch.complex64))


def test_plan_legacy_flags_warn_and_build_an_explicit_config():
    with pytest.warns(DeprecationWarning):
        a = ref_core.plan_pfft(16, p=2, method="lb", fused=True)
    with pytest.warns(DeprecationWarning):
        b = port_core.plan_pfft(16, p=2, method="lb", fused=True, device="cpu")
    same_plan(a, b)
    assert b.config.fused and b.tuning["source"] == "explicit"


@pytest.mark.parametrize("kwargs,names", [({"mesh": object()}, "distributed")])
def test_later_slices_raise_not_implemented(kwargs, names):
    """What is not ported yet is refused by name, never run as tune='off'."""
    args = {"p": 2, "method": "lb", "device": "cpu", **kwargs}
    with pytest.raises(NotImplementedError, match=names):
        port_core.plan_pfft(8, **args)


def test_plan_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_core.plan_pfft(8, p=2, method="lb")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_core.plan_pfft(8, p=2, method="lb", device="cuda")
    assert port_core.plan_pfft(8, p=2, method="lb", device="cpu").device.type == "cpu"


def test_plan_refuses_a_signal_on_another_device():
    plan = port_core.plan_pfft(8, p=2, method="lb", device="cpu")
    with pytest.raises(ValueError, match="plan lives on cpu"):
        plan.execute(torch.ones((8, 8), dtype=torch.complex64, device="meta"))


def test_package_exports_only_what_exists():
    for mod in (port_core, port_plan):
        for name in mod.__all__:
            assert hasattr(mod, name), name
    assert set(port_core.__all__) <= set(ref_core.__all__)
    assert set(port_plan.__all__) <= set(ref_plan.__all__)
    for later in ("plan_pfft3", "pfft1_large", "pfft3_lb"):
        assert later in ref_core.__all__ and not hasattr(port_core, later)


def port_sources():
    pkg = os.path.dirname(repro_torch.__file__)
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "examples", "quickstart_torch.py"),
             os.path.join(ROOT, "examples", "kernel_check_torch.py")]
    for base, _, names in os.walk(pkg):
        files += [os.path.join(base, f) for f in names if f.endswith(".py")]
    return sorted(files)


def test_port_imports_no_jax_and_nothing_of_the_reference():
    """Walk every source of the port (and the scripts that drive it) with
    ``ast``: no ``jax``, no ``repro`` — not even its numpy-only modules."""
    files = port_sources()
    assert len(files) > 20
    banned = {"jax", "jaxlib", "repro", "flax", "optax"}
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [alias.name.split(".")[0] for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]] if node.level == 0 else []
            else:
                continue
            assert not banned & set(roots), f"{path}:{node.lineno} imports {roots}"


def test_importing_the_port_loads_no_jax_builds_nothing_and_touches_no_cuda():
    code = (
        "import sys, os\n"
        "import repro_torch, repro_torch.core, repro_torch.fft, repro_torch.plan\n"
        "import repro_torch.kernels, repro_torch.convert\n"
        "import torch\n"
        "from repro_torch.kernels import _build\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
        "assert _build._library is None\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert done.returncode == 0 and "CLEAN" in done.stdout, done.stderr[-2000:]


def test_chip_smoke_fails_without_a_gpu():
    """``chip_smoke.py`` measures on the card: on a machine without one it
    exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300, env=env,
                          cwd=ROOT)
    assert done.returncode != 0
    assert '"ok": true' not in done.stdout
    assert "no CUDA device" in done.stderr
