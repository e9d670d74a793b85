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
    """A mesh that is not a DeviceMesh is refused by name, never run as
    tune='off' (``mesh=`` itself is ported: tests/test_torch_dist_plan.py)."""
    args = {"p": 2, "method": "lb", "device": "cpu", **kwargs}
    with pytest.raises(TypeError, match=names):
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
    for ported in ("plan_pfft3", "pfft1_large", "pfft3_lb"):
        assert ported in ref_core.__all__ and ported in port_core.__all__


def test_package_exports_the_reference_3d_mesh_names():
    """The 3-D mesh pipelines, their measure harness and their mesh builder
    are exported where the reference exports them."""
    import repro.launch.mesh as ref_mesh
    import repro_torch.launch as port_launch
    import repro_torch.launch.mesh as port_mesh
    for name in ("pfft3_distributed", "pfft3_pencil", "pfft3_slab"):
        assert name in ref_core.__all__ and name in port_core.__all__
    assert "measure_pfft3_configs" in ref_plan.__all__
    assert "measure_pfft3_configs" in port_plan.__all__
    assert "make_pfft3_mesh" in ref_mesh.__all__
    assert "make_pfft3_mesh" in port_mesh.__all__
    assert "make_pfft3_mesh" in port_launch.__all__
    for mod in (port_mesh, port_launch):
        for name in mod.__all__:
            assert hasattr(mod, name), name


def test_package_exports_the_reference_runtime_names():
    """``repro_torch.runtime`` exports the reference's ``__all__``, name for
    name, the lazy ``ResilientPlan`` included, and so does each module."""
    import repro.runtime as ref_runtime
    import repro_torch.runtime as port_runtime
    assert port_runtime.__all__ == ref_runtime.__all__
    for name in port_runtime.__all__:
        assert getattr(port_runtime, name) is not None, name
    for module in ("checkpoint", "elastic", "faults", "resilient", "straggler"):
        ref_mod = __import__(f"repro.runtime.{module}", fromlist=["__all__"])
        port_mod = __import__(f"repro_torch.runtime.{module}", fromlist=["__all__"])
        assert port_mod.__all__ == ref_mod.__all__, module
    with pytest.raises(AttributeError):
        port_runtime.NotAName


def test_package_exports_the_reference_lm_names():
    """The LM path exports the reference's names: ``models`` and ``data``
    all of them, the sharding specs and ``input_specs`` included,
    ``models.sharding`` the reference's and the port's layer on a mesh,
    ``launch.mesh`` ``make_local_mesh`` and ``make_production_mesh``,
    ``launch.roofline`` and ``launch.dryrun`` the reference's ``__all__``
    first (the dry-run's read off its source: importing it sets the
    reference's device count); ``train``, ``optim`` and
    ``launch.train`` all of theirs, ``models.transformer`` ``loss_fn`` too;
    ``models.attention``, ``models.moe``, ``models.xlstm`` and
    ``models.ssm`` add their modules (``GQA``, ``MLA``, ``MoE``,
    ``MLSTM``, ``SLSTM``, ``Mamba2``)."""
    import repro.configs as ref_configs
    import repro.data as ref_data
    import repro.launch.serve as ref_serve
    import repro.models as ref_models
    import repro.models.attention as ref_attn
    import repro.models.layers as ref_layers
    import repro.models.moe as ref_moe
    import repro.models.registry as ref_registry
    import repro.models.ssm as ref_ssm
    import repro.models.transformer as ref_transformer
    import repro.models.xlstm as ref_xlstm
    import repro.train as ref_train
    import repro_torch.configs as port_configs
    import repro_torch.data as port_data
    import repro_torch.launch.serve as port_serve
    import repro_torch.models as port_models
    import repro_torch.models.attention as port_attn
    import repro_torch.models.layers as port_layers
    import repro_torch.models.moe as port_moe
    import repro_torch.models.registry as port_registry
    import repro_torch.models.ssm as port_ssm
    import repro_torch.models.transformer as port_transformer
    import repro_torch.models.xlstm as port_xlstm
    import repro_torch.train as port_train
    import repro.launch.train as ref_launch_train
    import repro.optim as ref_optim
    import repro_torch.launch.train as port_launch_train
    import repro_torch.optim as port_optim

    import repro.launch.mesh as ref_mesh
    import repro.models.sharding as ref_sharding
    import repro_torch.launch.mesh as port_mesh
    import repro_torch.models.sharding as port_sharding

    assert port_models.__all__ == ref_models.__all__
    assert port_sharding.__all__[:len(ref_sharding.__all__)] == ref_sharding.__all__
    assert "make_local_mesh" in ref_mesh.__all__ and "make_local_mesh" in port_mesh.__all__
    assert port_transformer.__all__[:-1] == ref_transformer.__all__
    assert "loss_fn" in port_transformer.__all__
    assert port_data.__all__ == ref_data.__all__
    assert "make_production_mesh" in ref_mesh.__all__
    assert "make_production_mesh" in port_mesh.__all__
    import repro.launch.roofline as ref_roofline
    import repro_torch.launch.dryrun as port_dryrun
    import repro_torch.launch.roofline as port_roofline
    assert port_roofline.__all__[:len(ref_roofline.__all__)] == ref_roofline.__all__
    source = open(os.path.join(ROOT, "src/repro/launch/dryrun.py")).read()
    ref_dryrun_all = next(
        ast.literal_eval(node.value) for node in ast.parse(source).body
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "__all__")
    assert port_dryrun.__all__ == ref_dryrun_all
    assert port_launch_train.__all__ == ["run_training", "main"]
    for port, ref in ((port_configs, ref_configs), (port_serve, ref_serve),
                      (port_registry, ref_registry), (port_train, ref_train),
                      (port_optim, ref_optim),
                      (port_launch_train, ref_launch_train)):
        assert port.__all__ == ref.__all__
    assert set(ref_layers.__all__) <= set(port_layers.__all__)
    assert [n for n in port_attn.__all__ if n not in ("GQA", "MLA")] == \
        ref_attn.__all__
    assert [n for n in port_xlstm.__all__ if n not in ("MLSTM", "SLSTM")] == \
        ref_xlstm.__all__
    assert [n for n in port_ssm.__all__ if n != "Mamba2"] == ref_ssm.__all__
    assert [n for n in port_moe.__all__ if n != "MoE"] == ref_moe.__all__
    for mod in (port_configs, port_data, port_serve, port_models, port_attn,
                port_moe, port_xlstm, port_ssm, port_layers, port_registry,
                port_transformer, port_train, port_optim, port_launch_train,
                port_sharding, port_mesh, port_roofline, port_dryrun):
        for name in mod.__all__:
            assert hasattr(mod, name), name


def test_lm_serving_defaults_to_the_card_and_raises_without_one(monkeypatch):
    import repro_torch.launch.serve as port_serve
    import repro_torch.models as port_models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_models.get_smoke_config("qwen2_5_3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.serve_batch("qwen2_5_3b", batch=1, prompt_len=4, gen=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_models.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_models.init_cache(cfg, 1, 4)
    assert not torch.backends.cuda.matmul.allow_tf32


# An empty batch through the library configs (the reference's radix=4 and
# fused configs raise TypeError on it: not compared).
EMPTY_BATCHES = {
    "lb": ((0, 16, 16), "complex64"),
    "rfft-lb": ((0, 16, 16), "float32"),
    "pfft3": ((0, 8, 8, 8), "complex64"),
    "pfft1_large": ((0, 64), "complex64"),
}


def _empty_plan(core, case, **kw):
    if case == "pfft3":
        return core.plan_pfft3(8, **kw)
    if case == "pfft1_large":
        return core.plan_pfft1_large(64, **kw)
    return core.plan_pfft(16, p=2, method=case, dtype=EMPTY_BATCHES[case][1],
                          **kw)


@pytest.mark.parametrize("case", list(EMPTY_BATCHES))
def test_empty_batch_matches_reference(case):
    shape, dtype = EMPTY_BATCHES[case]
    want = _empty_plan(ref_core, case).execute(jnp.zeros(shape, dtype))
    got = _empty_plan(port_core, case, device="cpu").execute(
        torch.zeros(shape, dtype=getattr(torch, dtype)))
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)


@pytest.mark.parametrize("shape,n", [((0, 9), None), ((0, 4, 9), None),
                                     ((0, 9), 17)])
def test_irfft2_of_an_empty_spectrum_matches_reference(shape, n):
    want = ref_core.irfft2(jnp.zeros(shape, jnp.complex64), n=n)
    got = port_core.irfft2(torch.zeros(shape, dtype=torch.complex64), n=n)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)


def test_irfft2_of_a_one_bin_spectrum_raises_as_the_reference():
    """A (1, 1) half spectrum with no ``n`` means a signal of length 0."""
    for core, h in ((ref_core, jnp.zeros((1, 1), jnp.complex64)),
                    (port_core, torch.zeros((1, 1), dtype=torch.complex64))):
        with pytest.raises(ValueError, match="Shape should be positive."):
            core.irfft2(h)


def port_sources():
    pkg = os.path.dirname(repro_torch.__file__)
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "examples", "quickstart_torch.py"),
             os.path.join(ROOT, "examples", "kernel_check_torch.py"),
             os.path.join(ROOT, "examples", "pfft3_mesh_torch.py"),
             os.path.join(ROOT, "examples", "fft2d_pipeline_torch.py"),
             os.path.join(ROOT, "scripts", "gloo_cuda_collectives_probe.py")]
    files += [os.path.join(ROOT, "examples", name) for name in (
        "fft_convolution_torch.py", "pfft1_large_demo_torch.py",
        "serve_fft_demo_torch.py", "serve_lm_torch.py", "train_lm_torch.py")]
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
        "import repro_torch.kernels, repro_torch.convert, repro_torch.runtime\n"
        "from repro_torch.runtime import ResilientPlan\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.data\n"
        "import repro_torch.models.xlstm, repro_torch.models.ssm\n"
        "import repro_torch.train, repro_torch.launch.serve\n"
        "import repro_torch.optim, repro_torch.launch.train\n"
        "import repro_torch.models.sharding, repro_torch.launch.mesh\n"
        "import repro_torch.launch.roofline, repro_torch.launch.dryrun\n"
        "import repro_torch.data.specs\n"
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
