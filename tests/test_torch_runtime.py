"""The runtime's building blocks of the port against the reference, in
process: ``repro_torch.runtime.faults`` (``repeated`` on the plain row-FFT
kernel, the injector, retries, wisdom chaos), ``straggler``
(``StragglerMonitor``'s EWMAs, slow groups, relative speeds, degraded FPMs
and HPOPTA re-partition, number for number), ``elastic``'s grid arithmetic
and ``reshard``, and ``checkpoint`` (``CheckpointManager``, with
checkpoints written by each package restored by the other, bf16 included).
The distributed half (``ResilientPlan``, rebuilt worlds, agreed retries,
the fault hook) is ``tests/test_torch_resilient.py``."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import ml_dtypes

from _torch_parity import complex_signal, to_numpy, to_torch

import repro.core as ref_core
import repro.plan.wisdom as ref_wisdom
import repro.runtime as ref_rt
from repro.runtime.checkpoint import CheckpointManager as RefCheckpointManager

import repro_torch.runtime as rt
from repro_torch import convert
from repro_torch.fft.fft2d import fft_rows
from repro_torch.plan import PlanConfig
from repro_torch.plan.wisdom import (load_wisdom, lookup_wisdom, record_wisdom,
                                     wisdom_key)
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import _row_axis

REPS = (1, 2, 3, 5, 8)


# ------------------------------------------------------------- repeated

@pytest.mark.parametrize("reps", REPS)
@pytest.mark.parametrize("n", [32, 256])
def test_repeated_is_bit_identical_on_the_plain_row_kernel(reps, n):
    """K1's plain version (``device="cpu"``, ``radix=4``) run ``reps`` times
    on rescaled inputs folds to one run's output bit for bit, and that
    output agrees with the reference's ``repeated`` over ``jnp.fft.fft``."""
    x = complex_signal(reps, 8, n)
    kernel = lambda b: fft_rows(b, backend="cuda", radix=4)  # noqa: E731
    got = rt.repeated(kernel, reps)(to_torch(x))
    assert torch.equal(got, kernel(to_torch(x)))
    want = np.asarray(jax.jit(ref_rt.repeated(jnp.fft.fft, reps))(jnp.asarray(x)))
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-3 * np.sqrt(n))


def test_repeated_reps_leq_one_is_identity():
    fn = lambda x: x  # noqa: E731
    for mod in (rt, ref_rt):
        assert mod.repeated(fn, 1) is fn
        assert mod.repeated(fn, 0) is fn


def test_repeated_runs_the_function_reps_times():
    calls = []
    rt.repeated(lambda x: calls.append(1) or x, 3)(torch.ones(2))
    assert len(calls) == 3


# ------------------------------------------------------------- injector

def _injector_trace(mod) -> list:
    inj = mod.FaultInjector()
    seen = [inj.epoch, inj.local_repeats(4)]
    inj.slow_group(2, 3)
    seen += [inj.epoch, inj.local_repeats(4), inj.repeat_for(2),
             inj.repeat_for(0), inj.active]
    inj.slow_group(2, 1)
    seen += [inj.epoch, inj.local_repeats(4), inj.active]
    inj.slow_group(1, 2.6)
    inj.fail_host(7, 1, 2)
    seen += [inj.local_repeats(4), inj.active]
    inj.clear()
    seen += [inj.epoch, inj.active, [e["kind"] for e in inj.log]]
    return seen


def test_injector_slow_group_epoch_and_repeats_match_reference():
    assert _injector_trace(rt) == _injector_trace(ref_rt)
    inj = rt.FaultInjector()
    inj.slow_group(2, 3)
    assert inj.local_repeats(4) == [1, 1, 3, 1]
    assert inj.epoch == 1


def test_injector_fail_execute_is_one_shot():
    for mod in (rt, ref_rt):
        inj = mod.FaultInjector()
        inj.fail_execute(5, lost=(1,))
        inj.check_execute(4)
        with pytest.raises(mod.DeviceLostError) as err:
            inj.check_execute(5)
        assert err.value.lost == (1,)
        inj.check_execute(5)
        assert not inj.active


def test_fail_host_and_lost_host_match_reference():
    from repro.runtime.faults import lost_host as ref_lost_host
    from repro_torch.runtime.faults import lost_host
    for host, local in [(0, 1), (1, 2), (3, 4)]:
        assert lost_host(host, local) == ref_lost_host(host, local)
    inj = rt.FaultInjector()
    inj.fail_host(2, 1, 2)
    with pytest.raises(rt.DeviceLostError) as err:
        inj.check_execute(2)
    assert err.value.lost == (2, 3)


@pytest.mark.parametrize("lost", [(), (3,), (0, 2)])
def test_device_lost_error_matches_reference(lost):
    a, b = rt.DeviceLostError(lost=lost), ref_rt.DeviceLostError(lost=lost)
    assert (a.lost, str(a)) == (b.lost, str(b))
    assert isinstance(a, RuntimeError)


def test_inject_context_clears_and_bumps_epoch():
    inj = rt.get_injector()
    e0 = inj.epoch
    with rt.inject() as scoped:
        assert scoped is inj
        scoped.slow_group(0, 4)
        assert scoped.active
    assert not inj.active
    assert inj.epoch > e0 + 1
    assert any(ev["kind"] == "slow_group" for ev in inj.log)


def test_injectors_are_separate_per_package():
    with rt.inject() as inj:
        inj.slow_group(1, 2)
        assert ref_rt.get_injector().local_repeats(4) is None


# ---------------------------------------------------------------- retry

def _retry_trace(mod) -> tuple:
    sleeps, calls = [], {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    got = mod.retry_with_backoff(flaky, attempts=3, base_s=0.05,
                                 sleep=sleeps.append)

    def always():
        raise ValueError("permanent")

    with pytest.raises(ValueError, match="permanent"):
        mod.retry_with_backoff(always, attempts=2, sleep=sleeps.append)
    with pytest.raises(KeyError):
        mod.retry_with_backoff(lambda: {}["x"], attempts=3,
                               exceptions=(OSError,), sleep=sleeps.append)
    return got, sleeps, calls["n"]


def test_retry_with_backoff_matches_reference():
    got = _retry_trace(rt)
    assert got == _retry_trace(ref_rt)
    assert got == ("ok", [0.05, 0.1, 0.05], 3)


# ---------------------------------------------------------- wisdom chaos

def _key():
    return wisdom_key(n=32, dtype="complex64", p=2, method="lb",
                      backend="cpu")


def test_corrupt_wisdom_is_a_miss_and_rewritable(tmp_path):
    path = str(tmp_path / "w.json")
    record_wisdom(path, _key(), PlanConfig(), mode="estimate")
    assert lookup_wisdom(path, _key()) is not None
    rt.corrupt_wisdom(path)
    assert load_wisdom(path) == {} and ref_wisdom.load_wisdom(path) == {}
    assert lookup_wisdom(path, _key()) is None
    record_wisdom(path, _key(), PlanConfig(radix=2), mode="estimate")
    plan, _ = lookup_wisdom(path, _key())
    assert plan == PlanConfig(radix=2)
    with open(path) as fh:
        json.load(fh)


def test_corrupt_wisdom_writes_what_the_reference_writes(tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    rt.corrupt_wisdom(a)
    ref_rt.corrupt_wisdom(b)
    assert open(a).read() == open(b).read()


@pytest.mark.parametrize("holder", ["port", "reference"])
def test_locked_wisdom_times_out_then_succeeds(tmp_path, holder):
    """Either package's held lock is the same ``.lock`` flock: the port's
    bounded writer times out while it is held and lands after release."""
    pytest.importorskip("fcntl")
    path = str(tmp_path / "w.json")
    locked = rt.locked_wisdom if holder == "port" else ref_rt.locked_wisdom
    with locked(path):
        with pytest.raises(TimeoutError, match="still held"):
            record_wisdom(path, _key(), PlanConfig(), mode="estimate",
                          lock_timeout_s=0.2)
    record_wisdom(path, _key(), PlanConfig(), mode="estimate",
                  lock_timeout_s=0.2)
    assert lookup_wisdom(path, _key()) is not None


def test_locked_wisdom_blocking_default_waits(tmp_path):
    pytest.importorskip("fcntl")
    path = str(tmp_path / "w.json")
    release, done = threading.Event(), threading.Event()

    def holder():
        with rt.locked_wisdom(path):
            release.set()
            done.wait(5.0)

    threading.Thread(target=holder, daemon=True).start()
    assert release.wait(5.0)
    writer_done = []

    def writer():
        record_wisdom(path, _key(), PlanConfig(), mode="estimate")
        writer_done.append(True)

    w = threading.Thread(target=writer, daemon=True)
    w.start()
    time.sleep(0.1)
    assert not writer_done
    done.set()
    w.join(5.0)
    assert writer_done and lookup_wisdom(path, _key()) is not None


# ------------------------------------------------------------- straggler

def _monitors(n_groups, **kw):
    return rt.StragglerMonitor(n_groups, **kw), ref_rt.StragglerMonitor(n_groups, **kw)


def _same_monitor(a, b):
    np.testing.assert_array_equal(a.ewma, b.ewma)
    assert a.slow_groups() == b.slow_groups()
    np.testing.assert_array_equal(a.relative_speeds(), b.relative_speeds())


def _speed_function(mod, xs, ys, speed):
    return mod.SpeedFunction(np.array(xs), np.array(ys), np.array(speed, float))


def test_straggler_detects_slow_group():
    a, b = _monitors(4, threshold=1.3)
    for _ in range(10):
        for g in range(4):
            for mon in (a, b):
                mon.record(g, 1.0 if g != 2 else 2.0)
    _same_monitor(a, b)
    assert a.slow_groups() == [2]
    assert a.relative_speeds()[2] == pytest.approx(0.5, rel=0.05)


@pytest.mark.parametrize("seed", range(6))
def test_straggler_monitor_matches_reference_on_random_steps(seed):
    """Seeded step times, a random straggler and warm-up gaps: EWMAs, slow
    groups, relative speeds and degraded FPMs equal number for number."""
    rng = np.random.default_rng(seed)
    p = int(rng.integers(2, 7))
    a, b = _monitors(p, alpha=float(rng.uniform(0.1, 0.9)),
                     threshold=float(rng.uniform(1.1, 2.0)))
    slow = int(rng.integers(p))
    for step in range(12):
        for g in range(p):
            if step == 0 and g == p - 1:
                continue                      # one group still unsampled
            t = float(rng.uniform(0.8, 1.2)) * (3.0 if g == slow and step > 4 else 1.0)
            a.record(g, t)
            b.record(g, t)
        _same_monitor(a, b)
    xs, ys = [1, 8, 16], [16, 32]
    speed = rng.uniform(1e8, 1e9, size=(3, 2))
    da = a.degraded_fpms(convert.fpms_from_arrays([(xs, ys, speed, "P")])[0])
    db = b.degraded_fpms(_speed_function(ref_core, xs, ys, speed))
    assert da.p == db.p == p
    for fa, fb in zip(da, db):
        np.testing.assert_array_equal(fa.speed, fb.speed)
        assert fa.name == fb.name


def test_straggler_repartition_shifts_work():
    a, b = _monitors(2, threshold=1.3)
    for _ in range(5):
        for mon in (a, b):
            mon.record(0, 1.0)
            mon.record(1, 3.0)
    xs, ys = [1, 16, 32, 64], [64, 128]
    speed = np.outer(xs, [1, 1.05]) + 1
    ra = a.repartition(convert.fpms_from_arrays([(xs, ys, speed, "P")])[0],
                       n_rows=64, y=128)
    rb = b.repartition(_speed_function(ref_core, xs, ys, speed), n_rows=64, y=128)
    np.testing.assert_array_equal(ra.d, rb.d)
    assert (ra.tau, ra.method) == (rb.tau, rb.method)
    assert ra.d[0] > ra.d[1] and ra.d.sum() == 64


def test_straggler_no_action_when_healthy():
    a, b = _monitors(3)
    for _ in range(5):
        for g in range(3):
            a.record(g, 1.0)
            b.record(g, 1.0)
    base = convert.fpms_from_arrays([([1, 8], [16], np.ones((2, 1)), "P")])[0]
    assert a.repartition(base, 8, 16) is None
    assert b.repartition(_speed_function(ref_core, [1, 8], [16], np.ones((2, 1))),
                         8, 16) is None


def test_straggler_relative_speeds_before_warmup():
    a, b = _monitors(4)
    np.testing.assert_array_equal(a.relative_speeds(), np.ones(4))
    for mon in (a, b):
        mon.record(0, 2.0)
        mon.record(1, 1.0)
    _same_monitor(a, b)
    rel = a.relative_speeds()
    assert not np.any(np.isnan(rel)) and rel[0] < rel[1]
    np.testing.assert_array_equal(rel[2:], [1.0, 1.0])


def test_straggler_reset_forgets_drift():
    a, b = _monitors(2, threshold=1.3)
    for mon in (a, b):
        for _ in range(5):
            mon.record(0, 1.0)
            mon.record(1, 3.0)
        assert mon.slow_groups() == [1]
        mon.reset()
    _same_monitor(a, b)
    assert a.slow_groups() == []


def test_straggler_degraded_fpms_per_group_scaling():
    a, b = _monitors(2)
    for _ in range(8):
        for mon in (a, b):
            mon.record(0, 1.0)
            mon.record(1, 2.0)
    xs, ys, speed = [1, 8], [16, 32], np.full((2, 2), 1e9)
    base = convert.fpms_from_arrays([(xs, ys, speed, "P0"), (xs, ys, 2 * speed, "P1")])
    ref_base = ref_core.FPMSet([_speed_function(ref_core, xs, ys, speed),
                                _speed_function(ref_core, xs, ys, 2 * speed)])
    da, db = a.degraded_fpms(base), b.degraded_fpms(ref_base)
    for fa, fb in zip(da, db):
        np.testing.assert_array_equal(fa.speed, fb.speed)
    np.testing.assert_allclose(da[1].speed / da[0].speed, 1.0, rtol=1e-6)


# --------------------------------------------------------------- elastic

@pytest.mark.parametrize("model_axis", list(range(1, 18)) + [32, 64])
def test_largest_grid_matches_reference(model_axis):
    for n in range(1, 70):
        got = rt.largest_grid(n, model_axis)
        assert got == ref_rt.largest_grid(n, model_axis)
        data, model = got
        assert data >= 1 and model >= 1 and data * model <= max(n, 1)


@pytest.mark.parametrize("n", [1, 7, 48, 64, 96, 97, 210, 1000, 4096, 8192])
def test_largest_fft_axis_matches_reference(n):
    for devices in range(1, 33):
        got = rt.largest_fft_axis(devices, n)
        assert got == ref_rt.largest_fft_axis(devices, n)
        assert n % got == 0 and got <= max(devices, 1)


def test_largest_grid_and_fft_axis_known_values():
    assert rt.largest_grid(512, 16) == (32, 16)
    assert rt.largest_grid(8, 16) == (1, 8)
    assert rt.largest_grid(7, 16) == (1, 4)
    assert rt.largest_fft_axis(3, 8192) == 2
    assert rt.largest_fft_axis(7, 48) == 6
    assert rt.largest_fft_axis(4, 7) == 1


def test_rebuild_result_fields_match_reference():
    import dataclasses
    assert ([f.name for f in dataclasses.fields(rt.RebuildResult)]
            == [f.name for f in dataclasses.fields(ref_rt.RebuildResult)])


@pytest.mark.parametrize("spec,axis", [(None, None), ((), None), ("fft", "fft"),
                                       (("fft",), "fft"), (("fft", None), "fft"),
                                       ((None, None), None)])
def test_reshard_spec_names_the_row_axis(spec, axis):
    assert _row_axis(spec) == axis


def test_reshard_refuses_a_split_past_the_rows():
    with pytest.raises(ValueError, match="leading dimension"):
        _row_axis((None, "fft"))


# ------------------------------------------------------------ checkpoint

def _port_tree():
    return {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16) * 1.5,
                  "d": [torch.tensor(7, dtype=torch.int32), torch.zeros(2)]},
            "e": (np.arange(3, dtype=np.int64),
                  torch.from_numpy(complex_signal(0, 2, 3)))}


def _ref_tree():
    return {"a": jnp.arange(10, dtype=jnp.float32),
            "b": {"c": jnp.ones((3, 4), jnp.bfloat16) * 1.5,
                  "d": [jnp.int32(7), jnp.zeros(2)]},
            "e": (jnp.arange(3, dtype=jnp.int32),
                  jnp.asarray(complex_signal(0, 2, 3)))}


def _leaves_f64(tree) -> list:
    from repro_torch.runtime._tree import tree_leaves_with_keys
    out = []
    for key, leaf in tree_leaves_with_keys(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.to(torch.complex128 if leaf.is_complex() else torch.float64)
        out.append((key, np.asarray(leaf, dtype=np.complex128)))
    return out


def test_checkpoint_roundtrip_exact(tmp_path):
    tree = _port_tree()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, tree, extra={"note": "x"})
    assert mgr.latest_step() == 5
    restored, extra = mgr.restore(5, tree)
    assert extra == {"note": "x"}
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert isinstance(restored["e"], tuple) and isinstance(restored["b"]["d"], list)
    for (ka, a), (kb, b) in zip(_leaves_f64(tree), _leaves_f64(restored)):
        assert ka == kb
        np.testing.assert_array_equal(a, b)


def test_checkpoint_layout_matches_reference(tmp_path):
    """The same state saved by both packages: the same step directory, the
    same npz keys (bf16 under its suffix) and the same meta."""
    CheckpointManager(str(tmp_path / "port")).save(3, _port_tree(), extra={"k": 1})
    RefCheckpointManager(str(tmp_path / "ref")).save(3, _ref_tree(), extra={"k": 1})
    names = [sorted(os.listdir(tmp_path / side)) for side in ("port", "ref")]
    assert names[0] == names[1] == ["step_000000000003"]
    files = []
    for side in ("port", "ref"):
        step = tmp_path / side / "step_000000000003"
        with np.load(step / "arrays.npz") as data:
            files.append((sorted(data.files),
                          data["b__SLASH__c__BF16__"].dtype,
                          json.load(open(step / "meta.json"))))
    assert files[0] == files[1]
    assert files[0][1] == np.uint16


def test_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path):
    tree = _port_tree()
    CheckpointManager(str(tmp_path)).save(1, tree, extra={"from": "port"})
    restored, extra = RefCheckpointManager(str(tmp_path)).restore(
        1, jax.eval_shape(_ref_tree))
    assert extra == {"from": "port"}
    assert restored["b"]["c"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(np.asarray(restored["b"]["c"], np.float32),
                                  np.full((3, 4), 1.5, np.float32))
    np.testing.assert_array_equal(restored["e"][1], complex_signal(0, 2, 3))
    np.testing.assert_array_equal(restored["a"], np.arange(10, dtype=np.float32))


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path):
    RefCheckpointManager(str(tmp_path)).save(2, _ref_tree(), extra={"from": "ref"})
    like = _port_tree()
    restored, extra = CheckpointManager(str(tmp_path)).restore(2, like)
    assert extra == {"from": "ref"}
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], like["b"]["c"])
    assert torch.equal(restored["e"][1], like["e"][1])
    assert int(restored["b"]["d"][0]) == 7
    np.testing.assert_array_equal(restored["e"][0], [0, 1, 2])


def test_checkpoint_restores_into_meta_tensors_on_the_host(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    restored, _ = mgr.restore(1, {"w": torch.empty(2, 3, device="meta")})
    assert restored["w"].device.type == "cpu"
    assert torch.equal(restored["w"], tree["w"])


def test_checkpoint_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.zeros(1)})
    assert mgr.steps() == [3, 4]


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"x": torch.arange(5)}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_checkpoint_atomic_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, {"x": torch.zeros(4)})
    assert all(not n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_checkpoint_async_write_failure_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    real_write = mgr._write

    def boom(step, flat, meta):
        raise OSError("disk full")

    mgr._write = boom
    mgr.save(1, {"x": torch.zeros(2)}, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()
    mgr._write = real_write
    mgr.save(2, {"x": torch.zeros(2)}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 2


def test_checkpoint_async_write_failure_surfaces_on_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)

    def boom(step, flat, meta):
        raise OSError("quota exceeded")

    mgr._write = boom
    mgr.save(1, {"x": torch.zeros(2)}, blocking=False)
    if mgr._thread is not None:
        mgr._thread.join()
    with pytest.raises(OSError, match="quota exceeded"):
        mgr.save(2, {"x": torch.zeros(2)}, blocking=False)


def test_checkpoint_steps_skips_stray_dirnames(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(3, {"x": torch.zeros(1)})
    mgr.save(11, {"x": torch.zeros(1)})
    for stray in ("step_backup", "step_5~", "step_000000000007.tmp", "notes.txt"):
        os.makedirs(tmp_path / stray)
    assert mgr.steps() == [3, 11]
    assert mgr.latest_step() == 11
