"""The host-side model core of the PyTorch port against the JAX package:
speed functions, partitioning, padding, plan configs and schedules.  These
modules are numpy-only in both packages, so the results must be **equal**, not
close, on seeded random FPMs (homogeneous and heterogeneous)."""

import dataclasses
import json

import numpy as np
import pytest

from _torch_parity import both_fpms, both_padding_fpms, fpm_arrays

import repro.core as ref_core
import repro.core.fpm as ref_fpm
import repro.core.padding as ref_padding
import repro.core.partition as ref_partition
import repro.plan as ref_plan
from repro.plan.pads import (czt_fft_lengths as ref_czt_fft_lengths,
                             fpm_pad_lengths as ref_fpm_pad_lengths,
                             rfft_pad_lengths as ref_rfft_pad_lengths)

import repro_torch.core as port_core
import repro_torch.core.fpm as port_fpm
import repro_torch.core.padding as port_padding
import repro_torch.core.partition as port_partition
import repro_torch.plan as port_plan
from repro_torch import convert
from repro_torch.plan.pads import czt_fft_lengths, fpm_pad_lengths, rfft_pad_lengths

SEEDS = [0, 1, 2]
KINDS = [True, False]  # heterogeneous, homogeneous


def same_partition(a, b):
    np.testing.assert_array_equal(a.d, b.d)
    assert a.method == b.method
    np.testing.assert_array_equal(a.tau, b.tau)  # equal, NaN == NaN
    np.testing.assert_array_equal(a.predicted_times, b.predicted_times)


# ------------------------------------------------------------------- fpm

@pytest.mark.parametrize("seed", SEEDS)
def test_speed_function_queries_equal(seed):
    n = 64
    ref, port = both_fpms(n, seed=seed)
    rng = np.random.default_rng(seed)
    for f_ref, f_port in zip(ref, port):
        for _ in range(20):
            x = float(rng.uniform(0, 1.2 * n))
            y = float(rng.uniform(n // 4, 2.5 * n))
            assert f_ref.speed_at(x, y) == f_port.speed_at(x, y)
            assert f_ref.time_at(x, y) == f_port.time_at(x, y)
        for y in (n // 2, n, n + 7, 2 * n, 3 * n):
            np.testing.assert_array_equal(f_ref.section_y(y), f_port.section_y(y))
            np.testing.assert_array_equal(f_ref.time_curve(n, y),
                                          f_port.time_curve(n, y))
        for x in (1, 5, n // 2, n, 2 * n):
            np.testing.assert_array_equal(f_ref.section_x(x), f_port.section_x(x))
        assert f_ref.time_at(0, n) == f_port.time_at(0, n) == 0.0


def test_speed_function_nan_points_equal():
    xs, ys, sp, _ = fpm_arrays(32, 1)[0]
    sp = sp.copy()
    sp[1, 2] = np.nan
    sp[-1, :] = np.nan
    a = ref_core.SpeedFunction(xs, ys, sp)
    b = port_core.SpeedFunction(xs, ys, sp)
    for y in ys.tolist() + [int(ys[1]) + 3]:
        np.testing.assert_array_equal(a.section_y(y), b.section_y(y))
        np.testing.assert_array_equal(a.time_curve(32, y), b.time_curve(32, y))
    assert a.time_at(32, ys[0]) == b.time_at(32, ys[0])


@pytest.mark.parametrize("bad", ["shape", "order", "negative"])
def test_speed_function_validation_equal(bad):
    xs, ys = np.array([1, 2, 4]), np.array([8, 16])
    sp = np.ones((3, 2))
    if bad == "shape":
        sp = np.ones((2, 2))
    elif bad == "order":
        xs = np.array([1, 4, 2])
    else:
        sp = -sp
    with pytest.raises(ValueError):
        ref_core.SpeedFunction(xs, ys, sp)
    with pytest.raises(ValueError):
        port_core.SpeedFunction(xs, ys, sp)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("hetero", KINDS)
def test_fpmset_averaged_and_variation_equal(seed, hetero):
    n = 48
    ref, port = both_fpms(n, p=4, hetero=hetero, seed=seed)
    assert ref.p == port.p == 4
    a, b = ref.averaged(), port.averaged()
    np.testing.assert_array_equal(a.speed, b.speed)
    assert a.name == b.name
    for y in (n // 2, n, n + 5, 2 * n):
        assert ref.max_variation_at_plane(y) == port.max_variation_at_plane(y)
    assert (port.max_variation_at_plane(n) == 0.0) == (not hetero)


def test_fft_flops_equal():
    x = np.array([0, 1, 7, 100]); y = np.array([1, 2, 48, 8192])
    np.testing.assert_array_equal(ref_fpm.fft_flops(x, y), port_fpm.fft_flops(x, y))


def test_build_fpm_equal():
    def timer(x, y):
        return float("nan") if (x, y) == (4, 32) else 1e-9 * x * y * (1 + (x + y) % 3)
    a = ref_core.build_fpm([1, 2, 4], [16, 32], timer, name="Q")
    b = port_core.build_fpm([1, 2, 4], [16, 32], timer, name="Q")
    np.testing.assert_array_equal(a.speed, b.speed)
    np.testing.assert_array_equal(a.xs, b.xs)
    assert a.name == b.name and np.isnan(b.speed[2, 1])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_fpm_files_cross_the_packages(writer, tmp_path):
    """``load_fpms`` of either package reads what ``save_fpms`` of the other
    wrote: one ``.npz`` + ``.json`` sidecar format."""
    ref, port = both_fpms(32, seed=5)
    path = str(tmp_path / "fpms.npz")
    if writer == "reference":
        ref_core.save_fpms(path, ref)
        back = port_core.load_fpms(path)
    else:
        port_core.save_fpms(path, port)
        back = ref_core.load_fpms(path)
    assert json.load(open(path + ".json")) == {"names": ["P0", "P1", "P2"]}
    assert back.p == 3
    for f, g in zip(back, port):
        np.testing.assert_array_equal(f.xs, g.xs)
        np.testing.assert_array_equal(f.ys, g.ys)
        np.testing.assert_array_equal(f.speed, g.speed)
        assert f.name == g.name


# ------------------------------------------------------------- partition

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [32, 96, 257])
def test_hpopta_equal(seed, n):
    ref, port = both_fpms(n, p=4, seed=seed)
    a = ref_partition.hpopta([f.time_curve(n, n) for f in ref], n)
    b = port_partition.hpopta([f.time_curve(n, n) for f in port], n)
    same_partition(a, b)
    assert b.d.sum() == n and b.method == "HPOPTA"


@pytest.mark.parametrize("seed", SEEDS)
def test_hpopta_tie_breaking_equal(seed):
    """Flat and stepped curves are full of ties: the witness must be the
    same one, not just one with the same makespan."""
    rng = np.random.default_rng(seed)
    n = 40
    curves = []
    for _ in range(3):
        steps = np.concatenate([[0.0], np.cumsum(rng.integers(0, 2, n))])
        curves.append(steps.astype(np.float64))
    same_partition(ref_partition.hpopta(curves, n), port_partition.hpopta(curves, n))


def test_hpopta_with_infeasible_points_equal():
    n = 24
    t = np.arange(n + 1, dtype=np.float64)
    t2 = t * 2.0
    t2[5:9] = np.inf
    same_partition(ref_partition.hpopta([t, t2, t * 0.5], n),
                   port_partition.hpopta([t, t2, t * 0.5], n))


@pytest.mark.parametrize("case", ["length", "t0", "all-inf"])
def test_hpopta_errors_equal(case):
    n = 8
    t = np.arange(n + 1, dtype=np.float64)
    if case == "length":
        curves = [t[:-1]]
    elif case == "t0":
        curves = [t + 1.0]
    else:
        bad = np.full(n + 1, np.inf); bad[0] = 0.0
        curves = [bad]
    with pytest.raises(ValueError):
        ref_partition.hpopta(curves, n)
    with pytest.raises(ValueError):
        port_partition.hpopta(curves, n)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p", [2, 5])
def test_popta_equal(seed, p):
    n = 80
    ref, port = both_fpms(n, p=1, seed=seed)
    a = ref_partition.popta(ref[0].time_curve(n, n), p, n)
    b = port_partition.popta(port[0].time_curve(n, n), p, n)
    same_partition(a, b)
    assert b.method == "POPTA"


@pytest.mark.parametrize("n,p", [(32, 4), (33, 4), (7, 3), (5, 8)])
def test_lb_partition_equal(n, p):
    same_partition(ref_partition.lb_partition(n, p), port_partition.lb_partition(n, p))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("hetero", KINDS)
@pytest.mark.parametrize("n", [32, 64, 96])
def test_partition_rows_equal(seed, hetero, n):
    ref, port = both_fpms(n, p=4, hetero=hetero, seed=seed)
    a = ref_partition.partition_rows(n, ref, 0.05)
    b = port_partition.partition_rows(n, port, 0.05)
    same_partition(a, b)
    assert b.method == ("HPOPTA" if hetero else "POPTA")


def test_partition_rows_large_uses_fft_convolution_equal():
    """Past 2^16 products the reachability convolution goes through
    scipy.signal.fftconvolve in both packages."""
    n = 600
    ref, port = both_fpms(n, p=3, seed=7)
    same_partition(ref_partition.partition_rows(n, ref, 0.05),
                   port_partition.partition_rows(n, port, 0.05))
    same_partition(ref_partition.partition_rows(n, ref, 0.05, y=n + n // 8),
                   port_partition.partition_rows(n, port, 0.05, y=n + n // 8))


# --------------------------------------------------------------- padding

@pytest.mark.parametrize("seed", SEEDS)
def test_determine_pad_length_equal(seed):
    n = 64
    ref, port = both_fpms(n, p=3, seed=seed)
    for f, g in zip(ref, port):
        for d_i in (0, 1, 9, n // 2, n):
            assert (ref_padding.determine_pad_length(f, d_i, n)
                    == port_padding.determine_pad_length(g, d_i, n))
            assert (ref_padding.predicted_time(f, d_i, n + 8)
                    == port_padding.predicted_time(g, d_i, n + 8))


@pytest.mark.parametrize("n", [1, 31, 100, 128, 1000, 4095, 8191])
@pytest.mark.parametrize("kwargs", [{}, {"lane": 32}, {"limit_ratio": 1.5}])
def test_smooth_candidates_equal(n, kwargs):
    np.testing.assert_array_equal(ref_padding.smooth_candidates(n, **kwargs),
                                  port_padding.smooth_candidates(n, **kwargs))


@pytest.mark.parametrize("n", [1, 100, 129, 1000])
def test_pad_to_smooth_and_is_smooth_equal(n):
    assert ref_padding.pad_to_smooth(n) == port_padding.pad_to_smooth(n)
    assert ref_padding.is_smooth(n) == port_padding.is_smooth(n)
    assert ref_padding.is_smooth(n, (2,)) == port_padding.is_smooth(n, (2,))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("hetero", KINDS)
def test_pad_length_selection_equal(seed, hetero):
    n = 64
    ref, port = both_fpms(n, p=4, hetero=hetero, seed=seed)
    d = port_partition.partition_rows(n, port, 0.05).d
    np.testing.assert_array_equal(ref_fpm_pad_lengths(ref, d, n),
                                  fpm_pad_lengths(port, d, n))
    np.testing.assert_array_equal(ref_czt_fft_lengths(ref, d, n),
                                  czt_fft_lengths(port, d, n))
    np.testing.assert_array_equal(ref_rfft_pad_lengths(ref, d, n),
                                  rfft_pad_lengths(port, d, n))


def test_pad_lengths_engage_on_peaked_fpms():
    n = 32
    ref, port = both_padding_fpms(n)
    d = port_partition.partition_rows(n, port, 0.05).d
    pads = fpm_pad_lengths(port, d, n)
    np.testing.assert_array_equal(pads, ref_fpm_pad_lengths(ref, d, n))
    assert (pads > n).any() and (pads == n).any()


# ------------------------------------------------------- config, schedule

CONFIG_KWARGS = [
    {}, {"radix": 2}, {"radix": 4}, {"fused": True}, {"radix": 4, "fused": True},
    {"batched": False}, {"pad": "fpm"}, {"pad": "czt", "radix": 4},
    {"pipeline_panels": 4}, {"real": True}, {"exchange": "hier"},
]


@pytest.mark.parametrize("kwargs", CONFIG_KWARGS)
def test_plan_config_views_equal(kwargs):
    a, b = ref_plan.PlanConfig(**kwargs), port_plan.PlanConfig(**kwargs)
    assert a.to_dict() == b.to_dict()
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(b)]
    assert a.describe() == b.describe()
    assert a.use_stockham == b.use_stockham
    assert a.dist_padded == b.dist_padded
    assert port_plan.PlanConfig.from_dict(a.to_dict()) == b
    assert ref_plan.PlanConfig.from_dict(b.to_dict()) == a
    assert convert.config_from_dict(a.to_dict()) == b
    assert hash(b) == hash(port_plan.PlanConfig(**kwargs))


@pytest.mark.parametrize("radix,backend", [(None, "torch"), (2, "stockham"),
                                           (4, "cuda")])
def test_plan_config_backend_vocabulary(radix, backend):
    """Same selector, the port's names: the reference says xla/stockham/
    pallas; ``radix`` travels only to the kernel backend in both."""
    a, b = ref_plan.PlanConfig(radix=radix), port_plan.PlanConfig(radix=radix)
    assert b.fft_backend == backend
    assert a.fft_backend == {"torch": "xla", "stockham": "stockham",
                             "cuda": "pallas"}[backend]
    assert b.row_fft_kwargs() == {"backend": backend,
                                  "radix": 4 if backend == "cuda" else None}
    assert a.row_fft_kwargs()["radix"] == b.row_fft_kwargs()["radix"]
    assert b.row_fft_kwargs("cuda") == {"backend": "cuda", "radix": radix}
    assert b.row_fft_kwargs("torch") == {"backend": "torch", "radix": None}


@pytest.mark.parametrize("kwargs", [
    {"radix": 3}, {"pad": "zero"}, {"exchange": "ring"}, {"pipeline_panels": 0},
    {"fused": True, "pad": "fpm"}, {"real": True, "pad": "czt"}])
def test_plan_config_validation_equal(kwargs):
    with pytest.raises(ValueError) as a:
        ref_plan.PlanConfig(**kwargs)
    with pytest.raises(ValueError) as b:
        port_plan.PlanConfig(**kwargs)
    assert str(a.value) == str(b.value)


def test_plan_config_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown PlanConfig fields"):
        port_plan.PlanConfig.from_dict({"radix": 4, "lanes": 128})


@pytest.mark.parametrize("flags", [{}, {"use_stockham": True}, {"fused": True},
                                   {"batched": False, "pad": "fpm"}])
def test_plan_config_from_flags_equal(flags):
    assert (ref_plan.PlanConfig.from_flags(**flags).to_dict()
            == port_plan.PlanConfig.from_flags(**flags).to_dict())


@pytest.mark.parametrize("pad", ["none", "fpm", "czt"])
@pytest.mark.parametrize("kwargs", [{}, {"radix": 4, "fused": True},
                                    {"pad": "czt"}, {"pad": "fpm", "radix": 2}])
def test_normalize_pad_equal(pad, kwargs):
    a = ref_plan.normalize_pad(ref_plan.PlanConfig(**kwargs), pad)
    b = port_plan.normalize_pad(port_plan.PlanConfig(**kwargs), pad)
    assert a.to_dict() == b.to_dict()
    assert b.pad == pad and (not b.fused or pad == "none")


def hetero_schedules(n=96):
    d = np.array([24, 0, 40, 32])
    pads = np.array([n, n, 128, 128])
    cfgs = [{"radix": None, "pad": "fpm"}, {"radix": 4, "pad": "fpm"},
            {"radix": 4, "pad": "fpm"}, {"radix": 4, "pad": "fpm", "batched": False}]
    a = ref_plan.SegmentSchedule.from_parts(
        n, d, pads, [ref_plan.PlanConfig(**c) for c in cfgs])
    b = port_plan.SegmentSchedule.from_parts(
        n, d, pads, [port_plan.PlanConfig(**c) for c in cfgs])
    return a, b, d, pads


def same_groups(ga, gb):
    assert len(ga) == len(gb)
    for (la, ca, ia), (lb, cb, ib) in zip(ga, gb):
        assert la == lb and ca.to_dict() == cb.to_dict()
        np.testing.assert_array_equal(ia, ib)
        assert ib.dtype == np.int64


def test_segment_schedule_heterogeneous_equal():
    a, b, d, pads = hetero_schedules()
    assert a.to_dict() == b.to_dict()
    assert a.describe() == b.describe()
    same_groups(a.batch_groups(), b.batch_groups())
    assert len(b) == 3 and b.total_rows == 96 and b.common_config is None
    assert a.anchor_config.to_dict() == b.anchor_config.to_dict()
    assert [c.to_dict() for c in a.configs] == [c.to_dict() for c in b.configs]
    for probe_d, probe_pads in ((d, pads), (d, None), (np.array([24, 40, 32]), pads),
                                (np.array([24, 0, 40, 31]), pads), (None, None)):
        assert a.matches(probe_d, probe_pads) == b.matches(probe_d, probe_pads)
    assert b.matches(d, pads)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kwargs", [{}, {"radix": 4}, {"batched": False},
                                    {"pad": "fpm", "radix": 4}])
def test_segment_schedule_homogeneous_equal(seed, kwargs):
    n = 64
    ref, port = both_fpms(n, p=4, seed=seed)
    d = port_partition.partition_rows(n, port, 0.05).d
    pads = fpm_pad_lengths(port, d, n) if kwargs.get("pad") == "fpm" else None
    a = ref_plan.SegmentSchedule.homogeneous(ref_plan.PlanConfig(**kwargs), n, d, pads)
    b = port_plan.SegmentSchedule.homogeneous(port_plan.PlanConfig(**kwargs), n, d, pads)
    assert a.to_dict() == b.to_dict() and a.describe() == b.describe()
    same_groups(a.batch_groups(), b.batch_groups())
    assert b.common_config == port_plan.PlanConfig(**kwargs)
    assert b.matches(d, pads) and a.matches(d, pads)
    whole_a = ref_plan.SegmentSchedule.homogeneous(ref_plan.PlanConfig(**kwargs), n)
    whole_b = port_plan.SegmentSchedule.homogeneous(port_plan.PlanConfig(**kwargs), n)
    assert whole_a.to_dict() == whole_b.to_dict() and whole_b.matches(None)


def test_segment_schedule_crosses_the_packages_as_a_dict():
    a, b, _, _ = hetero_schedules()
    assert convert.schedule_from_dict(a.to_dict()) == b
    assert port_plan.SegmentSchedule.from_dict(a.to_dict()) == b
    assert ref_plan.SegmentSchedule.from_dict(b.to_dict()) == a
    assert hash(convert.schedule_from_dict(a.to_dict())) == hash(b)


@pytest.mark.parametrize("case", ["empty", "order", "rows", "zero-rows", "config"])
def test_segment_schedule_validation_equal(case):
    def build(mod):
        cfg = mod.PlanConfig()
        plan = mod.SegmentPlan
        if case == "empty":
            return mod.SegmentSchedule(n=8, entries=())
        if case == "order":
            return mod.SegmentSchedule(n=8, entries=(plan(1, 2, 8, cfg), plan(0, 2, 8, cfg)))
        if case == "rows":
            return mod.SegmentSchedule(n=8, entries=(plan(0, 9, 8, cfg),))
        if case == "zero-rows":
            return plan(0, 0, 8, cfg)
        return plan(0, 1, 8, {"radix": 4})
    errors = []
    for mod in (ref_plan, port_plan):
        with pytest.raises((ValueError, TypeError)) as err:
            build(mod)
        errors.append((type(err.value), str(err.value)))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------- convert

def test_convert_fpms_and_partition_round_trip():
    arrays = fpm_arrays(32, 3, seed=4)
    fpms = convert.fpms_from_arrays(arrays)
    assert isinstance(fpms, port_core.FPMSet) and fpms.p == 3
    arrays[0][2][0, 0] = -1.0  # the converter copied: later edits don't reach it
    assert fpms[0].speed[0, 0] > 0
    ref = ref_core.FPMSet([ref_core.SpeedFunction(xs, ys, np.abs(sp), name=nm)
                           for xs, ys, sp, nm in arrays])
    part = ref_partition.partition_rows(32, ref, 0.05)
    mine = convert.partition_from_arrays(part.d, part.tau, part.method,
                                         part.predicted_times)
    assert isinstance(mine, port_core.PartitionResult)
    same_partition(part, mine)


def test_convert_signal_to_tensor(monkeypatch):
    import torch
    x = (np.arange(6).reshape(2, 3) * (1 + 2j)).astype(np.complex64)
    t = convert.signal_to_tensor(x, "cpu")
    assert t.dtype == torch.complex64 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), x)
    assert convert.signal_to_tensor(x.real.astype(np.float64), "cpu").dtype == torch.float64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.signal_to_tensor(x)
