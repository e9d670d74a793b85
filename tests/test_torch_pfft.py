"""``core/pfft.py`` of the PyTorch port against the JAX package: dispatch
grouping, the segment executor, the four methods and the chirp-Z transform.
Same numpy signal and the same FPMs to both; the port on CPU tensors.

Tolerance: outputs of a 2-D DFT of unit-variance noise have magnitude ~N;
float32 with another summation order gives ``atol = 2e-4 * N`` (the reference
suite itself allows 2e-2 at N = 64)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_parity import (both_fpms, both_padding_fpms, complex_signal,
                           to_numpy, to_torch)

import repro.core.pfft as ref_pfft
import repro.plan as ref_plan

import repro_torch.core.pfft as port_pfft
import repro_torch.plan as port_plan
from repro_torch import kernels as port_kernels

CONFIGS = {"library": {}, "stockham": {"radix": 2}, "kernel": {"radix": 4},
           "fused": {"fused": True}}
SIZES = [32, 64, 96]


def configs(name):
    return ref_plan.PlanConfig(**CONFIGS[name]), port_plan.PlanConfig(**CONFIGS[name])


def close(got, want, n):
    got, want = to_numpy(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=2e-4 * n)


# ----------------------------------------------------------------- grouping

@pytest.mark.parametrize("pads", [None, [64, 80, 64, 128], [96, 96, 96, 96]])
def test_plan_segment_batches_by_length_equal(pads):
    d = np.array([10, 0, 30, 24])
    a = ref_pfft.plan_segment_batches(d, pads, 64)
    b = port_pfft.plan_segment_batches(d, pads, 64)
    assert list(a) == list(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_plan_segment_batches_by_config_equal():
    d = np.array([10, 6, 30, 18])
    pads = [64, 64, 128, 128]
    kws = [{}, {"radix": 4}, {"radix": 4}, {"radix": 4, "batched": False}]
    a = ref_pfft.plan_segment_batches(d, pads, 64,
                                      [ref_plan.PlanConfig(**k) for k in kws])
    b = port_pfft.plan_segment_batches(d, pads, 64,
                                       [port_plan.PlanConfig(**k) for k in kws])
    assert len(a) == len(b) == 4
    for (ka, ia), (kb, ib) in zip(a.items(), b.items()):
        assert ka[0] == kb[0] and ka[1].to_dict() == kb[1].to_dict()
        assert ka[2:] == kb[2:]
        np.testing.assert_array_equal(ia, ib)


def test_device_groups_hold_index_tensors_on_the_device():
    sched = port_plan.SegmentSchedule.homogeneous(
        port_plan.PlanConfig(), 16, np.array([4, 12]), [16, 32])
    groups = port_pfft.device_groups(sched, torch.device("cpu"))
    assert [(g[0], len(g[2])) for g in groups] == [(16, 4), (32, 12)]
    for _, _, idx, idx_t in groups:
        assert idx_t.dtype == torch.int64 and idx_t.device.type == "cpu"
        np.testing.assert_array_equal(idx_t.numpy(), idx)


# --------------------------------------------------------- segment executor

@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_segment_row_ffts_homogeneous_matches_reference(config):
    rcfg, pcfg = configs(config)  # fused is a limb notion: rows run unfused
    m = complex_signal(1, 24, 64)
    d = np.array([10, 0, 8, 6])
    want = ref_pfft.segment_row_ffts(jnp.asarray(m), d, config=rcfg)
    got = port_pfft.segment_row_ffts(to_torch(m), d, config=pcfg)
    close(got, want, 64)


def test_segment_row_ffts_heterogeneous_schedule_matches_reference():
    """Library, Stockham and kernel segments at three lengths (one of them
    not a power of two, one Bluestein) in one phase."""
    n, d = 64, np.array([20, 12, 0, 16, 16])
    pads = [64, 128, 64, 80, 128]
    kws = [{"pad": "fpm"}, {"radix": 4, "pad": "fpm"}, {"pad": "fpm"},
           {"radix": 4, "pad": "fpm"}, {"radix": 2, "pad": "fpm"}]
    a = ref_plan.SegmentSchedule.from_parts(n, d, pads, [ref_plan.PlanConfig(**k) for k in kws])
    b = port_plan.SegmentSchedule.from_parts(n, d, pads, [port_plan.PlanConfig(**k) for k in kws])
    assert a.to_dict() == b.to_dict()
    m = complex_signal(2, n, n)
    want = ref_pfft.segment_row_ffts(jnp.asarray(m), d, schedule=a)
    got = port_pfft.segment_row_ffts(to_torch(m), d, schedule=b)
    close(got, want, n)
    pre = port_pfft.device_groups(b, torch.device("cpu"))
    again = port_pfft.segment_row_ffts(to_torch(m), d, schedule=b, groups=pre)
    np.testing.assert_array_equal(to_numpy(again), to_numpy(got))


def test_segment_row_ffts_czt_schedule_matches_reference():
    n, d = 48, np.array([30, 18])
    a = ref_plan.SegmentSchedule.homogeneous(ref_plan.PlanConfig(pad="czt"), n, d, [128, 96])
    b = port_plan.SegmentSchedule.homogeneous(port_plan.PlanConfig(pad="czt"), n, d, [128, 96])
    m = complex_signal(3, n, n)
    want = ref_pfft.segment_row_ffts(jnp.asarray(m), d, schedule=a)
    got = port_pfft.segment_row_ffts(to_torch(m), d, schedule=b)
    close(got, want, n)
    np.testing.assert_allclose(to_numpy(got), np.fft.fft(m, axis=-1), atol=2e-4 * n)


def test_segment_row_ffts_backend_override_forces_the_kernel_op(monkeypatch):
    from repro_torch.kernels.fft import ops
    calls = []
    real_op = ops.fft_rows_op
    monkeypatch.setattr(ops, "fft_rows_op",
                        lambda m, **kw: calls.append(m.shape) or real_op(m, **kw))
    m = complex_signal(5, 8, 64)
    want = ref_pfft.segment_row_ffts(jnp.asarray(m), np.array([5, 3]), backend="pallas")
    got = port_pfft.segment_row_ffts(to_torch(m), np.array([5, 3]), backend="cuda")
    close(got, want, 64)
    assert calls == [(8, 64)]  # one group in order: one dispatch, no gather


@pytest.mark.parametrize("case", ["sum", "schedule-rows", "both", "legacy+config"])
def test_segment_row_ffts_errors_equal(case):
    m = complex_signal(0, 8, 16)

    def call(mod, plan, arr):
        d = np.array([5, 3])
        if case == "sum":
            return mod.segment_row_ffts(arr, np.array([5, 2]))
        sched = plan.SegmentSchedule.homogeneous(plan.PlanConfig(), 16, np.array([4, 3]))
        if case == "schedule-rows":
            return mod.segment_row_ffts(arr, d, schedule=sched)
        if case == "both":
            return mod.segment_row_ffts(arr, d, schedule=sched, config=plan.PlanConfig())
        return mod.segment_row_ffts(arr, d, config=plan.PlanConfig(), batched=False)

    with pytest.raises(ValueError) as a:
        call(ref_pfft, ref_plan, jnp.asarray(m))
    with pytest.raises(ValueError) as b:
        call(port_pfft, port_plan, to_torch(m))
    assert str(a.value) == str(b.value)


def test_legacy_flags_warn_like_reference():
    m = complex_signal(0, 8, 16)
    d = np.array([5, 3])
    with pytest.warns(DeprecationWarning, match="use_stockham"):
        want = ref_pfft.segment_row_ffts(jnp.asarray(m), d, use_stockham=True)
    with pytest.warns(DeprecationWarning, match="use_stockham"):
        got = port_pfft.segment_row_ffts(to_torch(m), d, use_stockham=True)
    close(got, want, 16)
    with pytest.warns(DeprecationWarning, match="fused"):
        got = port_pfft.pfft_lb(to_torch(complex_signal(1, 16, 16)), 2, fused=True)
    np.testing.assert_allclose(to_numpy(got), np.fft.fft2(complex_signal(1, 16, 16)),
                               atol=2e-4 * 16)


# ------------------------------------------------------------------ methods

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_pfft_lb_matches_reference(n, config):
    rcfg, pcfg = configs(config)
    m = complex_signal(n, n, n)
    want = ref_pfft.pfft_lb(jnp.asarray(m), 3, config=rcfg)
    got = port_pfft.pfft_lb(to_torch(m), 3, config=pcfg)
    assert got.is_contiguous()
    close(got, want, n)
    np.testing.assert_allclose(to_numpy(got), np.fft.fft2(m), atol=2e-4 * n)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("hetero", [True, False])
def test_pfft_fpm_matches_reference(n, config, hetero):
    rcfg, pcfg = configs(config)
    ref_fpms, port_fpms = both_fpms(n, p=4, hetero=hetero, seed=n)
    m = complex_signal(n + 1, n, n)
    want, part_r = ref_pfft.pfft_fpm(jnp.asarray(m), ref_fpms, config=rcfg,
                                     return_partition=True)
    got, part_p = port_pfft.pfft_fpm(to_torch(m), port_fpms, config=pcfg,
                                     return_partition=True)
    np.testing.assert_array_equal(part_r.d, part_p.d)
    assert part_r.method == part_p.method
    close(got, want, n)


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("config", ["library", "stockham", "kernel"])
def test_pfft_fpm_pad_matches_reference(n, config):
    """Padded-signal-cropped semantics, with pads that really engage (2N,
    a power of two: the kernel config runs its padded groups in the kernel's
    plain version)."""
    rcfg, pcfg = configs(config)
    ref_fpms, port_fpms = both_padding_fpms(n)
    m = complex_signal(n + 2, n, n)
    want, part_r, pads_r = ref_pfft.pfft_fpm_pad(jnp.asarray(m), ref_fpms, config=rcfg,
                                                 return_partition=True)
    got, part_p, pads_p = port_pfft.pfft_fpm_pad(to_torch(m), port_fpms, config=pcfg,
                                                 return_partition=True)
    np.testing.assert_array_equal(part_r.d, part_p.d)
    np.testing.assert_array_equal(pads_r, pads_p)
    assert (pads_p > n).any()
    close(got, want, n)
    # not the exact DFT: the padded method interpolates the spectrum
    assert np.abs(to_numpy(got) - np.fft.fft2(m)).max() > 1e-3


@pytest.mark.parametrize("n", SIZES)
def test_pfft_fpm_pad_random_fpms_match_reference(n):
    ref_fpms, port_fpms = both_fpms(n, p=4, seed=n + 3)
    m = complex_signal(n + 4, n, n)
    want, _, pads_r = ref_pfft.pfft_fpm_pad(jnp.asarray(m), ref_fpms,
                                            return_partition=True)
    got, _, pads_p = port_pfft.pfft_fpm_pad(to_torch(m), port_fpms,
                                            return_partition=True)
    np.testing.assert_array_equal(pads_r, pads_p)
    close(got, want, n)


@pytest.mark.parametrize("drifted", [{"pad": "czt"}, {"pad": "none"},
                                     {"radix": 4, "fused": True}])
def test_pfft_fpm_pad_normalizes_explicit_config_pad(drifted):
    """The method owns the pad strategy: a drifted config still runs the
    paper's padded-signal crop, as in the reference."""
    n = 32
    ref_fpms, port_fpms = both_padding_fpms(n)
    m = complex_signal(6, n, n)
    want = ref_pfft.pfft_fpm_pad(jnp.asarray(m), ref_fpms,
                                 config=ref_plan.PlanConfig(**drifted))
    got = port_pfft.pfft_fpm_pad(to_torch(m), port_fpms,
                                 config=port_plan.PlanConfig(**drifted))
    close(got, want, n)
    base = port_pfft.pfft_fpm_pad(to_torch(m), port_fpms)
    np.testing.assert_allclose(to_numpy(got), to_numpy(base), atol=2e-4 * n)


@pytest.mark.parametrize("n", SIZES)
def test_pfft_fpm_czt_matches_reference(n):
    ref_fpms, port_fpms = both_fpms(n, p=3, seed=n + 5)
    m = complex_signal(n + 6, n, n)
    want, part_r, lens_r = ref_pfft.pfft_fpm_czt(jnp.asarray(m), ref_fpms,
                                                 return_partition=True)
    got, part_p, lens_p = port_pfft.pfft_fpm_czt(to_torch(m), port_fpms,
                                                 return_partition=True)
    np.testing.assert_array_equal(part_r.d, part_p.d)
    np.testing.assert_array_equal(lens_r, lens_p)
    close(got, want, n)
    np.testing.assert_allclose(to_numpy(got), np.fft.fft2(m), atol=2e-4 * n)


def test_limb_rejects_non_square_like_reference():
    with pytest.raises(ValueError, match="square N x N"):
        ref_pfft.pfft_lb(jnp.ones((4, 8), jnp.complex64), 2)
    with pytest.raises(ValueError, match="square N x N"):
        port_pfft.pfft_lb(torch.ones((4, 8), dtype=torch.complex64), 2)


def test_limb_accepts_a_transposed_view():
    """The kernel ops refuse non-contiguous input; the limb makes the copy."""
    m = complex_signal(7, 32, 32)
    got = port_pfft.pfft_lb(to_torch(m).T, 2, config=port_plan.PlanConfig(radix=4))
    np.testing.assert_allclose(to_numpy(got), np.fft.fft2(m.T), atol=2e-4 * 32)


@pytest.mark.parametrize("config,expect_k1,expect_k2", [
    ("library", 0, 0), ("stockham", 0, 0), ("kernel", 2, 0), ("fused", 0, 2)])
def test_limb_routes_configs_to_the_right_op(config, expect_k1, expect_k2, monkeypatch):
    """radix=4 reaches the row-FFT op twice (one group, two phases), fused the
    fused op twice, phase 2 letting it pad its output's row stride;
    radix=2 + fused still runs the fused op, at its own radix."""
    from repro_torch.kernels.fft import ops as k1
    from repro_torch.kernels.fused import ops as k2
    calls = {"k1": [], "k2": []}
    real1, real2 = k1.fft_rows_op, k2.fft_rows_transpose_op
    monkeypatch.setattr(k1, "fft_rows_op",
                        lambda m, **kw: calls["k1"].append(kw) or real1(m, **kw))
    monkeypatch.setattr(k2, "fft_rows_transpose_op",
                        lambda m, **kw: calls["k2"].append(kw) or real2(m, **kw))
    m = to_torch(complex_signal(8, 32, 32))
    port_pfft.pfft_lb(m, 4, config=port_plan.PlanConfig(**CONFIGS[config]))
    assert (len(calls["k1"]), len(calls["k2"])) == (expect_k1, expect_k2)
    assert all(kw == {"radix": 4} for kw in calls["k1"])
    def phases(radix):
        return [{"radix": radix, "pad_stride": False}, {"radix": radix, "pad_stride": True}]
    assert calls["k2"] == phases(None)[:expect_k2]
    calls["k2"].clear()
    port_pfft.pfft_lb(m, 4, config=port_plan.PlanConfig(radix=2, fused=True))
    assert calls["k2"] == phases(None)
    calls["k2"].clear()
    port_pfft.pfft_lb(m, 4, config=port_plan.PlanConfig(radix=4, fused=True))
    assert calls["k2"] == phases(4)


def test_cpu_limbs_launch_no_kernel():
    port_kernels.reset_launch_counts()
    port_pfft.pfft_lb(to_torch(complex_signal(9, 16, 16)), 2,
                      config=port_plan.PlanConfig(radix=4))
    assert sum(port_kernels.launch_counts().values()) == 0


# ---------------------------------------------------------------- chirp-Z

@pytest.mark.parametrize("n", [7, 16, 31, 37, 96])
def test_czt_dft_matches_reference(n):
    x = complex_signal(n, 3, n)
    want = ref_pfft.czt_dft(jnp.asarray(x))
    got = port_pfft.czt_dft(to_torch(x))
    close(got, want, n)
    np.testing.assert_allclose(to_numpy(got), np.fft.fft(x, axis=-1), atol=2e-4 * n)


@pytest.mark.parametrize("m_fft", [31, 33, 40, 64])
def test_czt_dft_explicit_length_matches_reference(m_fft):
    x = complex_signal(m_fft, 2, 16)
    want = ref_pfft.czt_dft(jnp.asarray(x), m_fft=m_fft)
    got = port_pfft.czt_dft(to_torch(x), m_fft=m_fft)
    close(got, want, 16)


def test_czt_dft_rejects_short_fft_like_reference():
    with pytest.raises(ValueError, match="m_fft=30 < 2N-1=31"):
        ref_pfft.czt_dft(jnp.ones((1, 16), jnp.complex64), m_fft=30)
    with pytest.raises(ValueError, match="m_fft=30 < 2N-1=31"):
        port_pfft.czt_dft(torch.ones((1, 16), dtype=torch.complex64), m_fft=30)


def test_czt_chirp_is_exact_past_the_int32_overflow():
    """The chirp's squares are taken in int64 on the host: at j = 46341 a
    32-bit j*j wraps."""
    n = 46342
    np.testing.assert_array_equal(port_pfft._czt_chirp(n), ref_pfft._czt_chirp(n))
    j = np.array([0, 1, 46340, 46341], dtype=np.int64)
    oracle = np.exp(-1j * np.pi * ((j * j) % (2 * n)) / n)
    np.testing.assert_allclose(port_pfft._czt_chirp(n)[j], oracle, rtol=0, atol=1e-12)


def test_czt_tables_are_reused_not_rebuilt():
    port_pfft._czt_tables.cache_clear()
    x = to_torch(complex_signal(0, 2, 12))
    first = port_pfft.czt_dft(x)
    second = port_pfft.czt_dft(x)
    info = port_pfft._czt_tables.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    np.testing.assert_array_equal(to_numpy(first), to_numpy(second))
