"""The planner slice: ``repro_torch.plan`` (cost model, tuner, wisdom,
calibration, plan cache) and ``plan_pfft(tune=, wisdom=)`` held against
``repro.plan`` on the same numpy inputs.

Host-side results are equal to the reference's: estimates at rel ``1e-12``,
fits at rel ``1e-9``, candidate pots, picks, rankings, keys and digests
exactly, with the backend names mapped (``xla``/``pallas`` of the reference
are ``torch``/``cuda`` here).  A wisdom file crosses between the packages in
both directions.  Measure mode runs on ``device="cpu"`` (the kernels' plain
versions); executed plans agree with the reference's within ``2e-4·N``.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_parity import (both_fpms, both_padding_fpms, complex_signal,
                           to_numpy, to_torch)

import repro.core as ref_core
import repro.plan as ref_plan
import repro.plan.calibrate as ref_calibrate

import repro_torch.core as port_core
import repro_torch.plan as port_plan
import repro_torch.plan.calibrate as port_calibrate
from repro_torch.kernels.fft.kernel import MAX_KERNEL_N, MAX_LARGE_N

NAMES = {"xla": "torch", "pallas": "cuda", "stockham": "stockham"}
CPU = "cpu"


def ref_params(backend_factor=None, **kw):
    if backend_factor is None:
        return ref_plan.CostParams.for_backend("cpu")
    return ref_plan.CostParams(backend_factor=backend_factor, **kw)


def port_params(backend_factor=None, **kw):
    if backend_factor is None:
        return port_plan.CostParams.for_backend("cpu")
    return port_plan.CostParams(
        backend_factor={NAMES[k]: v for k, v in backend_factor.items()}, **kw)


# Accelerator-like constants under which a kernel beats the library, so
# that a heterogeneous schedule is kept; the same numbers on both sides.
KERNEL_WINS = dict(nominal_flops=1e12, dispatch_overhead_s=3e-6,
                   hbm_bytes_per_s=1e12, fused_factor=0.7,
                   backend_factor={"xla": 1.0, "stockham": 1.6, "pallas": 0.5})


def mapped_params(p) -> dict:
    """A CostParams as a dict with the port's backend names."""
    d = dict(vars(p))
    d["backend_factor"] = {NAMES.get(k, k): v
                           for k, v in p.backend_factor.items()}
    return d


def assert_params_close(a, b, rel):
    a, b = mapped_params(a), mapped_params(b)
    assert a.keys() == b.keys()
    for k in a:
        if k == "backend_factor":
            assert a[k].keys() == b[k].keys()
            for name in a[k]:
                assert a[k][name] == pytest.approx(b[k][name], rel=rel), name
        else:
            assert a[k] == pytest.approx(b[k], rel=rel), k


def dicts(configs):
    return [c.to_dict() for c in configs]


def assert_ranked_equal(a, b):
    assert [c for c, _ in a] == [c for c, _ in b]
    np.testing.assert_allclose([t for _, t in a], [t for _, t in b], rtol=1e-12)


def problem(n, fpm_kind, pad):
    """(ref fpms, port fpms, d, pad lengths) of a seeded problem."""
    if fpm_kind == "none":
        d = ref_core.lb_partition(n, 3).d
        ref_f = port_f = None
    elif fpm_kind == "padding":
        ref_f, port_f = both_padding_fpms(n)
        d = ref_core.partition_rows(n, ref_f, 0.05).d
    else:
        ref_f, port_f = both_fpms(n, hetero=fpm_kind == "hetero", seed=n)
        d = ref_core.partition_rows(n, ref_f, 0.05).d
    pads = None
    if pad == "fpm" and ref_f is not None:
        pads = ref_plan.fpm_pad_lengths(ref_f, d, n)
    elif pad == "czt" and ref_f is not None:
        pads = ref_plan.czt_fft_lengths(ref_f, d, n, limit_ratio=2.0)
    return ref_f, port_f, d, pads


# ----------------------------------------------------------------- cost

@pytest.mark.parametrize("n", [16, 64, 256, 1024])
@pytest.mark.parametrize("fpm_kind", ["none", "homo", "hetero", "padding"])
@pytest.mark.parametrize("pad", ["none", "fpm", "czt"])
def test_cost_model_matches_reference(n, fpm_kind, pad):
    """Every candidate, complex and real, under the host constants: the
    estimates, the schedule and grouped estimates and the dispatch counts
    equal the reference's."""
    ref_f, port_f, d, pads = problem(n, fpm_kind, pad)
    rp, pp = ref_params(), port_params()
    ref_c = ref_plan.candidate_configs(n, pad=pad, d=d, panels=(1, 2))
    port_c = port_plan.candidate_configs(n, pad=pad, d=d, panels=(1, 2),
                                         pad_lengths=pads)
    assert dicts(ref_c) == dicts(port_c) and len(ref_c) >= 2
    if pad != "czt":
        ref_c += ref_plan.tune._real_candidates(ref_c)
        port_c += port_plan.tune._real_candidates(port_c)
    for rc, pc in zip(ref_c, port_c):
        a = ref_plan.estimate_cost(rc, n=n, d=d, pad_lengths=pads, fpms=ref_f,
                                   params=rp, comm_bytes=1e6, batch=2)
        b = port_plan.estimate_cost(pc, n=n, d=d, pad_lengths=pads, fpms=port_f,
                                    params=pp, comm_bytes=1e6, batch=2)
        assert b == pytest.approx(a, rel=1e-12)
        assert (port_plan.phase_dispatch_count(pc, n, d, pads)
                == ref_plan.phase_dispatch_count(rc, n, d, pads))
        rs = ref_plan.SegmentSchedule.homogeneous(rc, n, d, pads)
        ps = port_plan.SegmentSchedule.homogeneous(pc, n, d, pads)
        for fn in ("estimate_schedule_cost", "estimate_grouped_cost"):
            a = getattr(ref_plan, fn)(rs, fpms=ref_f, params=rp)
            b = getattr(port_plan, fn)(ps, fpms=port_f, params=pp)
            assert b == pytest.approx(a, rel=1e-12), fn
    # A mixed schedule (library on the first segment) prices alike too.
    if pad != "czt" and len(ref_c) > 2:
        k = sum(1 for r in d if r > 0)
        mixed = [ref_c[0]] + [ref_c[2]] * (len(d) - 1)
        rs = ref_plan.SegmentSchedule.from_parts(n, d, pads, mixed)
        ps = port_plan.SegmentSchedule.from_dict(rs.to_dict())
        for fn in ("estimate_schedule_cost", "estimate_grouped_cost"):
            a = getattr(ref_plan, fn)(rs, fpms=ref_f, params=rp)
            b = getattr(port_plan, fn)(ps, fpms=port_f, params=pp)
            assert b == pytest.approx(a, rel=1e-12), (fn, k)


@pytest.mark.parametrize("n,p", [(16, 1), (64, 4), (1000, 8), (4096, 16)])
def test_comm_and_halfspec_functions_match_reference(n, p):
    rp, pp = ref_params(), port_params()
    assert port_plan.halfspec_cols(n, p) == ref_plan.halfspec_cols(n, p)
    for real in (False, True):
        assert (port_plan.dist_comm_bytes(n, p, real=real)
                == ref_plan.dist_comm_bytes(n, p, real=real))
        for hosts in (1, 2, 4):
            for exchange in ("flat", "hier"):
                a = ref_plan.dist_comm_bytes(n, p, real=real, hosts=hosts,
                                             exchange=exchange)
                b = port_plan.dist_comm_bytes(n, p, real=real, hosts=hosts,
                                              exchange=exchange)
                assert tuple(b) == tuple(a) and b.total == a.total
                a = ref_plan.dist_comm_time(n, p, params=rp, hosts=hosts,
                                            exchange=exchange, real=real)
                b = port_plan.dist_comm_time(n, p, params=pp, hosts=hosts,
                                             exchange=exchange, real=real)
                assert b == pytest.approx(a, rel=1e-12)
                a = ref_plan.exchange_time(1e7, p, params=rp, hosts=hosts,
                                           exchange=exchange)
                b = port_plan.exchange_time(1e7, p, params=pp, hosts=hosts,
                                            exchange=exchange)
                assert b == pytest.approx(a, rel=1e-12)
    assert port_plan.comm_phase_time(0, 1e9, 1e-5) == 0.0
    assert (port_plan.comm_phase_time(3e6, 1e9, 1e-5)
            == ref_plan.comm_phase_time(3e6, 1e9, 1e-5))
    assert port_plan.pfft3_comm_bytes(n, p) == ref_plan.pfft3_comm_bytes(n, p)
    for kw in ({}, {"radix": 4}, {"fused": True, "radix": 4},
               {"pipeline_panels": 2, "exchange": "hier"}):
        a = ref_plan.estimate_pfft3_cost(ref_plan.PlanConfig(**kw), n=n, r=2,
                                         c=p, params=rp, hosts=2)
        b = port_plan.estimate_pfft3_cost(port_plan.PlanConfig(**kw), n=n, r=2,
                                          c=p, params=pp, hosts=2)
        assert b == pytest.approx(a, rel=1e-12)


def test_host_constants_equal_the_reference_field_for_field():
    ref, port = ref_plan.CostParams.for_backend("cpu"), port_plan.CostParams.for_backend("cpu")
    assert mapped_params(ref) == mapped_params(port)
    assert set(port.backend_factor) == {"torch", "stockham", "cuda"}


def test_card_constants_are_fitted_positive_and_name_the_card():
    """The ``"cuda"`` constants are measurements on the card (there K1
    loses to ``torch.fft.fft``, so the reference's accelerator ranking is
    not ported); they are positive, the default, and the module says on
    which card they were fitted."""
    cuda = port_plan.CostParams.for_backend("cuda")
    assert port_plan.CostParams.for_backend() == cuda
    assert set(cuda.backend_factor) == {"torch", "stockham", "cuda"}
    values = [cuda.nominal_flops, cuda.dispatch_overhead_s,
              cuda.hbm_bytes_per_s, cuda.fused_factor,
              *cuda.backend_factor.values()]
    assert all(np.isfinite(v) and v > 0 for v in values)
    accel = ref_plan.CostParams.for_backend("tpu")
    assert mapped_params(cuda)["backend_factor"] != mapped_params(accel)["backend_factor"]
    src = open(port_plan.cost.__file__).read()
    assert "NVIDIA H100" in src and "power.limit" in src
    with pytest.raises(ValueError, match="no cost constants"):
        port_plan.CostParams.for_backend("tpu")


# ----------------------------------------------------------- candidates

@pytest.mark.parametrize("n", [16, 48, 64, 1024, MAX_KERNEL_N])
@pytest.mark.parametrize("pad", ["none", "fpm", "czt"])
@pytest.mark.parametrize("d", [None, "one", "three"])
def test_candidate_pot_equals_reference_up_to_the_kernel_limit(n, pad, d):
    d = {None: None, "one": np.array([n]), "three": np.array([n // 2, 0, n // 2])}[d]
    for panels in ((1,), (1, 2, 4)):
        assert (dicts(port_plan.candidate_configs(n, pad=pad, d=d, panels=panels))
                == dicts(ref_plan.candidate_configs(n, pad=pad, d=d, panels=panels)))
    for length in (n, n + n // 4, 2 * n if 2 * n <= MAX_KERNEL_N else n):
        assert (dicts(port_plan.segment_candidate_configs(length, pad=pad))
                == dicts(ref_plan.segment_candidate_configs(length, pad=pad)))


def test_candidate_pot_drops_what_the_kernels_cannot_run():
    """Every row kernel takes power-of-two rows up to ``MAX_LARGE_N`` (K1-K4,
    and the four-step K1b-K4b above ``MAX_KERNEL_N``), so at 2 x 16384 the
    pot is the reference's, ``fused`` and ``radix=4`` included, and so are
    the real pipeline's twins, padded segments included.  Only above
    ``MAX_LARGE_N``, where a kernel would raise ``KernelLengthError``, are
    ``fused`` and ``radix=4`` dropped."""
    big = 2 * MAX_KERNEL_N
    for d in (None, np.array([big // 2] * 2)):
        ref = ref_plan.candidate_configs(big, d=d)
        port = port_plan.candidate_configs(big, d=d)
        assert any(c.fused for c in port)
        assert dicts(port) == dicts(ref)
        assert {c.radix for c in port} == {None, 2, 4}
        real = port_plan.tune._real_candidates(port, [big])
        assert dicts(real) == dicts(ref_plan.tune._real_candidates(ref))
        assert {c.radix for c in real} == {None, 2, 4} and any(c.fused for c in real)
    assert (dicts(port_plan.segment_candidate_configs(big))
            == dicts(ref_plan.segment_candidate_configs(big)))
    # N = 8192 with segments padded to 16384 and 10240, and N = 16384 with
    # one padded to 32768: the pot and its real twins are the reference's.
    for n in (MAX_KERNEL_N // 2, MAX_KERNEL_N):
        d = np.array([n // 2, n // 4, n // 4])
        pads = np.array([n, 2 * n, n + n // 4])
        cands = port_plan.candidate_configs(n, pad="fpm", d=d, pad_lengths=pads)
        assert dicts(cands) == dicts(ref_plan.candidate_configs(n, pad="fpm", d=d))
        real = port_plan.tune._real_candidates(cands, pads)
        assert 4 in {c.radix for c in real}
        assert dicts(real) == dicts(ref_plan.tune._real_candidates(
            ref_plan.candidate_configs(n, pad="fpm", d=d)))
    assert [c.radix for c in port_plan.segment_candidate_configs(
        n + n // 4, pad="fpm")] == [None]
    # Above MAX_LARGE_N: no fused and no radix=4, complex or real.
    huge = 2 * MAX_LARGE_N
    port = port_plan.candidate_configs(huge)
    assert dicts(port) == dicts([c for c in ref_plan.candidate_configs(huge)
                                 if not c.fused and c.radix != 4])
    assert {c.radix for c in port_plan.tune._real_candidates(
        port_plan.candidate_configs(MAX_KERNEL_N), [huge])} == {None, 2}


@pytest.mark.parametrize("n", [1 << e for e in range(2, 17)])
@pytest.mark.parametrize("method", ["lb", "fpm", "fpm-pad", "fpm-czt",
                                    "rfft-lb", "rfft-fpm-pad"])
def test_estimate_plans_equal_reference_at_every_power_of_two(n, method):
    """At every power of two from 4 to 65536: the candidate pot and the
    ``tune="estimate"`` ranking and pick (``tune_config``, ``tune_schedule``
    with its per-length groups, ``tune_rfft``) equal the reference's, with
    no filter: above ``MAX_KERNEL_N`` too, where ``fused`` and the real
    ``radix=4`` twins run the four-step kernels K2b-K4b, and the unfused
    complex ``radix=4`` K1b."""
    pad = {"fpm-pad": "fpm", "fpm-czt": "czt", "rfft-fpm-pad": "fpm"}.get(method, "none")
    kind = {"lb": "none", "rfft-lb": "none", "fpm-pad": "padding",
            "rfft-fpm-pad": "padding"}.get(method, "hetero")
    ref_f, port_f, d, pads = problem(n, kind, pad)
    if method == "rfft-fpm-pad":
        pads = ref_plan.rfft_pad_lengths(ref_f, d, n)
    rp, pp = ref_params(**KERNEL_WINS), port_params(**KERNEL_WINS)
    if method.startswith("rfft"):
        a, ia = ref_plan.tune_rfft(n, d=d, pad_lengths=pads, fpms=ref_f, pad=pad, params=rp)
        b, ib = port_plan.tune_rfft(n, d=d, pad_lengths=pads, fpms=port_f, pad=pad,
                                    params=pp)
    elif pad == "none":
        a, ia = ref_plan.tune_config(n, d=d, fpms=ref_f, params=rp)
        b, ib = port_plan.tune_config(n, d=d, fpms=port_f, params=pp)
    else:
        a, ia = ref_plan.tune_schedule(n, d=d, pad_lengths=pads, fpms=ref_f, pad=pad,
                                       params=rp)
        b, ib = port_plan.tune_schedule(n, d=d, pad_lengths=pads, fpms=port_f,
                                        pad=pad, params=pp)
        for length, ranked in ia.get("groups", {}).items():
            assert_ranked_equal(ranked, ib["groups"][length])
    assert_ranked_equal(ia["ranked"], ib["ranked"])
    assert a.to_dict() == b.to_dict()
    if n > MAX_KERNEL_N and pad != "czt":
        assert any(c["radix"] == 4 and not c["real"] for c, _ in ib["ranked"])
        if method.startswith("rfft"):
            assert any(c["radix"] == 4 and c["real"] for c, _ in ib["ranked"])
        if pad == "none":
            assert any(c["fused"] for c, _ in ib["ranked"])


# ------------------------------------------------------------- estimate

@pytest.mark.parametrize("n", [16, 64, 256])
@pytest.mark.parametrize("fpm_kind", ["none", "homo", "hetero"])
@pytest.mark.parametrize("constants", ["cpu", "kernel-wins"])
def test_tune_config_estimate_matches_reference(n, fpm_kind, constants):
    ref_f, port_f, d, _ = problem(n, fpm_kind, "none")
    kw = {} if constants == "cpu" else KERNEL_WINS
    a, ia = ref_plan.tune_config(n, d=d, fpms=ref_f, params=ref_params(**kw),
                                 panels=(1, 2))
    b, ib = port_plan.tune_config(n, d=d, fpms=port_f, params=port_params(**kw),
                                  panels=(1, 2))
    assert a.to_dict() == b.to_dict()
    assert_ranked_equal(ia["ranked"], ib["ranked"])
    assert ib["mode"] == "estimate" and "measured" not in ib


@pytest.mark.parametrize("case", ["single-length", "hetero-pads", "padding-fpms",
                                  "czt"])
@pytest.mark.parametrize("constants", ["cpu", "kernel-wins"])
def test_tune_schedule_estimate_matches_reference(case, constants):
    kw = {} if constants == "cpu" else KERNEL_WINS
    if case == "single-length":
        n, pad = 64, "none"
        ref_f, port_f, d, pads = problem(n, "hetero", pad)
    elif case == "hetero-pads":
        # Non-pow2 N: the unpadded group keeps the library while the fast
        # processors' pow2 pads take the kernel under kernel-wins constants.
        n, pad, d, pads = 48, "fpm", np.array([16, 16, 16]), np.array([48, 64, 64])
        ref_f, port_f = both_fpms(n, seed=3)
    elif case == "padding-fpms":
        n, pad = 32, "fpm"
        ref_f, port_f, d, pads = problem(n, "padding", pad)
    else:
        n, pad = 32, "czt"
        ref_f, port_f, d, pads = problem(n, "hetero", pad)
    a, ia = ref_plan.tune_schedule(n, d=d, pad_lengths=pads, fpms=ref_f, pad=pad,
                                   params=ref_params(**kw))
    b, ib = port_plan.tune_schedule(n, d=d, pad_lengths=pads, fpms=port_f,
                                    pad=pad, params=port_params(**kw))
    assert a.to_dict() == b.to_dict() == ib["schedule"]
    assert ia["chosen"] == ib["chosen"]
    assert_ranked_equal(ia["ranked"], ib["ranked"])
    for length, ranked in ia.get("groups", {}).items():
        assert_ranked_equal(ranked, ib["groups"][length])
    if case == "hetero-pads" and constants == "kernel-wins":
        assert ib["chosen"] == "heterogeneous" and len(b.configs) >= 2
        assert ib["heterogeneous"]["est_s"] == pytest.approx(
            ia["heterogeneous"]["est_s"], rel=1e-12)


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("method", ["rfft-lb", "rfft-fpm", "rfft-fpm-pad"])
@pytest.mark.parametrize("constants", ["cpu", "kernel-wins"])
def test_tune_rfft_estimate_matches_reference(n, method, constants):
    kw = {} if constants == "cpu" else KERNEL_WINS
    ref_f, port_f, d, pads = problem(n, "none" if method == "rfft-lb" else
                                     ("padding" if method.endswith("pad") else "hetero"),
                                     "none")
    if method == "rfft-fpm-pad":
        pads = ref_plan.rfft_pad_lengths(ref_f, d, n)
        np.testing.assert_array_equal(pads, port_plan.rfft_pad_lengths(port_f, d, n))
    pad = "fpm" if method.endswith("pad") else "none"
    a, ia = ref_plan.tune_rfft(n, d=d, pad_lengths=pads, fpms=ref_f, pad=pad,
                               params=ref_params(**kw))
    b, ib = port_plan.tune_rfft(n, d=d, pad_lengths=pads, fpms=port_f, pad=pad,
                                params=port_params(**kw))
    assert a.to_dict() == b.to_dict()
    assert ia["chosen_path"] == ib["chosen_path"]
    assert_ranked_equal(ia["ranked"], ib["ranked"])


METHODS = ["lb", "fpm", "fpm-pad", "fpm-czt", "rfft-lb", "rfft-fpm", "rfft-fpm-pad"]


@pytest.mark.parametrize("method", METHODS)
def test_estimate_plan_executes_like_the_reference_plan(method):
    """``plan_pfft(tune="estimate")`` on the host: the same partition, pads
    and schedule as the reference's plan, and its output within
    ``2e-4·N``."""
    n = 32
    real = method.startswith("rfft-")
    ref_f, port_f = (both_padding_fpms(n) if method.endswith("pad")
                     else both_fpms(n, seed=7))
    dtype = "float32" if real else "complex64"
    kw = dict(p=3, method=method, tune="estimate", dtype=dtype)
    a = ref_core.plan_pfft(n, fpms=ref_f, **kw)
    b = port_core.plan_pfft(n, fpms=port_f, device=CPU, **kw)
    assert a.schedule.to_dict() == b.schedule.to_dict()
    np.testing.assert_array_equal(a.d, b.d)
    assert a.tuning["source"] == b.tuning["source"] == "estimate"
    assert a.tuning["wisdom_key"] == b.tuning["wisdom_key"]
    assert a.tuning.get("chosen_path") == b.tuning.get("chosen_path")
    assert_ranked_equal(a.tuning["ranked"], b.tuning["ranked"])
    m = (np.random.default_rng(8).standard_normal((n, n)).astype(np.float32)
         if real else complex_signal(8, n, n))
    np.testing.assert_allclose(to_numpy(b.execute(to_torch(m))),
                               np.asarray(a.execute(jnp.asarray(m))),
                               atol=2e-4 * n)


# --------------------------------------------------------------- wisdom

@pytest.mark.parametrize("kw", [
    dict(n=64, dtype="complex64", p=4, method="lb", backend="cpu"),
    dict(n=48, dtype="float32", p=3, method="rfft-fpm-pad", backend="cuda",
         detail="cafe0123"),
    dict(n=16, dtype="complex128", p=2, method="fpm", backend="cpu",
         topology="4xfft.cuda.k1-2")])
def test_wisdom_keys_and_digests_equal_the_reference(kw):
    assert port_plan.wisdom_key(**kw) == ref_plan.wisdom_key(**kw)
    d = np.array([10, 0, 22])
    for pads in (None, np.array([32, 32, 40])):
        assert (port_plan.partition_digest(d, pads)
                == ref_plan.partition_digest(d, pads))
    for args in (dict(devices=4, platform="cpu"),
                 dict(devices=8, platform="cuda", panels=(1, 4, 2), hosts=2),
                 dict(devices=2, axis_name="rows", platform="gpu")):
        assert (port_plan.topology_digest(**args)
                == ref_plan.topology_digest(**args))
    assert port_plan.topology_digest(devices=4) == "4xfft.cuda.k1"
    assert port_plan.WISDOM_VERSION == ref_plan.WISDOM_VERSION == 3


def test_topology_digest_of_a_mesh_is_a_later_slice():
    # The mesh form is ported (tests/test_torch_dist_groups.py holds it
    # against the reference); what is not a DeviceMesh is refused by name.
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_plan.topology_digest(object(), "fft")
    with pytest.raises(ValueError):
        port_plan.topology_digest(axis_name=("r", "c"), devices=4)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_wisdom_file_crosses_between_the_packages(tmp_path, writer):
    """Configs and schedules recorded by one package are served by the
    other, byte-identical entries and all; plans built on either side from
    the file are the same schedule."""
    path = str(tmp_path / "wisdom.json")
    w, r = (ref_plan, port_plan) if writer == "reference" else (port_plan, ref_plan)
    key = w.wisdom_key(n=48, dtype="complex64", p=3, method="fpm-pad",
                       backend="cpu", detail="cafe0123")
    sched = w.SegmentSchedule.from_parts(
        48, [16, 32], [48, 64],
        [w.PlanConfig(pad="fpm"), w.PlanConfig(radix=4, pad="fpm")])
    w.record_wisdom(path, key, sched, mode="measure", time_s=3e-4)
    key2 = w.wisdom_key(n=48, dtype="complex64", p=3, method="lb", backend="cpu")
    w.record_wisdom(path, key2, w.PlanConfig(radix=2), mode="estimate")
    got, entry = r.lookup_wisdom(path, key)
    assert got.to_dict() == sched.to_dict() and entry["time_s"] == 3e-4
    assert r.lookup_wisdom(path, key2)[0].to_dict() == w.PlanConfig(radix=2).to_dict()
    assert r.load_wisdom(path) == w.load_wisdom(path)
    # A measured plan of the writer is served to the reader's plan_pfft.
    n = 32
    core = ref_core if writer == "reference" else port_core
    dev = {"device": CPU} if core is port_core else {}
    first = core.plan_pfft(n, p=2, method="lb", tune="measure", wisdom=path, **dev)
    other = port_core if core is ref_core else ref_core
    odev = {"device": CPU} if other is port_core else {}
    served = other.plan_pfft(n, p=2, method="lb", wisdom=path, **odev)
    assert served.tuning["source"] == "wisdom"
    assert served.schedule.to_dict() == first.schedule.to_dict()
    assert served.tuning["wisdom_key"] == first.tuning["wisdom_key"]


def test_wisdom_miss_hit_and_overwrite(tmp_path):
    path = str(tmp_path / "wisdom.json")
    key = port_plan.wisdom_key(n=64, dtype="complex64", p=4, method="lb",
                               backend="cpu")
    assert port_plan.lookup_wisdom(path, key) is None
    cfg = port_plan.PlanConfig(radix=4, fused=True)
    port_plan.record_wisdom(path, key, cfg, mode="measure", time_s=1e-3)
    got, entry = port_plan.lookup_wisdom(path, key)
    assert got == cfg and entry["mode"] == "measure"
    assert port_plan.lookup_wisdom(path, key + "|x") is None
    port_plan.record_wisdom(path, key, port_plan.PlanConfig(), mode="estimate")
    got2, entry2 = port_plan.lookup_wisdom(path, key)
    assert got2 == port_plan.PlanConfig() and "time_s" not in entry2


@pytest.mark.parametrize("damage", ["version", "v1", "corrupt", "entry-drift"])
def test_wisdom_damage_is_a_miss_in_both_packages(tmp_path, damage):
    path = str(tmp_path / "wisdom.json")
    key = port_plan.wisdom_key(n=32, dtype="complex64", p=2, method="lb",
                               backend="cpu")
    port_plan.record_wisdom(path, key, port_plan.PlanConfig(), mode="measure")
    doc = json.load(open(path))
    if damage == "version":
        doc["version"] = port_plan.WISDOM_VERSION + 1
    elif damage == "v1":
        doc["version"] = 1
    elif damage == "entry-drift":
        doc["entries"][key]["config"]["warp_drive"] = True
    with open(path, "w") as fh:
        if damage == "corrupt":
            fh.write("{ not json")
        else:
            json.dump(doc, fh)
    for pkg in (port_plan, ref_plan):
        assert pkg.lookup_wisdom(path, key) is None
        if damage != "entry-drift":
            assert pkg.load_wisdom(path) == {}
    plan = port_core.plan_pfft(32, p=2, method="lb", wisdom=path, device=CPU)
    assert plan.tuning["source"] == "off"
    port_plan.record_wisdom(path, key, port_plan.PlanConfig(), mode="measure")
    assert json.load(open(path))["version"] == port_plan.WISDOM_VERSION
    assert port_plan.lookup_wisdom(path, key) is not None
    assert ref_plan.lookup_wisdom(path, key) is not None


def test_stale_structure_and_drifted_pad_are_misses(tmp_path):
    path = str(tmp_path / "wisdom.json")
    key = port_plan.wisdom_key(n=32, dtype="complex64", p=2, method="lb",
                               backend="cpu")
    wrong = port_plan.SegmentSchedule.from_parts(
        32, [10, 22], None, [port_plan.PlanConfig(), port_plan.PlanConfig()])
    port_plan.record_wisdom(path, key, wrong, mode="measure")
    plan = port_core.plan_pfft(32, p=2, method="lb", wisdom=path, device=CPU)
    assert plan.tuning["source"] == "off" and plan.schedule.matches(plan.d)
    # A schedule whose pad drifted from the method's strategy is a miss.
    n = 16
    _, fpms = both_padding_fpms(n)
    probe = port_core.plan_pfft(n, fpms=fpms, method="fpm-pad", device=CPU)
    drifted = port_plan.SegmentSchedule.homogeneous(
        port_plan.PlanConfig(pad="czt"), n, probe.d, probe.pad_lengths)
    port_plan.record_wisdom(path, probe.tuning["wisdom_key"], drifted,
                            mode="measure")
    again = port_core.plan_pfft(n, fpms=fpms, method="fpm-pad", wisdom=path,
                                device=CPU)
    assert again.tuning["source"] == "off" and again.config.pad == "fpm"


def test_heterogeneous_schedule_served_from_wisdom(tmp_path):
    path = str(tmp_path / "wisdom.json")
    n = 48
    probe = port_core.plan_pfft(n, p=2, method="lb", wisdom=path, device=CPU)
    mixed = port_plan.SegmentSchedule.from_parts(
        n, probe.d, None, [port_plan.PlanConfig(), port_plan.PlanConfig(radix=2)])
    port_plan.record_wisdom(path, probe.tuning["wisdom_key"], mixed,
                            mode="measure", time_s=1e-3)
    served = port_core.plan_pfft(n, p=2, method="lb", wisdom=path, device=CPU)
    assert served.tuning["source"] == "wisdom" and served.schedule == mixed
    assert served.tuning["wisdom_entry"]["time_s"] == 1e-3
    m = complex_signal(22, n, n)
    np.testing.assert_allclose(to_numpy(served.execute(to_torch(m))),
                               np.fft.fft2(m), atol=2e-4 * n)


def test_wisdom_key_digests_the_fpm_partition(tmp_path):
    path = str(tmp_path / "wisdom.json")
    n = 32
    _, hetero = both_fpms(n, hetero=True, seed=1)
    _, homo = both_fpms(n, hetero=False, seed=1)
    p1 = port_core.plan_pfft(n, fpms=hetero, method="fpm", tune="estimate",
                             wisdom=path, device=CPU)
    p2 = port_core.plan_pfft(n, fpms=homo, method="fpm", tune="estimate",
                             wisdom=path, device=CPU)
    assert "|part=" in p1.tuning["wisdom_key"]
    assert (p1.tuning["wisdom_key"] == p2.tuning["wisdom_key"]) == \
        bool(np.array_equal(p1.d, p2.d))


# ------------------------------------------------------------ calibrate

def synth_entries(n_entries: int, *, kinds=("xla", "stockham")) -> tuple[dict, dict]:
    """(reference entries, port entries): the same measured wisdom entries,
    times from the reference's own cost model under constants unlike the
    defaults (so that a fit has something to recover)."""
    true = ref_plan.CostParams(nominal_flops=2e9, dispatch_overhead_s=2e-5,
                               hbm_bytes_per_s=3e10, fused_factor=40.0,
                               backend_factor={"xla": 1.3, "stockham": 6.0,
                                               "pallas": 90.0})
    radix = {"xla": None, "stockham": 2, "pallas": 4}
    entries = {}
    for i in range(n_entries):
        n = 32 * (1 + i % 4)
        p = 2 + i % 3
        kind = kinds[i % len(kinds)]
        cfg = (ref_plan.PlanConfig(radix=4, fused=True) if kind == "fused"
               else ref_plan.PlanConfig(radix=radix[kind], batched=bool(i % 2)))
        d = ref_core.lb_partition(n, p).d
        t = ref_plan.estimate_cost(cfg, n=n, d=d, params=true)
        key = ref_plan.wisdom_key(n=n, dtype="complex64", p=p, method="lb",
                                  backend="cpu")
        entries[f"{key}|i={i}"] = {"config": cfg.to_dict(), "mode": "measure",
                                   "time_s": float(t)}
    # A schedule entry and entries the fit must skip.
    sched = ref_plan.SegmentSchedule.from_parts(
        64, [16, 48], None, [ref_plan.PlanConfig(), ref_plan.PlanConfig(radix=2)])
    entries["n=64|dtype=complex64|p=2|method=fpm|backend=cpu|part=ab"] = {
        "schedule": sched.to_dict(), "mode": "measure",
        "time_s": float(ref_plan.estimate_schedule_cost(sched, params=true))}
    entries["n=oops"] = {"time_s": "NaN?"}
    entries["n=64|dtype=complex64|p=2|method=lb|backend=tpu"] = {
        "config": {}, "time_s": 1.0}
    return entries, json.loads(json.dumps(entries))


@pytest.mark.parametrize("n_entries,kinds", [
    (12, ("xla", "stockham")), (16, ("xla", "stockham", "pallas", "fused")),
    (9, ("xla", "fused")), (24, ("stockham", "pallas"))])
def test_fit_cost_params_matches_reference(n_entries, kinds):
    ref_e, port_e = synth_entries(n_entries, kinds=kinds)
    a = ref_plan.fit_cost_params(ref_e, backend="cpu")
    b = port_plan.fit_cost_params(port_e, backend="cpu")
    assert_params_close(a, b, rel=1e-9)
    assert a != ref_plan.CostParams.for_backend("cpu")


def test_fit_cost_params_falls_back_below_threshold_and_skips_bad_entries():
    true = port_plan.CostParams.for_backend("cpu")
    ref_e, port_e = synth_entries(3)
    assert port_plan.fit_cost_params(port_e, backend="cpu") == true
    assert port_plan.fit_cost_params({}, backend="cpu") == true
    assert port_plan.fit_cost_params({}) == port_plan.CostParams.for_backend("cuda")
    # Entries of another backend do not count toward the threshold.
    _, many = synth_entries(12)
    assert port_plan.fit_cost_params(many, backend="cuda") == \
        port_plan.CostParams.for_backend("cuda")


def test_fit_cost_params_from_file_is_cached_per_mtime(tmp_path):
    path = str(tmp_path / "wisdom.json")
    _, entries = synth_entries(10)
    for key, entry in entries.items():
        if "config" in entry and entry["config"]:
            port_plan.record_wisdom(path, key,
                                    port_plan.PlanConfig.from_dict(entry["config"]),
                                    mode="measure", time_s=entry["time_s"])
    fitted = port_plan.fit_cost_params(path, backend="cpu")
    assert fitted == port_plan.fit_cost_params(port_plan.load_wisdom(path),
                                               backend="cpu")
    assert port_plan.fit_cost_params(path, backend="cpu") is fitted  # cached
    ref = ref_plan.fit_cost_params(path, backend="cpu")
    assert_params_close(ref, fitted, rel=1e-9)
    # Rewriting the store (new mtime) refits.
    time.sleep(0.01)
    port_plan.record_wisdom(path, "n=32|dtype=complex64|p=2|method=lb|backend=cpu|x=1",
                            port_plan.PlanConfig(), mode="measure", time_s=5.0)
    os.utime(path, ns=(time.time_ns() + 10**9, time.time_ns() + 10**9))
    assert port_plan.fit_cost_params(path, backend="cpu") is not fitted
    assert port_calibrate._COLS == tuple(
        NAMES.get(c, c) for c in ref_calibrate._COLS)


# ------------------------------------------------------ measure on CPU

def test_tune_config_measure_times_finalists_on_the_host():
    n = 32
    d = port_core.lb_partition(n, 2).d
    chosen, info = port_plan.tune_config(n, d=d, mode="measure", top_k=2,
                                         reps=1, device=CPU)
    assert len(info["measured"]) == 2 and "measured_event_s" not in info
    assert chosen.to_dict() in [c for c, _ in info["measured"]]
    assert chosen in port_plan.candidate_configs(n, d=d)
    assert info["time_s"] > 0
    chosen, info = port_plan.tune_config(16, mode="measure", top_k=1, reps=1,
                                         device=CPU)
    assert chosen in port_plan.candidate_configs(16) and info["time_s"] > 0
    with pytest.raises(ValueError):
        port_plan.tune_config(32, mode="exhaustive")
    with pytest.raises(ValueError, match="mesh the bytes cross"):
        port_plan.tune_config(32, mode="measure", comm_bytes=1.0, device=CPU)


def test_tune_schedule_measure_multi_length_on_the_host():
    n = 24
    d = np.array([8, 8, 8])
    pads = np.array([24, 32, 32], dtype=np.int64)
    sched, info = port_plan.tune_schedule(n, d=d, pad_lengths=pads,
                                          mode="measure", pad="fpm", top_k=2,
                                          reps=1, device=CPU)
    assert sched.matches(d, pads) and info["time_s"] > 0
    assert "group_measured" in info and "measured" in info
    m = complex_signal(14, n, n)
    ref = ref_core.pfft._pfft_limb(jnp.asarray(m), d, pad_lengths=pads,
                                   config=ref_plan.PlanConfig(pad="fpm"))
    out = port_core.pfft._pfft_limb(to_torch(m), d, schedule=sched)
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=2e-4 * n)


def test_tune_rfft_measure_races_both_families_on_the_host():
    sched, info = port_plan.tune_rfft(32, mode="measure", top_k=2, reps=2,
                                      device=CPU)
    assert {c["real"] for c, _ in info["measured"]} == {True, False}
    assert info["chosen_path"] in ("real", "complex")
    assert sched.anchor_config.real == (info["chosen_path"] == "real")
    times = port_plan.measure_rfft_configs(
        [port_plan.PlanConfig(real=True), port_plan.PlanConfig()], 16,
        rounds=1, device=CPU)
    assert all(t > 0 for t in times.values())


@pytest.mark.parametrize("method,dtype", [("lb", "complex64"),
                                          ("rfft-lb", "float32"),
                                          ("lb", "complex128")])
def test_measured_pick_is_recorded_and_served(tmp_path, method, dtype):
    path = str(tmp_path / "wisdom.json")
    n = 32
    p1 = port_core.plan_pfft(n, p=2, method=method, tune="measure",
                             wisdom=path, dtype=dtype, device=CPU)
    assert p1.tuning["source"] == "measure" and "measured" in p1.tuning
    assert f"dtype={dtype}" in p1.tuning["wisdom_key"]
    assert f"method={method}" in p1.tuning["wisdom_key"]
    assert "|backend=cpu" in p1.tuning["wisdom_key"]
    assert p1.tuning["calibrated"] is False and p1.tuning["time_s"] > 0
    entry = port_plan.load_wisdom(path)[p1.tuning["wisdom_key"]]
    assert entry["mode"] == "measure" and entry["time_s"] == p1.tuning["time_s"]
    p2 = port_core.plan_pfft(n, p=2, method=method, tune="measure",
                             wisdom=path, dtype=dtype, device=CPU)
    assert p2.tuning["source"] == "wisdom" and "measured" not in p2.tuning
    assert p2.schedule == p1.schedule
    real = method.startswith("rfft-")
    m = (np.random.default_rng(12).standard_normal((n, n)).astype(dtype) if real
         else complex_signal(12, n, n).astype(dtype))
    want = np.fft.rfft2(m) if real else np.fft.fft2(m)
    np.testing.assert_allclose(to_numpy(p2.execute(to_torch(m))), want,
                               atol=2e-4 * n)
    # Another dtype is another key: measured afresh.
    other = "complex64" if dtype != "complex64" and not real else None
    if other:
        p3 = port_core.plan_pfft(n, p=2, method=method, tune="measure",
                                 wisdom=path, dtype=other, device=CPU)
        assert p3.tuning["source"] == "measure"


def test_plan_tuning_holds_the_reference_keys(tmp_path):
    path = str(tmp_path / "wisdom.json")
    n = 16
    a = ref_core.plan_pfft(n, p=2, method="lb", tune="measure", wisdom=path)
    b = port_core.plan_pfft(n, p=2, method="lb", tune="measure",
                            wisdom=str(tmp_path / "w2.json"), device=CPU)
    assert set(a.tuning) == set(b.tuning)
    for key in ("mode", "source", "wisdom_key", "calibrated", "ranked",
                "measured", "time_s", "schedule"):
        assert key in b.tuning
    a = ref_core.plan_pfft(n, p=2, method="rfft-lb", dtype="float32",
                           tune="estimate", wisdom=path)
    b = port_core.plan_pfft(n, p=2, method="rfft-lb", dtype="float32",
                            tune="estimate", wisdom=path, device=CPU)
    assert set(a.tuning) == set(b.tuning) and "chosen_path" in b.tuning
    served = port_core.plan_pfft(n, p=2, method="lb", wisdom=path, device=CPU)
    assert {"mode", "source", "wisdom_key", "wisdom_entry"} == set(served.tuning)


def test_calibrated_once_the_store_holds_enough_measured_entries(tmp_path):
    path = str(tmp_path / "wisdom.json")
    _, entries = synth_entries(12)
    for key, entry in entries.items():
        if "config" in entry and entry["config"]:
            port_plan.record_wisdom(path, key,
                                    port_plan.PlanConfig.from_dict(entry["config"]),
                                    mode="measure", time_s=entry["time_s"])
    plan = port_core.plan_pfft(64, p=4, method="lb", tune="estimate",
                               wisdom=path, device=CPU)
    assert plan.tuning["calibrated"] is True and plan.tuning["source"] == "estimate"
    ref = ref_core.plan_pfft(64, p=4, method="lb", tune="estimate", wisdom=path)
    assert ref.tuning["calibrated"] is True
    assert_ranked_equal(ref.tuning["ranked"], plan.tuning["ranked"])


# ---------------------------------------------------------- api and cache

def test_plan_tune_validation_and_explicit_config():
    with pytest.raises(ValueError, match="tune must be"):
        port_core.plan_pfft(32, p=2, method="lb", tune="turbo", device=CPU)
    cfg = port_plan.PlanConfig(radix=2, batched=False)
    plan = port_core.plan_pfft(32, p=2, method="lb", tune="estimate",
                               config=cfg, device=CPU)
    assert plan.config == cfg and plan.tuning["source"] == "explicit"
    assert plan.tuning == {"mode": "estimate", "source": "explicit"}


def test_wisdom_hit_applies_even_with_tune_off(tmp_path):
    path = str(tmp_path / "wisdom.json")
    port_core.plan_pfft(32, p=2, method="lb", tune="measure", wisdom=path,
                        device=CPU)
    served = port_core.plan_pfft(32, p=2, method="lb", wisdom=path, device=CPU)
    assert served.tuning["source"] == "wisdom" and served.tuning["mode"] == "off"
    cold = port_core.plan_pfft(32, p=2, method="lb", device=CPU)
    assert cold.tuning["source"] == "off"


@pytest.mark.parametrize("tune", ["estimate", "measure"])
def test_rfft2_tunes(tmp_path, tune):
    n = 32
    x = np.random.default_rng(5).standard_normal((n, n)).astype(np.float32)
    path = str(tmp_path / "wisdom.json")
    got = port_core.rfft2(to_torch(x), tune=tune, wisdom=path)
    assert got.device.type == "cpu" and got.shape == (n, n // 2 + 1)
    want = np.asarray(ref_core.rfft2(jnp.asarray(x), tune="estimate"))
    np.testing.assert_allclose(to_numpy(got), want, atol=2e-4 * n)
    assert (len(port_plan.load_wisdom(path)) == 1) == (tune == "measure")


class _FakePlan:
    def __init__(self, source="estimate"):
        self.tuning = {"source": source}


def test_plan_cache_counts_hits_misses_evictions_and_retunes():
    cache = port_plan.PlanCache(maxsize=2)
    for k, source in zip("abc", ("wisdom", "estimate", "measure")):
        cache.get(k, lambda s=source: _FakePlan(s))
    assert len(cache) == 2 and "a" not in cache
    assert cache.stats.as_dict() == {"hits": 0, "misses": 3, "evictions": 1,
                                     "retunes": 2}
    plan, hit = cache.get("b", _FakePlan)
    assert hit and cache.peek("b") is plan
    cache.get("d", lambda: _FakePlan("explicit"))     # evicts c, keeps b
    assert "b" in cache and "c" not in cache and cache.stats.retunes == 2
    assert cache.keys() == ["b", "d"]
    cache.reset_stats()
    assert cache.stats_dict() == {"hits": 0, "misses": 0, "evictions": 0,
                                  "retunes": 0, "size": 2, "maxsize": 2}
    with pytest.raises(RuntimeError):
        cache.get("e", lambda: (_ for _ in ()).throw(RuntimeError("x")))
    assert "e" not in cache
    cache.clear()
    assert len(cache) == 0
    with pytest.raises(ValueError):
        port_plan.PlanCache(maxsize=0)


def test_plan_cache_builds_once_when_callers_race():
    """Single flight: many threads asking for one cold key build it once."""
    cache = port_plan.PlanCache()
    builds = []

    def build():
        builds.append(1)
        time.sleep(0.05)
        return port_core.plan_pfft(16, p=2, method="lb", tune="estimate",
                                   device=CPU)

    got = []
    threads = [threading.Thread(target=lambda: got.append(cache.get("k", build)))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(got) == 8
    assert len({id(plan) for plan, _ in got}) == 1
    assert sorted(hit for _, hit in got) == [False] + [True] * 7
    assert cache.stats.retunes == 1 and cache.stats.hits == 7


def test_measure_defaults_to_the_card(monkeypatch):
    """Measurement runs where the plan runs: without a device it asks for
    the CUDA device, and raises when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_plan.tune_config(16, mode="measure", top_k=1, reps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_core.plan_pfft(16, p=2, method="lb", tune="measure")
    # The estimate needs no device work and prices with the card's constants.
    cfg, info = port_plan.tune_config(16, mode="estimate")
    cuda = port_plan.CostParams.for_backend("cuda")
    assert info["ranked"][0][1] == pytest.approx(port_plan.estimate_cost(
        cfg, n=16, params=cuda), rel=1e-12)
