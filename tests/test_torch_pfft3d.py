"""The 3-D and huge-1-D slice: ``repro_torch.core.pfft3d`` (single-device
axis passes), ``repro_torch.core.pfft_large`` (four-step), their plans
``plan_pfft3`` / ``plan_pfft1_large`` / ``pfft1_large``, their tuners, and
the batch that runs each dispatch group of each phase once, held against
``repro`` on the same numpy inputs.

Cubes of 8, 14 and 16 within the reference suite's ``atol=2e-2``; lines of
12, 64, 97 and 360 within its ``atol=2e-3``; ``four_step_factors`` and the
twiddle table exactly; picks and wisdom keys under the ``"cpu"`` cost
constants equal to the reference's.  The port runs on ``device="cpu"`` (the
kernels' plain versions).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (both_fpms, both_padding_fpms, complex_signal,
                           to_numpy, to_torch)

import repro.core.api as ref_api
import repro.core.pfft3d as ref_pfft3d
import repro.core.pfft_large as ref_large
import repro.plan as ref_plan
import repro.plan.tune as ref_tune

import repro_torch.core.api as port_api
import repro_torch.core.pfft as port_pfft
import repro_torch.core.pfft3d as port_pfft3d
import repro_torch.core.pfft_large as port_large
import repro_torch.fft.fft2d as port_fft2d
import repro_torch.plan as port_plan
import repro_torch.plan.tune as port_tune
from repro_torch.kernels.fft.kernel import MAX_LARGE_N, KernelLengthError
from repro_torch.kernels.fft.ops import resolve_radix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
CUBE_ATOL = 2e-2
LINE_ATOL = 2e-3
# Port configs beside the reference's default: the library, the kernel
# (its plain version here), the pure-tensor Stockham, and per-segment
# dispatch.
PORT_CONFIGS = {"library": {}, "kernel": {"radix": 4}, "stockham": {"radix": 2},
                "looped": {"radix": 4, "batched": False}}


def cube(n, seed=0, batch=()):
    return complex_signal(seed, *batch, n, n, n)


def line(n, seed=0, batch=()):
    return complex_signal(seed, *batch, n)


# ------------------------------------------------------------------ pfft3


@pytest.mark.parametrize("config", sorted(PORT_CONFIGS))
@pytest.mark.parametrize("n,p", [(8, 2), (14, 4), (16, 3)])
def test_pfft3_lb_matches_reference(n, p, config):
    m = cube(n, seed=n)
    want = np.asarray(ref_pfft3d.pfft3_lb(jnp.asarray(m), p))
    got = port_pfft3d.pfft3_lb(to_torch(m), p,
                               config=port_plan.PlanConfig(**PORT_CONFIGS[config]))
    np.testing.assert_allclose(to_numpy(got), want, atol=CUBE_ATOL)
    np.testing.assert_allclose(to_numpy(got), np.fft.fftn(m), atol=CUBE_ATOL)


@pytest.mark.parametrize("n", [8, 14, 16])
def test_pfft3_fpm_matches_reference(n):
    ref_fpms, port_fpms = both_fpms(n, p=3)
    m = cube(n, seed=1)
    want, ref_part = ref_pfft3d.pfft3_fpm(jnp.asarray(m), ref_fpms,
                                          return_partition=True)
    got, part = port_pfft3d.pfft3_fpm(to_torch(m), port_fpms,
                                      config=port_plan.PlanConfig(radix=4),
                                      return_partition=True)
    np.testing.assert_array_equal(part.d, ref_part.d)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=CUBE_ATOL)


@pytest.mark.parametrize("drift", [False, True])
@pytest.mark.parametrize("n", [8, 14, 16])
def test_pfft3_fpm_pad_matches_reference(n, drift):
    """Padded-signal semantics, pads that engage (2N for the fast
    processors); a drifted ``PlanConfig(pad="czt")`` is normalized back to
    the crop on both sides."""
    ref_fpms, port_fpms = both_padding_fpms(n)
    m = cube(n, seed=2)
    kw_ref = {"config": ref_plan.PlanConfig(pad="czt")} if drift else {}
    kw_port = {"config": port_plan.PlanConfig(pad="czt")} if drift else {}
    want, ref_part, ref_pads = ref_pfft3d.pfft3_fpm_pad(
        jnp.asarray(m), ref_fpms, return_partition=True, **kw_ref)
    got, part, pads = port_pfft3d.pfft3_fpm_pad(
        to_torch(m), port_fpms, return_partition=True, **kw_port)
    np.testing.assert_array_equal(part.d, ref_part.d)
    np.testing.assert_array_equal(pads, ref_pads)
    assert max(pads) > n
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=CUBE_ATOL)


def described_mesh(shape, names):
    """A ``DeviceMesh`` that only describes its ranks (no process group, no
    communicator): enough for the refusals made before any collective."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(int(np.prod(shape))).reshape(shape)
    return DeviceMesh("cpu", ranks, mesh_dim_names=names, _init_backend=False,
                      _rank=0)


def test_pfft3_rejects_non_cube_and_mesh_paths_raise():
    """A non-cube is refused on both sides; on a mesh, what is not a
    ``DeviceMesh`` is refused by type, and an N the mesh axes do not divide
    with the reference's message, before any collective."""
    for mod, conv in ((ref_pfft3d, jnp.asarray), (port_pfft3d, to_torch)):
        with pytest.raises(ValueError, match="cubic"):
            mod.pfft3_lb(conv(np.zeros((4, 4, 8), np.complex64)), 2)
    for entry in (port_pfft3d.pfft3_pencil, port_pfft3d.pfft3_slab,
                  port_pfft3d.pfft3_distributed):
        with pytest.raises(TypeError, match="DeviceMesh"):
            entry(to_torch(cube(8)), object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_api.plan_pfft3(8, mesh=object(), device=CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_tune.tune_pfft3(8, object())
    pencil = described_mesh((2, 3), ("fft_r", "fft_c"))
    slab = described_mesh((3,), ("fft",))
    message = "N=8 must be divisible by mesh axis fft_c=3"
    with pytest.raises(ValueError, match=message):
        port_pfft3d.pfft3_pencil(to_torch(cube(8)[:4, :2]), pencil)
    with pytest.raises(ValueError, match=message):
        port_pfft3d.pfft3_distributed(to_torch(cube(8)[:4, :2]), pencil,
                                      ("fft_r", "fft_c"))
    with pytest.raises(ValueError, match=message):
        port_api.plan_pfft3(8, mesh=pencil)
    with pytest.raises(ValueError, match="N=8 must be divisible by mesh axis fft=3"):
        port_pfft3d.pfft3_slab(to_torch(cube(8)[:2]), slab)
    with pytest.raises(ValueError, match=r"N=8 must be divisible by both mesh "
                                         r"axes \(fft_r=2, fft_c=3\)"):
        port_tune.tune_pfft3(8, pencil)


# ------------------------------------------------------------ pfft1_large


@pytest.mark.parametrize("n", [12, 64, 97, 360])
def test_four_step_factors_equal_reference(n):
    assert port_large.four_step_factors(n) == ref_large.four_step_factors(n)
    for kw in ({"n1": 4}, {"n2": 4}, {"n1": 3, "n2": n // 3}, {"n1": 7},
               {"n2": 5}, {"n1": 8, "n2": 44}, {"n1": 0}):
        try:
            want = ref_large.four_step_factors(n, **kw)
        except ValueError as err:
            with pytest.raises(ValueError) as got:
                port_large.four_step_factors(n, **kw)
            assert str(got.value) == str(err)
        else:
            assert port_large.four_step_factors(n, **kw) == want
    with pytest.raises(ValueError) as got:
        port_large.four_step_factors(0)
    with pytest.raises(ValueError) as want:
        ref_large.four_step_factors(0)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n1,n2", [(3, 4), (8, 8), (1, 97), (18, 20),
                                   (1024, 2048)])
def test_twiddle_bit_for_bit(n1, n2):
    want = ref_large._twiddle(n1, n2)
    got = port_large._twiddle(n1, n2)
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    table = port_large.twiddle_table(n1, n2, torch.device(CPU))
    np.testing.assert_array_equal(to_numpy(table), want)


@pytest.mark.parametrize("config", sorted(PORT_CONFIGS))
@pytest.mark.parametrize("n", [12, 64, 97, 360])
def test_pfft1_large_apply_matches_reference(n, config):
    x = line(n, seed=n)
    want = np.asarray(ref_large.pfft1_large_apply(jnp.asarray(x)))
    got = port_large.pfft1_large_apply(
        to_torch(x), config=port_plan.PlanConfig(**PORT_CONFIGS[config]))
    np.testing.assert_allclose(to_numpy(got), want, atol=LINE_ATOL)
    np.testing.assert_allclose(to_numpy(got), np.fft.fft(x), atol=LINE_ATOL)


@pytest.mark.parametrize("kw", [{"n1": 8}, {"n2": 36}])
def test_pfft1_large_pinned_split_matches_reference(kw):
    x = line(360, seed=5)
    want = np.asarray(ref_large.pfft1_large_apply(jnp.asarray(x), **kw))
    got = port_large.pfft1_large_apply(to_torch(x), **kw)
    np.testing.assert_allclose(to_numpy(got), want, atol=LINE_ATOL)


def test_pfft1_large_upcasts_real_and_rejects_scalars():
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    got = port_large.pfft1_large_apply(to_torch(x))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(to_numpy(got), np.fft.fft(x), atol=LINE_ATOL)
    with pytest.raises(ValueError, match="1-D"):
        port_large.pfft1_large_apply(torch.tensor(1.0))


# ------------------------------------------------------------------ plans


def single_panel(ranked: list) -> list:
    """The reference's ranking without a mesh, cut to one pipeline panel:
    every panel count runs the same program on one device, so the port's
    pot holds k = 1 alone (in the reference's order)."""
    return [r for r in ranked if r[0]["pipeline_panels"] == 1]


@pytest.mark.parametrize("tune", ["off", "estimate", "measure"])
@pytest.mark.parametrize("n,p", [(8, 1), (12, 3)])
def test_plan_pfft3_picks_and_keys_equal_reference(n, p, tune, tmp_path):
    """Same lifecycle as the reference's under the ``"cpu"`` constants: the
    pick, the wisdom key (backend = the device type) and the source; a
    measured pick is recorded and served from the store next time."""
    wis = str(tmp_path / "w.json")
    a = ref_api.plan_pfft3(n, p=p, tune=tune, wisdom=wis)
    b = port_api.plan_pfft3(n, p=p, tune=tune, wisdom=str(tmp_path / "p.json"),
                            device=CPU)
    assert b.tuning["wisdom_key"] == a.tuning["wisdom_key"]
    assert b.tuning["source"] == a.tuning["source"] == tune
    if tune == "estimate":
        assert b.config.to_dict() == a.config.to_dict()
        one_panel = single_panel(a.tuning["ranked"])
        assert [r[2] for r in b.tuning["ranked"]] == pytest.approx(
            [r[2] for r in one_panel], rel=1e-12)
        assert [r[0] for r in b.tuning["ranked"]] == [r[0] for r in one_panel]
    m = cube(n, seed=3)
    np.testing.assert_allclose(to_numpy(b.execute(to_torch(m))),
                               np.asarray(a.execute(jnp.asarray(m))),
                               atol=CUBE_ATOL)
    if tune == "measure":
        assert "local_pass_s" in b.tuning["pfft3"]
        raced = [cfg for cfg, _, _ in b.tuning["measured"]]
        assert all(cfg["pipeline_panels"] == 1 for cfg in raced)
        assert len({json.dumps(cfg, sort_keys=True) for cfg in raced}) == len(raced)
        warm = port_api.plan_pfft3(n, p=p, tune=tune,
                                   wisdom=str(tmp_path / "p.json"), device=CPU)
        assert warm.tuning["source"] == "wisdom"
        assert warm.config == b.config and "measured" not in warm.tuning


def test_plan_pfft3_explicit_and_wisdom_served_at_tune_off(tmp_path):
    wis = str(tmp_path / "w.json")
    explicit = port_api.plan_pfft3(8, config=port_plan.PlanConfig(radix=2, pad="fpm"),
                                   device=CPU)
    assert explicit.tuning["source"] == "explicit"
    assert explicit.config.pad == "none"       # normalized, as the reference
    key = port_plan.wisdom_key(n=8, dtype="complex64", p=1, method="pfft3-lb",
                               backend=CPU)
    port_plan.record_wisdom(wis, key, port_plan.PlanConfig(radix=4),
                            mode="measure", time_s=1.0)
    served = port_api.plan_pfft3(8, wisdom=wis, device=CPU)
    assert served.tuning["source"] == "wisdom"
    assert served.config == port_plan.PlanConfig(radix=4)
    with pytest.raises(ValueError, match="signals"):
        served.execute(to_torch(cube(4)))
    with pytest.raises(ValueError, match="complex"):
        port_api.plan_pfft3(8, dtype="float32", device=CPU)
    with pytest.raises(ValueError, match="1 <= p <= N"):
        port_api.plan_pfft3(8, p=9, device=CPU)


@pytest.mark.parametrize("tune", ["off", "estimate", "measure"])
@pytest.mark.parametrize("n,kw", [(360, {}), (64, {}), (360, {"n1": 8})])
def test_plan_pfft1_large_picks_and_keys_equal_reference(n, kw, tune, tmp_path):
    a = ref_api.plan_pfft1_large(n, tune=tune, wisdom=str(tmp_path / "r.json"),
                                 **kw)
    b = port_api.plan_pfft1_large(n, tune=tune, wisdom=str(tmp_path / "p.json"),
                                  device=CPU, **kw)
    assert (b.n1, b.n2) == (a.n1, a.n2)
    assert b.tuning["wisdom_key"] == a.tuning["wisdom_key"]
    assert b.tuning["source"] == a.tuning["source"] == tune
    if tune == "estimate":
        assert b.config.to_dict() == a.config.to_dict()
        assert [t for _, t in b.tuning["ranked"]] == pytest.approx(
            [t for _, t in a.tuning["ranked"]], rel=1e-12)
    x = line(n, seed=4)
    np.testing.assert_allclose(to_numpy(b.execute(to_torch(x))),
                               np.asarray(a.execute(jnp.asarray(x))),
                               atol=LINE_ATOL)
    if tune == "measure":
        warm = port_api.plan_pfft1_large(n, tune=tune,
                                         wisdom=str(tmp_path / "p.json"),
                                         device=CPU, **kw)
        assert warm.tuning["source"] == "wisdom" and "measured" not in warm.tuning
        assert warm.config == b.config


def test_pfft1_large_one_shot_matches_reference():
    x = line(360, seed=6)
    want = np.asarray(ref_api.pfft1_large(jnp.asarray(x)))
    np.testing.assert_allclose(to_numpy(port_api.pfft1_large(to_torch(x))), want,
                               atol=LINE_ATOL)
    with pytest.raises(ValueError, match="1-D"):
        port_api.pfft1_large(to_torch(line(8, batch=(2,))))


def test_tune_pfft1_large_drops_radix4_above_the_kernel_limit():
    """At N = 2^26, 2^27 (phases 8192 x 16384) and 2^29 (16384 x 32768, the
    second through K1b) the port ranks the reference's configs, ``radix=4``
    included, at the same estimates.  Only where a phase passes the complex
    row FFT's top ``MAX_LARGE_N`` (2^58: two phases of 2^29) does the port
    drop ``radix=4``; the rest of that ranking is the reference's.  Estimate
    only — nothing is allocated."""
    params = {"params": ref_plan.CostParams.for_backend("cpu")}
    splits = {1 << 26: (8192, 8192), 1 << 27: (8192, 16384),
              1 << 29: (16384, 32768), 1 << 58: (1 << 29, 1 << 29)}
    for n, (n1, n2) in splits.items():
        _, a = ref_tune.tune_pfft1_large(n, **params)
        _, b = port_tune.tune_pfft1_large(
            n, params=port_plan.CostParams.for_backend("cpu"))
        assert b["four_step"] == a["four_step"] == {"n1": n1, "n2": n2}
        kept = [(cfg, t) for cfg, t in a["ranked"]
                if cfg["radix"] != 4 or max(n1, n2) <= MAX_LARGE_N]
        assert [cfg for cfg, _ in b["ranked"]] == [cfg for cfg, _ in kept]
        assert [t for _, t in b["ranked"]] == pytest.approx([t for _, t in kept],
                                                            rel=1e-12)
        radices = sorted((cfg["radix"] for cfg, _ in b["ranked"]), key=str)
        assert radices == ([2, 4, None] if max(n1, n2) <= MAX_LARGE_N else [2, None])


def test_plan_pfft1_large_radix4_above_the_limit_raises_before_allocating(monkeypatch):
    """``radix=4`` at 2^27 (phases 8192 x 16384, both K1) and 2^29 (16384 x
    32768, K1 and K1b) resolves to the kernel backend for both phases; only
    a phase above ``MAX_LARGE_N`` (2^58) raises, naming that top, before the
    twiddle table is made.  No table is built here (1 GiB at 2^27):
    ``twiddle_table`` is replaced by a recorder."""
    made = []
    monkeypatch.setattr(port_large, "twiddle_table",
                        lambda n1, n2, device: made.append((n1, n2)))
    config = port_plan.PlanConfig(radix=4)
    for n, split in ((1 << 27, (8192, 16384)), (1 << 29, (16384, 32768))):
        plan = port_api.plan_pfft1_large(n, config=config, device=CPU)
        assert (plan.n1, plan.n2) == split and made[-1] == split
        assert plan.config.row_fft_kwargs() == {"backend": "cuda", "radix": 4}
        for length in split:
            assert resolve_radix(length, None, "fft_rows_op") == 4
    with pytest.raises(KernelLengthError, match=f"exceeds the kernel limit {MAX_LARGE_N}"):
        port_api.plan_pfft1_large(1 << 58, config=config, device=CPU)
    assert len(made) == 2


def test_tune_pfft3_estimate_equals_reference():
    for n in (8, 12, 16):
        cfg_a, axes_a, a = ref_tune.tune_pfft3(
            n, params=ref_plan.CostParams.for_backend("cpu"))
        cfg_b, axes_b, b = port_tune.tune_pfft3(
            n, params=port_plan.CostParams.for_backend("cpu"))
        assert axes_a is axes_b is None
        assert cfg_b.to_dict() == cfg_a.to_dict()
        assert [r[:2] for r in b["ranked"]] == [r[:2] for r in single_panel(a["ranked"])]
        assert [r[2] for r in b["ranked"]] == pytest.approx(
            [r[2] for r in single_panel(a["ranked"])], rel=1e-12)
        assert b["pfft3"] == a["pfft3"]
        assert port_tune.pfft3_panel_space(n, 1, 1) == ref_tune.pfft3_panel_space(n, 1, 1)
    for args in ((16, 2, 4), (12, 5, 1), (24, 3, 2)):
        assert port_tune.pfft3_panel_space(*args) == ref_tune.pfft3_panel_space(*args)


# ---------------------------------------------------------------- batches


class _Counting:
    """Counts the row-FFT calls the limbs make (``fft_rows``/``rfft_rows``
    as ``core.pfft`` looks them up)."""

    def __init__(self, monkeypatch):
        self.calls = {"fft_rows": 0, "rfft_rows": 0}
        for name in self.calls:
            original = getattr(port_pfft, name)

            def counted(*args, _name=name, _fn=original, **kwargs):
                self.calls[_name] += 1
                return _fn(*args, **kwargs)

            monkeypatch.setattr(port_pfft, name, counted)
            monkeypatch.setattr(port_fft2d, name, counted)

    def take(self):
        out, self.calls = self.calls, {k: 0 for k in self.calls}
        return out


def _plan_cases():
    """(label, plan factory, input maker, reference of one signal)."""
    ref_fpms, port_fpms = both_padding_fpms(16)
    k = port_plan.PlanConfig(radix=4)
    return {
        "lb/radix=4": (lambda: port_api.plan_pfft(16, p=3, method="lb", config=k,
                                                  device=CPU),
                       lambda b: complex_signal(7, *b, 16, 16), np.fft.fft2),
        "fpm-pad/radix=4": (lambda: port_api.plan_pfft(
            16, fpms=port_fpms, method="fpm-pad", config=k, device=CPU),
            lambda b: complex_signal(8, *b, 16, 16), None),
        "lb/fused": (lambda: port_api.plan_pfft(
            16, p=3, method="lb", config=port_plan.PlanConfig(fused=True),
            device=CPU), lambda b: complex_signal(9, *b, 16, 16), np.fft.fft2),
        "rfft-lb/radix=4": (lambda: port_api.plan_pfft(
            16, p=3, method="rfft-lb", config=k, dtype="float32", device=CPU),
            lambda b: complex_signal(10, *b, 16, 16).real.copy(), np.fft.rfft2),
        "rfft-fpm-pad/radix=4": (lambda: port_api.plan_pfft(
            16, fpms=port_fpms, method="rfft-fpm-pad", config=k, dtype="float32",
            device=CPU), lambda b: complex_signal(11, *b, 16, 16).real.copy(),
            None),
        "rfft-lb/fused": (lambda: port_api.plan_pfft(
            16, p=3, method="rfft-lb", config=port_plan.PlanConfig(fused=True),
            dtype="float32", device=CPU),
            lambda b: complex_signal(12, *b, 16, 16).real.copy(), np.fft.rfft2),
        "pfft3/radix=4": (lambda: port_api.plan_pfft3(8, p=3, config=k,
                                                      device=CPU),
                          lambda b: cube(8, seed=13, batch=b), np.fft.fftn),
        "pfft1-large/radix=4": (lambda: port_api.plan_pfft1_large(
            64, config=k, device=CPU), lambda b: line(64, seed=14, batch=b),
            np.fft.fft),
        "pfft1-large/library": (lambda: port_api.plan_pfft1_large(
            360, device=CPU), lambda b: line(360, seed=15, batch=b), np.fft.fft),
    }


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("case", sorted(_plan_cases()))
def test_batched_execute_equals_the_per_signal_loop(case, batch, monkeypatch):
    """``execute`` of a (B, ...) stack equals the per-signal executes, and
    the unfused paths call the row FFT once per dispatch group per phase
    whatever B (the same count as one signal)."""
    make_plan, make_input, oracle = _plan_cases()[case]
    plan = make_plan()
    xs = make_input((batch,))
    counter = _Counting(monkeypatch)
    single = [to_numpy(plan.execute(to_torch(x))) for x in xs]
    per_signal = counter.take()
    got = plan.execute(to_torch(xs))
    stacked = counter.take()
    assert got.shape[0] == batch
    for i in range(batch):
        np.testing.assert_allclose(to_numpy(got[i]), single[i], atol=1e-4)
        if oracle is not None:
            np.testing.assert_allclose(to_numpy(got[i]), oracle(xs[i]),
                                       atol=2e-3 * xs[i].size ** 0.5)
    assert {k: v * batch for k, v in stacked.items()} == per_signal
    if "fused" not in case:
        assert sum(stacked.values()) > 0


def test_unfused_row_calls_per_group_per_phase(monkeypatch):
    """The counts themselves: the padded 2-D plan's groups, two phases;
    three passes of one group for the cube; two phases for the line."""
    cases = _plan_cases()
    counter = _Counting(monkeypatch)
    plan = cases["fpm-pad/radix=4"][0]()
    plan.execute(to_torch(cases["fpm-pad/radix=4"][1]((4,))))
    assert counter.take()["fft_rows"] == 2 * len(plan._groups) > 2
    plan = cases["rfft-fpm-pad/radix=4"][0]()
    plan.execute(to_torch(cases["rfft-fpm-pad/radix=4"][1]((4,))))
    assert counter.take() == {"rfft_rows": len(plan._groups[0]),
                              "fft_rows": len(plan._groups[1])}
    plan = cases["pfft3/radix=4"][0]()
    plan.execute(to_torch(cases["pfft3/radix=4"][1]((4,))))
    assert counter.take()["fft_rows"] == 3
    plan = cases["pfft1-large/radix=4"][0]()
    plan.execute(to_torch(cases["pfft1-large/radix=4"][1]((4,))))
    assert counter.take()["fft_rows"] == 2


@pytest.mark.parametrize("method", ["lb", "rfft-lb"])
def test_fused_batch_equals_the_library(method, monkeypatch):
    """The fused phases of a (2, 3, n, n) stack run as one pass over all
    its rows and a permuting copy: two fused calls whatever the batch, and
    the library's values."""
    real = method == "rfft-lb"
    x = complex_signal(16, 2, 3, 16, 16)
    x = x.real.copy() if real else x
    plan = port_api.plan_pfft(16, p=2, method=method,
                              config=port_plan.PlanConfig(radix=4, fused=True),
                              dtype="float32" if real else "complex64",
                              device=CPU)
    calls = []
    for name in ("fft_rows_then_transpose", "rfft_rows_then_transpose"):
        original = getattr(port_pfft, name)
        monkeypatch.setattr(port_pfft, name, lambda *a, _f=original, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    got = plan.execute(to_torch(x))
    assert got.shape == (2, 3, 16, 9 if real else 16)
    assert len(calls) == 2
    np.testing.assert_allclose(to_numpy(got),
                               np.fft.rfft2(x) if real else np.fft.fft2(x),
                               atol=1e-3)


@pytest.mark.parametrize("kind", ["pfft3", "pfft1-large"])
def test_execute_many_matches_reference(kind):
    if kind == "pfft3":
        a, b = ref_api.plan_pfft3(8, p=2), port_api.plan_pfft3(8, p=2, device=CPU)
        ms = [cube(8, seed=s) for s in range(3)]
    else:
        a, b = ref_api.plan_pfft1_large(96), port_api.plan_pfft1_large(96, device=CPU)
        ms = [line(96, seed=s) for s in range(3)]
    want = a.execute_many(ms, pad_to=4)
    got = b.execute_many(ms, pad_to=4)
    assert len(got) == 3 and all(isinstance(g, np.ndarray) for g in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=CUBE_ATOL)
    with pytest.raises(ValueError, match="stacks"):
        b.execute_many([ms[0][..., :4]])
    assert b.execute_many([]) == []


def test_plan_rejects_a_signal_on_another_device():
    plan = port_api.plan_pfft1_large(64, device=CPU)
    with pytest.raises(ValueError, match="plan lives on"):
        plan.execute(torch.ones(64, dtype=torch.complex64, device="meta"))


def test_new_modules_import_no_jax_and_touch_no_cuda():
    code = (
        "import sys\n"
        "import torch\n"
        "import repro_torch.core.pfft3d, repro_torch.core.pfft_large\n"
        "import repro_torch.launch.serve_fft, repro_torch.plan.tune\n"
        "from repro_torch.kernels import _build\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
        "assert _build._library is None and not torch.cuda.is_initialized()\n"
        "print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert done.returncode == 0 and "CLEAN" in done.stdout, done.stderr[-2000:]
