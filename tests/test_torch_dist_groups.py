"""The host side of the distributed slice against the reference.

``repro_torch.plan.groups`` (``spmd_program_config``,
``device_group_program``, ``DeviceGroupProgram``), the schedule checks of
``repro_torch.core.pfft_dist`` (``validate_spmd_schedule``,
``_validate_real_dist``, ``_coerce_dist_config``, ``ragged_row_layout``,
``default_dist_pad_len``, ``require_mesh_divisible``), ``dist_panel_space``
and ``grouped_dist_schedule`` run on the host alone and equal the
reference's exactly: the same results, or the same exception type with the
same message.  ``topology_digest(mesh=)`` of gloo meshes of 2 and 4 host
ranks (flat, 2 hosts x 2, another axis name) equals the reference's digest
of a 2- and 4-device CPU mesh, string for string.  A mesh keeps its own
host structure: meshes built after it over the same ranks leave it as it
was and reuse its process groups.
"""

import dataclasses
import warnings

import numpy as np
import pytest

import _torch_dist_cases as cases
import repro.core.pfft_dist as ref_dist
import repro.plan as ref_plan
import repro_torch.core.pfft_dist as port_dist
import repro_torch.plan as port_plan

SIDES = ((ref_plan, ref_dist), (port_plan, port_dist))

# name -> (n, d, pad_lengths, config kwargs per entry)
SCHEDULES = {
    "homogeneous": (32, [16, 16], None, [{}, {}]),
    "mixed_radix": (32, [16, 8, 8], None, [{}, {"radix": 2}, {"radix": 2}]),
    "nonadjacent": (32, [8, 8, 8, 8], None, [{}, {"radix": 4}, {}, {"radix": 4}]),
    "mixed_lengths": (48, [24, 24], [64, 96],
                      [{"pad": "fpm"}, {"radix": 2, "pad": "fpm"}]),
    "mixed_pad": (32, [16, 16], [64, 64], [{"pad": "fpm"}, {"pad": "czt"}]),
    "fused_mix": (32, [16, 16], None, [{"radix": 4, "fused": True}, {}]),
    "panels_mix": (32, [16, 16], None, [{"pipeline_panels": 2}, {"radix": 2}]),
    "exchange_mix": (32, [16, 16], None, [{"exchange": "hier"}, {"radix": 2}]),
    "ragged_rows": (32, [12, 20], None, [{}, {"radix": 2}]),
    "short": (32, [8, 8], None, [{}, {"radix": 2}]),
    "real_homogeneous": (32, [16, 16], None, [{"real": True}] * 2),
    "real_mixed": (32, [16, 16], None, [{"real": True},
                                        {"real": True, "radix": 4}]),
}


def _schedule(plan_mod, name):
    n, d, pads, cfgs = SCHEDULES[name]
    return plan_mod.SegmentSchedule.from_parts(
        n, np.asarray(d), None if pads is None else np.asarray(pads),
        [plan_mod.PlanConfig(**c) for c in cfgs])


def _outcome(fn):
    """(result, None) or (None, (exception type name, message))."""
    try:
        return fn(), None
    except (ValueError, KeyError) as err:
        return None, (type(err).__name__, str(err))


def _same(fn_of_side, convert=lambda x: x):
    """Run ``fn_of_side(plan_module, dist_module)`` on both sides and
    compare the results (through ``convert``) or the refusals."""
    (ref, ref_err), (port, port_err) = (_outcome(lambda s=s: fn_of_side(*s))
                                        for s in SIDES)
    assert port_err == ref_err
    if ref_err is None:
        assert convert(port) == convert(ref)


def _as_dict(obj):
    return obj.to_dict() if hasattr(obj, "to_dict") else obj


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_spmd_program_config_matches_reference(name):
    _same(lambda plan, _: plan.spmd_program_config(_schedule(plan, name)),
          _as_dict)


@pytest.mark.parametrize("name", list(SCHEDULES))
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("pad_len", [None, 128])
def test_device_group_program_matches_reference(name, p, pad_len):
    def run(plan, _):
        prog = plan.device_group_program(_schedule(plan, name), p,
                                         pad_len=pad_len)
        return (prog.n, prog.p, [c.to_dict() for c in prog.configs],
                prog.group_of_device, prog.pad_len, prog.describe())
    _same(run)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_validation_matches_reference(name):
    _same(lambda plan, d: d.validate_spmd_schedule(_schedule(plan, name)),
          _as_dict)
    _same(lambda plan, d: d._validate_real_dist(None, _schedule(plan, name)),
          _as_dict)


@pytest.mark.parametrize("config,padded,stockham,panels", [
    (None, None, None, None), (None, "crop", None, None),
    (None, "czt", True, 4), (None, None, False, 2),
    ({"pad": "fpm"}, "crop", None, None), ({"pad": "fpm"}, "czt", None, None),
    ({"radix": 4}, None, True, None), ({}, None, None, 2)])
def test_coerce_dist_config_matches_reference(config, padded, stockham, panels):
    def run(plan, d):
        cfg = None if config is None else plan.PlanConfig(**config)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return d._coerce_dist_config(cfg, None, padded, stockham, panels)
    _same(run, _as_dict)


@pytest.mark.parametrize("config", [{}, {"real": True, "fused": True},
                                    {"real": True, "pipeline_panels": 2},
                                    {"real": True, "exchange": "hier"},
                                    {"real": True, "radix": 4}])
def test_real_dist_config_checks_match_reference(config):
    _same(lambda plan, d: d._validate_real_dist(plan.PlanConfig(**config),
                                                None), _as_dict)


@pytest.mark.parametrize("d,p", [([10, 6, 8, 8, 8, 8, 8, 8], 8),
                                 ([16, 16], 2), ([5, 0, 3], 3), ([4, 4], 3)])
def test_ragged_row_layout_matches_reference(d, p):
    _same(lambda _, dm: dm.ragged_row_layout(np.array(d), p),
          lambda r: (r[0], r[1].tolist()))


@pytest.mark.parametrize("n", [8, 48, 64, 1000, 8192])
@pytest.mark.parametrize("padded", [None, "crop", "czt"])
def test_default_dist_pad_len_matches_reference(n, padded):
    _same(lambda _, d: d.default_dist_pad_len(n, padded))


@pytest.mark.parametrize("n,p", [(64, 4), (64, 3), (48, 0), (7, 7)])
def test_require_mesh_divisible_matches_reference(n, p):
    _same(lambda _, d: d.require_mesh_divisible(n, p, "fft"))


@pytest.mark.parametrize("n", [16, 48, 64, 96, 8192])
@pytest.mark.parametrize("p", [0, 1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("max_panels", [4, 8])
def test_dist_panel_space_matches_reference(n, p, max_panels):
    assert (port_plan.dist_panel_space(n, p, max_panels)
            == ref_plan.dist_panel_space(n, p, max_panels))


def _kernel_params(plan, library, kernel):
    return cases.cheap_kernel_params(plan.CostParams, library, kernel)


@pytest.mark.parametrize("pads", [None, [48, 64, 48, 64], [64, 80, 80, 64]])
@pytest.mark.parametrize("pad", ["none", "fpm", "czt"])
@pytest.mark.parametrize("kernel_cheap", [False, True])
def test_grouped_dist_schedule_matches_reference(pads, pad, kernel_cheap):
    n = 48 if pads and pads[0] == 48 else 64

    def run(plan, _):
        names = ("xla", "pallas") if plan is ref_plan else ("torch", "cuda")
        params = (_kernel_params(plan, *names) if kernel_cheap
                  else plan.CostParams.for_backend("cpu"))
        sched = plan.grouped_dist_schedule(
            n, 4, pad_lengths=None if pads is None else np.array(pads),
            pad=pad, params=params)
        return None if sched is None else sched.to_dict()
    _same(run)


def test_grouped_dist_schedule_mixes_where_the_kernel_helps():
    params = _kernel_params(port_plan, "torch", "cuda")
    sched = port_plan.grouped_dist_schedule(64, 4, pad_lengths=np.array(
        [64, 80, 80, 64]), pad="fpm", params=params)
    assert [e.config.radix for e in sched] == [4, None, None, 4]


def test_port_cpu_constants_are_the_references():
    port = dataclasses.asdict(port_plan.CostParams.for_backend("cpu"))
    ref = dataclasses.asdict(ref_plan.CostParams.for_backend("cpu"))
    rename = {"torch": "xla", "stockham": "stockham", "cuda": "pallas"}
    port["backend_factor"] = {rename[k]: v
                              for k, v in port["backend_factor"].items()}
    ref["backend_factor"] = dict(ref["backend_factor"])
    assert port == ref


# ------------------------------------------------------------ mesh digests

@pytest.fixture(scope="module")
def digests(tmp_path_factory):
    """({p: port digests}, {p: reference digests})."""
    return cases.run_job("digest", str(tmp_path_factory.mktemp("digest")))


@pytest.mark.parametrize("p", cases.WORLDS)
@pytest.mark.parametrize("what", ["flat", "flat_axes", "flat_shape", "named"])
def test_mesh_digest_matches_reference(digests, p, what):
    port, ref = digests
    assert port[p][what] == ref[p][what]


@pytest.mark.parametrize("what", ["hier", "hier_shape"])
def test_host_major_mesh_digest_matches_reference(digests, what):
    port, ref = digests
    assert port[4][what] == ref[4][what]
    assert port[4]["hier"] == "2hx4xfft.cpu.k1-2-4-8"


def test_a_later_mesh_leaves_an_earlier_ones_host_structure(digests):
    port, _ = digests
    later = port[4]["later_meshes"]
    assert later["hier_shape"] == (2, 2)
    assert later["flat_shape"] == (1, 4)
    assert later["hier_digest"] == port[4]["hier"]
    assert later["groups_reused"]
