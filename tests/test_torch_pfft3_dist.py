"""The 3-D mesh pipelines of the port against the reference.

``repro_torch.core.pfft3d.pfft3_pencil`` / ``pfft3_slab`` /
``pfft3_distributed`` and ``plan_pfft3(mesh=)`` run on one gloo world of 4
host ranks (``make_pfft3_mesh(..., device_type="cpu")``: 2x2, 1x4, 4x1 and
4x1 over 2 emulated hosts; the slab on ``make_fft_mesh`` flat and 2 hosts x
2), each rank on its own block; ``repro.core.pfft3d`` runs the same cases on
a forced 4-device CPU (``_torch_pfft3_dist_cases``).  Gathered by mesh
coordinates, every case agrees with the reference within
``2e-4·sqrt(N³)``; pipelined panels and the hierarchical exchange equal the
monolithic and flat runs element for element; estimate picks, orientations,
topology digests and wisdom keys equal the reference's; a measured plan is
recorded once and served to a second plan with nothing measured; and the
refusals carry the reference's messages.
"""

import json

import numpy as np
import pytest

import _torch_dist_cases as base
import _torch_pfft3_dist_cases as cases

N = cases.N
TOL = 2e-4 * N ** 1.5
PENCIL = [(mesh, case) for mesh, names in cases.MESH_CASES.items()
          for case in names]
# Cases whose value is the plain 3-D DFT in fftn order.
EXACT = [(mesh, case) for mesh, case in PENCIL if case not in ("crop", "raw")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(port result, reference result) of the 4-rank world."""
    port, ref = base.run_job("pfft3", str(tmp_path_factory.mktemp("pfft3")),
                             worlds=(cases.RANKS,),
                             module="_torch_pfft3_dist_cases")
    return port[cases.RANKS], ref[cases.RANKS]


def _crop_oracle(x: np.ndarray, length: int) -> np.ndarray:
    """The padded-signal DFT cropped to N bins along every axis."""
    for axis in (2, 1, 0):
        widths = [(0, 0)] * 3
        widths[axis] = (0, length - x.shape[axis])
        x = np.take(np.fft.fft(np.pad(x, widths), axis=axis),
                    np.arange(x.shape[axis]), axis=axis)
    return x


@pytest.mark.parametrize("mesh,case", PENCIL)
def test_pencil_case_matches_reference(world, mesh, case):
    port, ref = world
    key = f"pencil/{mesh}/{case}"
    assert port[key].shape == ref[key].shape == (N, N, N)
    np.testing.assert_allclose(port[key], ref[key], rtol=0, atol=TOL)


@pytest.mark.parametrize("mesh,case", EXACT)
def test_pencil_case_is_the_3d_dft(world, mesh, case):
    np.testing.assert_allclose(world[0][f"pencil/{mesh}/{case}"],
                               np.fft.fftn(cases.cube()), rtol=0, atol=TOL)


@pytest.mark.parametrize("mesh", list(cases.PENCIL_MESHES))
def test_raw_layout_is_the_transposed_dft(world, mesh):
    """``transpose_back=False``: the global ``[k2, k1, k0]`` array."""
    np.testing.assert_allclose(world[0][f"pencil/{mesh}/raw"],
                               np.fft.fftn(cases.cube()).transpose(2, 1, 0),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("key", ["pencil/2x2/crop", "slab/crop"])
def test_crop_case_is_the_padded_signal_dft(world, key):
    np.testing.assert_allclose(world[0][key],
                               _crop_oracle(cases.cube(), cases.PAD_LEN),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("case", list(cases.SLAB_CASES))
def test_slab_case_matches_reference(world, case):
    port, ref = world
    np.testing.assert_allclose(port[f"slab/{case}"], ref[f"slab/{case}"],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("case", [c for c in cases.SLAB_CASES if c != "crop"])
def test_slab_case_is_the_3d_dft(world, case):
    np.testing.assert_allclose(world[0][f"slab/{case}"],
                               np.fft.fftn(cases.cube()), rtol=0, atol=TOL)


@pytest.mark.parametrize("mesh,pair", [
    (mesh, pair) for mesh, names in cases.MESH_CASES.items()
    for pair in cases.PENCIL_EQUAL if set(pair) <= set(names)])
def test_panels_and_hier_equal_the_monolithic_flat_round(world, mesh, pair):
    port = world[0]
    a, b = pair
    assert np.array_equal(port[f"pencil/{mesh}/{a}"], port[f"pencil/{mesh}/{b}"])


@pytest.mark.parametrize("pair", cases.SLAB_EQUAL)
def test_slab_hier_equals_the_flat_rotation(world, pair):
    a, b = pair
    assert np.array_equal(world[0][f"slab/{a}"], world[0][f"slab/{b}"])


@pytest.mark.parametrize("key,entry", [
    *((f"pencil/{mesh}/distributed", f"pencil/{mesh}/library")
      for mesh in cases.PENCIL_MESHES),
    ("slab/distributed", "slab/library")])
def test_distributed_dispatches_on_the_axis_names(world, key, entry):
    assert np.array_equal(world[0][key], world[0][entry])


@pytest.mark.parametrize("name", list(cases.ESTIMATE_PLANS))
def test_estimate_plan_matches_reference(world, name):
    """Pick, orientation, topology digest, wisdom key and ranking equal the
    reference's under the host constants; the plan's transform too."""
    port, ref = world
    assert port["picks"][name] == ref["picks"][name]
    np.testing.assert_allclose(port[f"plan/{name}"], ref[f"plan/{name}"],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(port[f"plan/{name}"],
                               np.fft.fftn(cases.cube()), rtol=0, atol=TOL)


def test_transposed_mesh_gets_its_own_key(world):
    picks = world[0]["picks"]
    keys = {picks[name]["key"] for name in ("1x4", "1x4_swapped", "4x1")}
    assert len(keys) == 3
    assert picks["4x1h2"]["topology"].startswith("2hx")


@pytest.mark.parametrize("mesh", cases.MEASURE_MESHES)
def test_measured_plan_is_recorded_once_and_served(world, mesh):
    """Every rank picks alike; the first rank's record holds the
    orientation, topology and comm sample; the second plan comes from
    wisdom with nothing measured, and leaves the store as it was."""
    port, ref = world
    seen = [rank[mesh] for rank in port["measured"]]
    first = seen[0]["first"]
    assert all(s["first"] == first and s["measured"] == seen[0]["measured"]
               for s in seen)
    assert first["source"] == "measure" and seen[0]["measured"]
    assert first["key"] == ref["picks"][mesh]["key"]
    for s in seen:
        assert s["second"]["source"] == "wisdom"
        assert not s["second_measured"]
        assert s["store_after"] == s["store"]
        assert (s["second"]["describe"], s["second"]["orientation"]) == \
            (first["describe"], first["orientation"])
    entry = json.loads(seen[0]["store"])["entries"][first["key"]]
    assert entry["pfft3_orientation"] == first["orientation"]
    assert entry["topology"] == first["topology"]
    assert entry["comm_bytes"] == seen[0]["pfft3"]["comm_bytes"]
    assert entry["comm_time_s"] == seen[0]["pfft3"]["comm_time_meas_s"] >= 0
    assert entry.get("hosts", 1) == seen[0]["pfft3"]["hosts"]
    np.testing.assert_allclose(port[f"measure/{mesh}"],
                               np.fft.fftn(cases.cube()), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", list(cases.DEFAULT_MESHES))
def test_make_pfft3_mesh_defaults_match_reference(world, name):
    """The most-square ``r <= c`` split, ``r = hosts`` under ``hosts=``,
    the other extent derived from one, and the hosts on the ``r`` axis."""
    port, ref = world
    assert port["layouts"][name] == ref["layouts"][name]


@pytest.mark.parametrize("call", [
    "hosts_not_dividing_r", "fused", "schedule_and_config", "not_divisible", "plan_not_divisible",
    "slab_not_divisible", "panels_not_dividing", "plan_p_conflict",
    "plan_batch"])
def test_refusal_matches_reference(world, call):
    port, ref = world
    assert ref["errors"][call] is not None
    assert port["errors"][call] == ref["errors"][call]


@pytest.mark.parametrize("call,error", [
    ("not_a_mesh", "TypeError"), ("unknown_axis", "KeyError"),
    ("not_this_ranks_block", "ValueError"),
    ("mesh_not_the_world", "ValueError")])
def test_port_refuses_what_is_not_this_ranks_pencil(world, call, error):
    assert world[0]["errors"][call][0] == error
