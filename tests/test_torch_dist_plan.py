"""``plan_pfft(mesh=...)`` and the distributed tuners of the port against
the reference.

On gloo worlds of 2 and 4 host ranks, the port's plans (``lb``,
``fpm-pad``, ``fpm-czt``, ``rfft-lb``), ``rfft2(mesh=)`` and
``make_pfft2_fn`` run on each rank's row block; the reference runs the same
plans on a forced 2- and 4-device CPU (``_torch_dist_cases``).  The outputs
agree within ``2e-4·N``; the wisdom keys agree string for string; and under
the host constants (``CostParams.for_backend("cpu")``, the reference's) the
estimate picks and rankings of ``tune_dist_config``, ``tune_rfft_dist`` and
``tune_dist_schedule`` agree pick for pick.  On 2 ranks a measured plan is
recorded by the first rank and served to a second plan on every rank; a
raw ``pfft2_distributed(tune="measure", wisdom=)`` call is served from that
entry, and records under the same key in a fresh store.
"""

import json

import numpy as np
import pytest

import _torch_dist_cases as cases

N = cases.N
TOL = 2e-4 * N
PLANS = ["lb", "lb_fused", "lb_estimate", "fpm_pad", "fpm_czt", "rfft_lb",
         "rfft_lb_radix4"]
TUNERS = ["config/none", "config/fpm", "config/czt", "rfft", "schedule",
          "schedule/fpm", "config/kernel", "schedule/kernel"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """({p: port result}, {p: reference result})."""
    return cases.run_job("plan", str(tmp_path_factory.mktemp("dist_plan")))


@pytest.mark.parametrize("p", cases.WORLDS)
@pytest.mark.parametrize("name", PLANS + ["rfft2", "pfft2_fn", "pfft2_fn_tuned"])
def test_planned_transform_matches_reference(worlds, p, name):
    port, ref = worlds
    assert port[p][name].shape == ref[p][name].shape
    np.testing.assert_allclose(port[p][name], ref[p][name], rtol=0, atol=TOL)


@pytest.mark.parametrize("p", cases.WORLDS)
@pytest.mark.parametrize("name,oracle", [
    ("lb", "fft2"), ("lb_fused", "fft2"), ("lb_estimate", "fft2"),
    ("fpm_czt", "fft2"), ("pfft2_fn", "fft2"), ("pfft2_fn_tuned", "fft2"),
    ("rfft_lb", "rfft2"), ("rfft_lb_radix4", "rfft2"), ("rfft2", "rfft2")])
def test_planned_transform_is_the_dft(worlds, p, name, oracle):
    x = cases.signal() if oracle == "fft2" else cases.real_signal()
    want = np.fft.fft2(x) if oracle == "fft2" else np.fft.rfft2(x)
    np.testing.assert_allclose(worlds[0][p][name], want, rtol=0, atol=TOL)


@pytest.mark.parametrize("p", cases.WORLDS)
@pytest.mark.parametrize("name", ["lb_batch", "lb_many"])
def test_distributed_plan_batches_signal_by_signal(worlds, p, name):
    """A stack of row blocks (and ``execute_many`` of host blocks) gives
    each signal's transform."""
    got = worlds[0][p][name]                          # (N, 2, N) rows
    want = np.fft.fft2(cases.signal())
    for i, scale in enumerate((1, 2)):
        np.testing.assert_allclose(got[:, i], scale * want, rtol=0,
                                   atol=scale * TOL)


@pytest.mark.parametrize("p", cases.WORLDS)
@pytest.mark.parametrize("name", PLANS)
def test_plan_picks_and_keys_match_reference(worlds, p, name):
    port, ref = worlds
    assert port[p]["picks"][name] == ref[p]["picks"][name]
    assert port[p]["keys"][name] == ref[p]["keys"][name]


def test_fpm_pad_plan_pads_and_groups(worlds):
    """The FPMs' pads engage (the fast ranks at 2N) and the schedule's
    entries run at them."""
    for p in cases.WORLDS:
        entries = worlds[0][p]["picks"]["fpm_pad"]["entries"]
        assert [e["length"] for e in entries] == [N] + [2 * N] * (p - 1)


@pytest.mark.parametrize("p", cases.WORLDS)
@pytest.mark.parametrize("tuner", TUNERS)
def test_estimate_tuner_matches_reference(worlds, p, tuner):
    port, ref = worlds
    assert port[p]["tuned"][tuner] == ref[p]["tuned"][tuner]


def test_kernel_cheap_estimates_pick_the_kernel_and_group_the_pads(worlds):
    """Under constants that price the kernel below the library, the picks
    the parity above holds are not the library's default: the kernel
    config, and over the mixed pads a grouped candidate (the kernel on the
    power-of-two rank, the library on the others) priced beside it."""
    for p in cases.WORLDS:
        tuned = worlds[0][p]["tuned"]
        assert tuned["config/kernel"]["pick"]["radix"] == 4
        radices = [e["config"]["radix"]
                   for e in tuned["schedule/kernel"]["grouped"]["entries"]]
        assert radices == [4] + [None] * (p - 1)


def test_estimate_tuner_on_a_host_major_mesh_matches_reference(worlds):
    """On 2 emulated hosts x 2 the pot gains the hierarchical exchange."""
    port, ref = worlds
    tuned = port[4]["tuned"]["config/hier"]
    assert tuned == ref[4]["tuned"]["config/hier"]
    assert any(c["exchange"] == "hier" for c in tuned["ranked"])


def test_grouped_race_times_are_agreed_by_every_rank(worlds):
    raced = worlds[0][2]["raced"]
    assert raced[0] == raced[1] and len(raced[0]) == 2
    assert all(t > 0 for t in raced[0])


def test_measured_plan_is_recorded_once_and_served_to_every_rank(worlds):
    port = worlds[0][2]
    seen = port["measure"]
    assert len(seen) == 2
    for rank in seen:
        assert rank["first"][0] == "measure"
        assert rank["second"][0] == "wisdom"
        assert rank["second"][1] == rank["first"][1]
        assert rank["time_s"] > 0 and len(rank["measured"]) >= 1
    # Every rank ranked the same (agreed) times and took the same pick.
    assert seen[0] == seen[1]
    entries = json.loads(port["store"])["entries"]
    assert len(entries) == 1
    (key, entry), = entries.items()
    assert key.endswith("|topo=2xfft.cpu.k1-2-4-8")
    assert "backend=cpu" in key and entry["mode"] == "measure"
    assert entry["topology"] == "2xfft.cpu.k1-2-4-8"
    np.testing.assert_allclose(port["measure_out"], np.fft.fft2(cases.signal()),
                               rtol=0, atol=TOL)


def test_raw_measured_call_shares_the_plans_wisdom(worlds):
    port = worlds[0][2]
    assert port["raw_served"]
    np.testing.assert_array_equal(port["raw_out"], port["measure_out"])
    plan_keys = set(json.loads(port["store"])["entries"])
    raw_entries = json.loads(port["raw_store"])["entries"]
    assert set(raw_entries) == plan_keys
    (entry,) = raw_entries.values()
    assert entry["mode"] == "measure"
    assert entry["topology"] == "2xfft.cpu.k1-2-4-8"
