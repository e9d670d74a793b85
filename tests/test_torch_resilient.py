"""The self-healing runtime of the port against the reference.

In process: ``ResilientPlan``'s synthesised baseline FPMs and degraded
wisdom keys (string for string the reference's), and a plan on a world of
one gloo rank against the reference's on one device.

On one gloo world of 4 host ranks beside the reference on a forced 4-device
CPU (``tests/_torch_runtime_cases.py``, N = 48): the fault hook on
``pfft2_distributed`` (output identical to the healthy run, the slowed
rank's FFT run 3x); the elastic helpers on the whole world; the reference's
straggler script and loss script (``tests/test_resilient.py``) with the
probe times a seeded sequence patched into both sides — equal events,
swapped schedules, wisdom keys and topology digests, outputs within
``2e-4·N``, and on the 3-rank world rebuilt after the loss a second plan
served from wisdom with every measure entry point poisoned; and the agreed
measurement retries of the distributed tuners (a failure on rank 1 alone
retried, or given up for the same fallback, on every rank).  No test here
reads a clock.
"""

import json
import os
import pickle
import socket
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist_cases as base
import _torch_runtime_cases as cases

N = cases.N
TOL = 2e-4 * N
RANKS = cases.RANKS


# ---------------------------------------------------------- in-process

def _Stub(cls, mesh, **fields):
    """A ``cls`` (either package's ``ResilientPlan``) holding only what
    ``_baseline_fpms`` and ``_degraded_key`` read, at p = 4: the
    reference's test builds the same stub."""
    class Stub(cls):
        p = property(lambda self: 4)

        def __init__(self):
            self.n, self.method, self.dtype = 48, "lb", "complex64"
            self.axis_name, self.fpms, self.retune_params = "fft", None, None
            self.mesh = mesh
            self.__dict__.update(fields)

    return Stub()


@pytest.fixture(scope="module")
def one_rank_world():
    """A gloo world of this process alone, taken down after the module."""
    from repro_torch.launch.mesh import init_multihost
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_multihost(f"127.0.0.1:{port}", 1, 0, device_type="cpu")
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshes(one_rank_world):
    """(port mesh of one rank, reference mesh of one device)."""
    from repro.launch.mesh import make_fft_mesh as ref_make
    from repro_torch.launch.mesh import make_fft_mesh
    return make_fft_mesh(1, device_type="cpu"), ref_make(1)


def test_baseline_fpms_synthesized_when_absent():
    from repro.runtime.resilient import ResilientPlan as Ref
    from repro_torch.runtime.resilient import ResilientPlan
    got = _Stub(ResilientPlan, types.SimpleNamespace(device_type="cpu"))._baseline_fpms()
    want = _Stub(Ref, None)._baseline_fpms()
    assert got.p == want.p == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.xs, b.xs)
        np.testing.assert_array_equal(a.ys, b.ys)
        np.testing.assert_array_equal(a.speed, b.speed)
        assert np.isfinite(a.speed).all() and a.name == b.name


@pytest.mark.parametrize("rel", [[1.0, 1.0, 1.0, 0.33], [1.0, 1.0, 1.0, 0.34],
                                 [1.0, 1.0, 1.0, 0.50], [0.31, 1.02, 0.97, 1.0]])
@pytest.mark.parametrize("method,pads", [("lb", None),
                                         ("fpm-pad", [48, 64, 64, 48])])
def test_degraded_wisdom_key_matches_reference(meshes, rel, method, pads):
    from repro.runtime.resilient import ResilientPlan as Ref
    from repro_torch.runtime.resilient import ResilientPlan
    port_mesh, ref_mesh = meshes
    pads = None if pads is None else np.array(pads)
    got = _Stub(ResilientPlan, port_mesh, method=method)._degraded_key(np.array(rel), pads)
    want = _Stub(Ref, ref_mesh, method=method)._degraded_key(np.array(rel), pads)
    assert got == want
    assert "degraded-" in got[0]


def test_degraded_wisdom_key_isolated_from_healthy(meshes):
    from repro_torch.plan.wisdom import topology_digest, wisdom_key
    from repro_torch.runtime.resilient import ResilientPlan
    rp = _Stub(ResilientPlan, meshes[0])
    k1 = rp._degraded_key(np.array([1.0, 1.0, 1.0, 0.33]), None)[0]
    k2 = rp._degraded_key(np.array([1.0, 1.0, 1.0, 0.34]), None)[0]
    k3 = rp._degraded_key(np.array([1.0, 1.0, 1.0, 0.50]), None)[0]
    assert k1 == k2 and k1 != k3
    healthy = wisdom_key(n=48, dtype="complex64", p=4, method="lb",
                         backend="cpu",
                         topology=topology_digest(rp.mesh, "fft"))
    assert k1 != healthy


@pytest.mark.parametrize("config", [{}, {"radix": 4}, {"radix": 4, "fused": True}])
def test_one_rank_plan_matches_reference(meshes, config):
    """Five calls at p = 1: within ``2e-4·N`` of the reference's and of
    ``fft2``; one group, so no drift can fire."""
    from repro.plan import PlanConfig as RefConfig
    from repro.runtime.resilient import ResilientPlan as Ref
    from repro_torch.plan import PlanConfig
    from repro_torch.runtime.resilient import ResilientPlan
    port_mesh, ref_mesh = meshes
    x = cases.signal(5)
    rp = ResilientPlan(N, mesh=port_mesh, config=PlanConfig(**config))
    ref = Ref(N, mesh=ref_mesh, config=RefConfig(**config))
    for _ in range(5):
        got = rp.execute(x)
        want = np.asarray(ref.execute(x))
    assert rp.plan.tuning["source"] == ref.plan.tuning["source"] == "explicit"
    assert rp.schedule.describe() == ref.schedule.describe()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.fft.fft2(x), atol=TOL)
    assert rp.calls == 5 and len(rp.step_times) == 5
    assert rp.events == [] and rp.monitor.slow_groups() == []


def test_execute_takes_the_whole_signal(meshes):
    from repro_torch.runtime.resilient import ResilientPlan
    rp = ResilientPlan(N, mesh=meshes[0])
    with pytest.raises(ValueError, match="whole"):
        rp.execute(np.zeros((N // 2, N), np.complex64))
    got = rp.execute(torch.from_numpy(cases.signal(6)))
    assert got.shape == (N, N) and got.dtype == torch.complex64


def test_probe_times_one_entry_per_position(meshes):
    from repro_torch.runtime import inject
    from repro_torch.runtime.resilient import ResilientPlan
    rp = ResilientPlan(N, mesh=meshes[0])
    with inject() as inj:
        inj.slow_group(0, 3)
        times = rp._probe_group_times()
    assert len(times) == 1 and np.isfinite(times[0]) and times[0] > 0


def test_single_device_pfft3_measure_falls_back_as_the_reference(monkeypatch):
    """Without a mesh ``tune_pfft3`` retries a failed race, then serves the
    estimate ranking (``measure_fallback``), as the reference's does; with
    no retries the failure raises."""
    import repro_torch.plan.tune as T

    def boom(*a, **k):
        raise RuntimeError("race failed")

    monkeypatch.setattr(T, "_timed_min", boom)
    monkeypatch.setattr(T.time, "sleep", lambda s: None)
    cfg, axes, info = T.tune_pfft3(8, mode="measure", measure_retries=1,
                                   device="cpu", reps=1)
    assert axes is None
    assert info["measure_fallback"].startswith("measurement failed after 1 retries")
    assert cfg == T.tune_pfft3(8, device="cpu")[0]
    with pytest.raises(RuntimeError, match="race failed"):
        T.tune_pfft3(8, mode="measure", device="cpu", reps=1)


# --------------------------------------------------- the 4-rank world

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(port result, reference result, tmp dir) of the 4-rank world."""
    tmp = str(tmp_path_factory.mktemp("runtime"))
    port, ref = base.run_job("runtime", tmp, worlds=(RANKS,),
                             module="_torch_runtime_cases")
    return port[RANKS], ref[RANKS], tmp


def _every_rank(port, part):
    return [r[part] for r in port["ranks"]]


@pytest.mark.parametrize("case", ["radix4", "fused"])
def test_fault_hook_output_equals_the_healthy_run(world, case):
    for seen in _every_rank(world[0], "hook"):
        assert seen[case]["equal"]


@pytest.mark.parametrize("case,fn", [("radix4", "fft"), ("fused", "fused")])
def test_fault_hook_runs_the_slowed_rank_three_times(world, case, fn):
    calls = [seen[case]["calls"][fn] for seen in _every_rank(world[0], "hook")]
    assert calls == [2, 2 * cases.SLOW, 2, 2]


@pytest.mark.parametrize("case", ["radix4", "fused"])
def test_fault_hook_matches_reference(world, case):
    port, ref, _ = world
    key = f"hook/{case}"
    np.testing.assert_allclose(port["blocks"][key], ref["blocks"][key], atol=TOL)
    np.testing.assert_allclose(port["blocks"][key], np.fft.fft2(cases.signal()),
                               atol=TOL)


@pytest.mark.parametrize("field", ["grid", "odd", "fft", "largest_fft_axis"])
def test_elastic_helpers_match_reference(world, field):
    port, ref, _ = world
    for seen in _every_rank(port, "hook"):
        got = seen["elastic"][field]
        want = ref["elastic"][field]
        if field in ("grid", "odd"):
            got = got[:2]
        assert tuple(np.atleast_1d(got)) == tuple(np.atleast_1d(want))


def test_rebuild_mesh_drops_the_rank_past_the_grid(world):
    placed = [seen["elastic"]["odd"][2] for seen in _every_rank(world[0], "hook")]
    assert placed == [True, True, True, False]


def test_reshard_cuts_rows_and_replicates(world):
    for seen in _every_rank(world[0], "hook"):
        assert seen["elastic"]["rows_equal"]
        assert seen["elastic"]["replicated"] == list(range(8))


def test_straggler_initial_plan_matches_reference(world):
    port, ref, _ = world
    for seen in _every_rank(port, "straggler"):
        assert tuple(seen["initial"]) == tuple(ref["straggler"]["initial"])
    assert ref["straggler"]["initial"][0] == "homogeneous"


def test_straggler_hot_swaps_within_the_bound(world):
    port, ref, _ = world
    for seen in _every_rank(port, "straggler"):
        assert seen["swapped"]
        assert seen["loop_calls"] == ref["straggler"]["loop_calls"] < cases.LOOP_CALLS
        assert seen["final_configs"] == 2 and seen["source"] == "estimate"


@pytest.mark.parametrize("field", cases.REPLAN_FIELDS)
def test_straggler_event_field_matches_reference(world, field):
    port, ref, _ = world
    want = [e[field] for e in ref["straggler"]["events"]]
    assert want
    for seen in _every_rank(port, "straggler"):
        assert [e[field] for e in seen["events"]] == want


def test_straggler_replan_names_the_slowed_group(world):
    swap = world[0]["ranks"][0]["straggler"]["events"][0]
    assert swap["kind"] == "replan" and 0 in swap["slow_groups"]
    assert swap["relative_speeds"][0] < 0.7 and swap["swap_call"] > swap["call"]
    assert all(t > 0 for t in world[0]["ranks"][0]["straggler"]["replan_s"])


def test_straggler_swapped_schedule_equals_oracle_and_reference(world):
    port, ref, _ = world
    for seen in _every_rank(port, "straggler"):
        assert seen["final"] == seen["oracle"] == ref["straggler"]["final"]
    assert ref["straggler"]["oracle"] == ref["straggler"]["final"]


@pytest.mark.parametrize("key", ["straggler/out0", "straggler/out1"])
def test_straggler_outputs_match_reference(world, key):
    port, ref, _ = world
    np.testing.assert_allclose(port["blocks"][key], ref["blocks"][key], atol=TOL)


def test_straggler_output_survives_the_swap(world):
    blocks = world[0]["blocks"]
    np.testing.assert_allclose(blocks["straggler/out1"], blocks["straggler/out0"],
                               atol=TOL)


@pytest.mark.parametrize("field", cases.LOSS_FIELDS)
def test_loss_event_field_matches_reference(world, field):
    port, ref, _ = world
    want = [e[field] for e in ref["loss"]["events"]]
    assert len(want) == 2
    for seen in port["survivors"]:
        assert [e[field] for e in seen["events"]] == want


def test_loss_rebuilds_a_world_of_the_survivors(world):
    port, ref, _ = world
    assert len(port["survivors"]) == 3
    for seen in port["survivors"]:
        assert seen["p"] == seen["world"] == ref["loss"]["p"] == 3
        assert all(t > 0 for t in seen["recover_s"])


def test_loss_topology_digest_changes(world):
    port, ref, _ = world
    for seen in port["survivors"]:
        topo3 = seen["events"][0]["topology"]
        assert seen["topo4"] == ref["loss"]["topo4"]
        assert topo3 is not None and topo3 != seen["topo4"]


def test_loss_lost_rank_leaves_and_reraises(world):
    _, _, tmp = world
    departed = sorted(f for f in os.listdir(tmp) if f.startswith("departed_"))
    assert departed == [f"departed_{r}.json" for r in cases.LOST]
    with open(os.path.join(tmp, departed[0])) as fh:
        assert json.load(fh) == {"lost": list(cases.LOST), "mesh": True}


def test_loss_state_is_resharded(world):
    port, ref, _ = world
    for seen in port["survivors"]:
        assert seen["state_shape"] == (N // 3, N) and seen["state_equal"]
    assert ref["loss"]["state_axis"] == 3


def test_loss_naming_no_position_keeps_the_checked_in_ranks(world):
    for seen in world[0]["survivors"]:
        unknown = seen["events"][1]
        assert unknown["lost"] == [] and unknown["survivors"] == 3
        assert (unknown["devices"], unknown["dropped"]) == (3, 0)
        assert unknown["topology"] == seen["events"][0]["topology"]


@pytest.mark.parametrize("key", ["loss/first", "loss/retried", "loss/unknown",
                                 "loss/second"])
def test_loss_outputs_match_reference(world, key):
    port, ref, _ = world
    np.testing.assert_allclose(port["blocks"][key], ref["blocks"][key], atol=TOL)
    np.testing.assert_allclose(port["blocks"][key], np.fft.fft2(cases.signal(1)),
                               atol=TOL)


def test_loss_second_plan_served_from_wisdom(world):
    port, ref, _ = world
    for seen in port["survivors"]:
        assert seen["second_source"] == ref["loss"]["second_source"] == "wisdom"


def _retry(port, case):
    return [r[case] for r in _every_rank(port, "retry")]


def test_agreed_retry_after_one_rank_failed(world):
    seen = _retry(world[0], "once")
    assert all(s["runs"] == 2 and s["fallback"] is None for s in seen)
    assert all(s["pick"] == seen[0]["pick"] and s["measured"] == seen[0]["measured"]
               for s in seen)
    assert seen[0]["measured"]


def test_agreed_retry_spent_falls_back_alike(world):
    seen = _retry(world[0], "spent")
    estimate = world[0]["ranks"][0]["retry"]["estimate"]["config"]
    assert all(s["runs"] == 3 for s in seen)
    assert len({s["fallback"] for s in seen}) == 1
    assert seen[0]["fallback"].startswith("measurement failed after 2 retries")
    assert all(s["pick"] == estimate and not s["measured"] for s in seen)


def test_no_retries_raises_on_every_rank(world):
    seen = _retry(world[0], "no_retries")
    assert all(s["raised"] == "RuntimeError" and s["runs"] == 1 for s in seen)
    assert "injected failure" in seen[1]["message"]
    assert all("a rank's measurement failed" in s["message"]
               for r, s in enumerate(seen) if r != 1)


def test_agreed_retry_lost_comm_sample_keeps_the_winner(world):
    seen = _retry(world[0], "comm_sample")
    assert len({s["comm_sample_error"] for s in seen}) == 1
    assert seen[0]["comm_sample_error"] and seen[0]["fallback"] is None
    assert all(s["pick"] == seen[0]["pick"] for s in seen)


@pytest.mark.parametrize("case,estimate", [("rfft_spent", "rfft"),
                                           ("schedule_spent", None),
                                           ("pfft3_spent", "pfft3")])
def test_agreed_retry_spent_on_every_tuner(world, case, estimate):
    seen = _retry(world[0], case)
    assert len({s["fallback"] for s in seen}) == 1 and seen[0]["fallback"]
    assert all(s["pick"] == seen[0]["pick"] for s in seen)
    if estimate is not None:
        assert seen[0]["pick"] == world[0]["ranks"][0]["retry"]["estimate"][estimate]


# ------------------------------------------------- torchrun's agent store

def test_init_multihost_joins_torchrun_agent_store(tmp_path):
    """Under torchrun the agent serves the store on ``MASTER_PORT`` and
    tells its workers to join it as clients (``TORCHELASTIC_USE_AGENT_STORE``).
    Two ranks started so, beside a store served here as the agent's, join
    through ``make_fft_mesh``, transform on the mesh (within ``2e-4·N`` of
    numpy), and rebuild the world on that store with their ranks swapped;
    the rebuilt world's ``world_store`` does not see the first world's keys.
    """
    agent = dist.TCPStore("127.0.0.1", 0, 3, True, wait_for_workers=False)
    out = str(tmp_path / "agent")
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(agent.port),
           "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2",
           "TORCHELASTIC_USE_AGENT_STORE": "True",
           "TORCHELASTIC_RESTART_COUNT": "0", "DIST_OUT": out}
    procs = [base._start("agent_store_main",
                         base._env(dict(env, RANK=str(r), LOCAL_RANK=str(r))),
                         "_torch_runtime_cases") for r in range(2)]
    errors = []
    for r, proc in enumerate(procs):
        _, err = proc.communicate(timeout=base.TIMEOUT_S)
        if proc.returncode:
            errors.append(f"rank {r} exited {proc.returncode}:\n{err[-3000:]}")
    assert not errors, "\n".join(errors)
    seen = []
    for r in range(2):
        with open(f"{out}.{r}", "rb") as fh:
            seen.append(pickle.load(fh))
    whole = np.fft.fft2(cases.signal(3)[:8, :8])
    got = np.concatenate([s["block"] for s in seen], axis=0)
    assert np.max(np.abs(got - whole)) <= 2e-4 * 8
    assert [(s["world"], s["new_world"], s["new_rank"]) for s in seen] == [
        (2, 2, 1), (2, 2, 0)]
    assert all(s["rank_sum"] == 1 and not s["old_key_seen"] for s in seen)
