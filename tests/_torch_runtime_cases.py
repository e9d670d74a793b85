"""Cases of the self-healing runtime's distributed parity tests, and the two
programs that run them.

``_torch_dist_cases.run_job("runtime", tmp, worlds=(4,), module=__name__)``
starts 4 processes of the port as the ranks of one gloo world on the host
(joined through ``launch.mesh.init_multihost``; a rebuilt world forms on
the store it joined on) and one process of the JAX package on a forced
4-device CPU, at once.  In order, both sides run:

* ``hook``: the fault hook on ``pfft2_distributed`` (position 1 slowed 3x),
  and the elastic helpers on the whole world;
* ``straggler``: the reference's straggler script (``tests/
  test_resilient.py``) — an injected 3x slowdown of position 0 detected,
  re-planned and hot-swapped;
* ``loss``: the reference's loss script — position 3 lost at a call, the
  world rebuilt to 3 ranks, registered state re-sharded, the call retried;
  then a loss that names no position (the survivors check in: all 3), and
  a second plan on the 3 survivors served from wisdom.

The probe times of both sides are one seeded sequence patched into
``ResilientPlan._probe_group_times`` (the slowed position's time multiplied
by its repeat count), so the decisions depend on no clock.  The port alone
also runs ``retry``: the agreed measurement retries of the distributed
tuners, a failure injected on rank 1.  Rank 0 gathers the ranks' blocks
and every rank's own record.  The module imports neither package at the
top: each program imports its own.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle

import numpy as np

import _torch_dist_cases as base

N = 48
RANKS = 4
SLOW = 3                     # repeat count of the slowed position
LOOP_CALLS = 30              # calls within which the hot-swap must happen
LOST = (3,)
# Event fields that must equal the reference's (the rest are clock times).
REPLAN_FIELDS = ("kind", "call", "slow_groups", "relative_speeds", "source",
                 "chosen", "schedule", "wisdom_key", "swap_call")
LOSS_FIELDS = ("kind", "call", "lost", "survivors", "devices", "dropped",
               "topology", "plan_source")


def signal(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, N))
            + 1j * rng.standard_normal((N, N))).astype(np.complex64)


def straggler_fpm_arrays() -> list:
    """The reference straggler script's FPMs: positions 0-2 slow-ish and
    peaked at 64 (they pad to 64), position 3 fast and flat (stays at 48)."""
    xs = np.array(sorted({1, N // 4, N}))
    ys = np.array(sorted({48, 64, 128}))
    peaked = np.tile([2e8, 8e8, 2e8], (len(xs), 1))
    flat = np.full((len(xs), len(ys)), 4e9)
    return ([(xs, ys, peaked.copy(), f"d{i}") for i in range(3)]
            + [(xs, ys, flat, "d3")])


def straggler_params(CostParams, library: str, kernel: str):
    """The reference script's constants: the switch-dispatch overhead beats
    the healthy makespan savings, and loses once position 0 drifts."""
    return dataclasses.replace(
        CostParams.for_backend("cpu"),
        backend_factor={library: 1.0, "stockham": 0.25, kernel: 300.0},
        dispatch_overhead_s=1e-5)


def probe_times(rp, repeat_for) -> list[float]:
    """One round of the seeded probe sequence both sides patch in: each
    position's time around 1 ms, times its repeat count."""
    rp._probe_round = getattr(rp, "_probe_round", 0) + 1
    rng = np.random.default_rng(1000 + rp._probe_round)
    base_s = 1e-3 * (1.0 + 0.05 * rng.random(rp.p))
    return [float(base_s[i] * repeat_for(i)) for i in range(rp.p)]


def events(rp, kinds: tuple[str, ...], fields: tuple[str, ...]) -> list:
    return [{f: e.get(f) for f in fields} for e in rp.events
            if e["kind"] in kinds]


def swapped(rp):
    """The first hot-swapped heterogeneous re-plan, or None."""
    for e in rp.events:
        if (e["kind"] == "replan" and e.get("swap_call") is not None
                and e.get("chosen") == "heterogeneous"):
            return e
    return None


# ------------------------------------------------------------------ port

def _port_gathered(blocks: dict) -> dict:
    """Every rank's row blocks of the current world, stacked in rank order
    (every mesh here is flat, so rank order is position order)."""
    return base._gathered({k: v.numpy() for k, v in blocks.items()})


def _port_hook(mesh) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.core import pfft_dist as D
    from repro_torch.plan import PlanConfig
    from repro_torch.runtime import (inject, largest_fft_axis, rebuild_fft_mesh,
                                     rebuild_mesh, reshard)

    me = dist.get_rank()
    blk = torch.from_numpy(signal()[me * N // RANKS:(me + 1) * N // RANKS])
    calls = {"fft": 0, "fused": 0}
    real_fft, real_fused = D._local_fft, D.fft_rows_then_transpose

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    D._local_fft = counted("fft", real_fft)
    D.fft_rows_then_transpose = counted("fused", real_fused)
    out, seen = {}, {}
    try:
        for name, cfg in (("radix4", PlanConfig(radix=4)),
                          ("fused", PlanConfig(radix=4, fused=True))):
            healthy = D.pfft2_distributed(blk, mesh, config=cfg)
            before = dict(calls)
            with inject() as inj:
                inj.slow_group(1, SLOW)
                slowed = D.pfft2_distributed(blk, mesh, config=cfg)
            seen[name] = {"equal": bool(torch.equal(slowed, healthy)),
                          "calls": {k: calls[k] - before[k] for k in calls}}
            out[f"hook/{name}"] = slowed
    finally:
        D._local_fft, D.fft_rows_then_transpose = real_fft, real_fused
    grid = rebuild_mesh(model_axis=1, device_type="cpu")
    odd = rebuild_mesh(model_axis=2 * RANKS - 1, device_type="cpu")
    fft = rebuild_fft_mesh(N, device_type="cpu")
    whole = reshard({"w": torch.arange(8.0)}, fft.mesh, {"w": None})
    rows = reshard({"m": torch.from_numpy(signal())}, fft.mesh,
                   {"m": ("fft", None)})
    seen["elastic"] = {
        "grid": (grid.used, grid.dropped, grid.mesh is not None),
        "odd": (odd.used, odd.dropped, odd.mesh is not None),
        "fft": (fft.used, fft.dropped, fft.mesh.size()),
        "largest_fft_axis": largest_fft_axis(RANKS, N),
        "replicated": whole["w"].tolist(),
        "rows_equal": bool(torch.equal(rows["m"], blk)),
    }
    return {"blocks": out, "rank": seen}


def _port_retry(mesh) -> dict:
    """The agreed retries: every rank's record, as seen on that rank."""
    import torch.distributed as dist
    import repro_torch.plan.tune as T
    from repro_torch.launch.mesh import make_pfft3_mesh

    me = dist.get_rank()
    real = {name: getattr(T, name) for name in
            ("measure_dist_configs", "measure_rfft_dist_configs",
             "measure_pfft3_configs", "_measure_local_phase")}
    runs = {name: 0 for name in real}

    def failing(name, times):
        """``name`` that fails on rank 1 alone, on its first ``times``
        calls, after the real measurement (no rank is left in a
        collective)."""
        def run(*a, **k):
            got = real[name](*a, **k)
            runs[name] += 1
            if me == 1 and runs[name] <= times:
                raise RuntimeError(f"injected failure of {name} #{runs[name]}")
            return got
        return run

    def tuned(call):
        try:
            got = call()
        except Exception as err:  # the test names what each rank raised
            return {"raised": type(err).__name__, "message": str(err)}
        pick, info = got[0], got[-1]
        return {"pick": pick.to_dict(),
                "fallback": info.get("measure_fallback"),
                "comm_sample_error": info.get("dist", {}).get("comm_sample_error"),
                "measured": [c for c, _ in info.get("measured", [])]}

    record = {}
    cases = {
        "once": ("measure_dist_configs", 1, lambda: T.tune_dist_config(
            N, mesh, mode="measure", measure_retries=2, reps=1)),
        "spent": ("measure_dist_configs", 99, lambda: T.tune_dist_config(
            N, mesh, mode="measure", measure_retries=2, reps=1)),
        "no_retries": ("measure_dist_configs", 1, lambda: T.tune_dist_config(
            N, mesh, mode="measure", reps=1)),
        "comm_sample": ("_measure_local_phase", 99, lambda: T.tune_dist_config(
            N, mesh, mode="measure", measure_retries=1, reps=1)),
        "rfft_spent": ("measure_rfft_dist_configs", 99, lambda: T.tune_rfft_dist(
            N, mesh, mode="measure", measure_retries=1, reps=1)),
        "schedule_spent": ("measure_dist_configs", 99, lambda: T.tune_dist_schedule(
            N, mesh, mode="measure", measure_retries=1, reps=1)),
        "pfft3_spent": ("measure_pfft3_configs", 99, lambda: T.tune_pfft3(
            16, make_pfft3_mesh(2, 2, device_type="cpu"), mode="measure",
            measure_retries=1, reps=1)),
    }
    for case, (name, times, call) in cases.items():
        for key in runs:
            runs[key] = 0
        setattr(T, name, failing(name, times))
        try:
            record[case] = tuned(call)
        finally:
            setattr(T, name, real[name])
        record[case]["runs"] = runs[name]
    record["estimate"] = {
        "config": T.tune_dist_config(N, mesh)[0].to_dict(),
        "rfft": T.tune_rfft_dist(N, mesh)[0].to_dict(),
        "pfft3": T.tune_pfft3(16, make_pfft3_mesh(2, 2, device_type="cpu"))[0]
        .to_dict()}
    return record


def _port_straggler(mesh) -> dict:
    import torch
    from repro_torch import convert
    from repro_torch.plan import CostParams
    from repro_torch.plan.tune import tune_dist_schedule
    from repro_torch.runtime import inject
    from repro_torch.runtime.resilient import ResilientPlan

    fpms = convert.fpms_from_arrays(straggler_fpm_arrays())
    params = straggler_params(CostParams, "torch", "cuda")
    x = torch.from_numpy(signal())
    blocks, seen = {}, {}
    with inject() as inj:
        rp = ResilientPlan(N, mesh=mesh, method="fpm-pad", fpms=fpms,
                           tune="estimate", retune_params=params, alpha=0.6,
                           drift_threshold=1.3, cooldown=2)
        seen["initial"] = (rp.plan.tuning.get("chosen"),
                           rp.schedule.describe())
        blocks["straggler/out0"] = rp.execute(x)
        inj.slow_group(0, SLOW)
        for calls in range(1, LOOP_CALLS + 1):
            rp.execute(x)
            if swapped(rp) is not None:
                break
        seen["loop_calls"] = calls
        seen["swapped"] = swapped(rp) is not None
        seen["final"] = rp.schedule.describe()
        seen["final_configs"] = len(rp.schedule.configs)
        seen["source"] = rp.plan.tuning.get("source")
        blocks["straggler/out1"] = rp.execute(x)
        degraded = rp.last_degraded_fpms
        oracle, _ = tune_dist_schedule(
            N, rp.mesh, "fft", pad_lengths=rp._pad_lengths(degraded),
            mode="estimate", pad="fpm", fpms=degraded, params=params)
        seen["oracle"] = oracle.describe()
        seen["events"] = events(rp, ("replan", "replan_noop"), REPLAN_FIELDS)
        seen["replan_s"] = [e["replan_s"] for e in rp.events
                            if e["kind"] == "replan"]
    return {"blocks": blocks, "rank": seen}


def _port_loss(mesh, tmp: str) -> dict | None:
    """The loss script; returns None on a rank that left the world (it
    writes what it saw to ``departed_<rank>.json`` first)."""
    import torch
    import torch.distributed as dist
    import repro_torch.plan.tune as T
    from repro_torch.launch.mesh import make_fft_mesh
    from repro_torch.runtime import DeviceLostError, inject
    from repro_torch.runtime.resilient import ResilientPlan

    me = dist.get_rank()
    store = os.path.join(tmp, "port_wisdom.json")
    x = torch.from_numpy(signal(1))
    rows = N // RANKS
    blocks, seen = {}, {}
    with inject() as inj:
        rp = ResilientPlan(N, mesh=mesh, method="lb", tune="measure",
                           wisdom=store)
        seen["topo4"] = rp.plan.tuning.get("topology")
        blocks["loss/first"] = rp.execute(x)
        first = _port_gathered(blocks)
        rp.register_state({"acc": x[me * rows:(me + 1) * rows].clone()},
                          {"acc": ("fft", None)})
        inj.fail_execute(rp.calls, lost=LOST)
        try:
            retried = rp.execute(x)
        except DeviceLostError as err:
            with open(os.path.join(tmp, f"departed_{me}.json"), "w") as fh:
                json.dump({"lost": list(err.lost), "mesh": rp.mesh is None}, fh)
            return None
        seen["p"] = rp.p
        seen["world"] = dist.get_world_size()
        new = dist.get_rank()
        seen["state_shape"] = tuple(rp.state["acc"].shape)
        seen["state_equal"] = bool(torch.equal(
            rp.state["acc"], x[new * N // 3:(new + 1) * N // 3]))
        # A loss that names no position: the survivors are the ranks that
        # check in (all 3), so the world stays as it is.
        inj.fail_execute(rp.calls)
        unknown = rp.execute(x)
        seen["events"] = events(rp, ("device_loss",), LOSS_FIELDS)
        seen["recover_s"] = [e["recover_s"] for e in rp.events
                             if e["kind"] == "device_loss"]
    gathered = _port_gathered({"loss/retried": retried, "loss/unknown": unknown})
    # Zero re-measurement on the reduced topology: every measure entry
    # point poisoned, a fresh plan on a fresh 3-rank mesh is served.
    def boom(*a, **k):
        raise AssertionError("re-measured a wisdom-served topology")
    T.measure_dist_configs = T._measure_local_phase = boom
    rp2 = ResilientPlan(N, mesh=make_fft_mesh(3, device_type="cpu"),
                        method="lb", tune="measure", wisdom=store)
    seen["second_source"] = rp2.plan.tuning.get("source")
    gathered.update(_port_gathered({"loss/second": rp2.execute(x)}))
    gathered.update(first)
    return {"blocks": gathered, "rank": seen}


def _port_runtime(p: int, tmp: str) -> dict | None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_fft_mesh
    from repro_torch.runtime.resilient import ResilientPlan
    from repro_torch.runtime import get_injector

    ResilientPlan._probe_group_times = (
        lambda self: probe_times(self, get_injector().repeat_for))
    mesh = make_fft_mesh(p, device_type="cpu")
    hook = _port_hook(mesh)
    retry = _port_retry(mesh)
    straggler = _port_straggler(mesh)
    blocks = _port_gathered(dict(hook["blocks"], **straggler["blocks"]))
    ranks = [None] * p
    dist.all_gather_object(ranks, {"hook": hook["rank"], "retry": retry,
                                   "straggler": straggler["rank"]})
    loss = _port_loss(mesh, tmp)
    if loss is None:
        return None
    survivors = [None] * dist.get_world_size()
    dist.all_gather_object(survivors, loss["rank"])
    blocks.update(loss["blocks"])
    return {"blocks": blocks, "ranks": ranks, "survivors": survivors}


def port_main() -> None:
    """One rank of the port's world (``base._start_port_world``'s
    environment), joined through ``init_multihost``; the first rank of the
    world at the end writes the result."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_multihost

    torch.set_num_threads(1)
    p, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    init_multihost(f"127.0.0.1:{os.environ['MASTER_PORT']}", p, rank,
                   device_type="cpu")
    result = _port_runtime(p, os.environ["DIST_TMP"])
    if result is not None and dist.get_rank() == 0:
        with open(os.environ["DIST_OUT"], "wb") as fh:
            pickle.dump(result, fh)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def agent_store_main() -> None:
    """One of 2 ranks started as torchrun's agent starts its workers: the
    environment names the agent's store (``TORCHELASTIC_USE_AGENT_STORE``),
    served by the test process on ``MASTER_PORT``.  The rank joins through
    ``make_fft_mesh`` (``init_multihost_from_env``), runs a 2-D transform
    on the mesh, rebuilds the world with the ranks swapped, and writes what
    it saw to ``DIST_OUT`` with its first rank appended."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.pfft_dist import pfft2_distributed
    from repro_torch.launch.mesh import (make_fft_mesh, rebuild_world,
                                         world_store)

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    mesh = make_fft_mesh(device_type="cpu")
    p = dist.get_world_size()
    m = signal(3)[:8, :8]
    rows = m.shape[0] // p
    out = pfft2_distributed(torch.from_numpy(m[rank * rows:(rank + 1) * rows]),
                            mesh).numpy()
    world_store().set(f"seen{rank}", "1")
    new_rank = rebuild_world([1, 0])
    total = torch.tensor([new_rank])
    dist.all_reduce(total)
    result = {"rank": rank, "world": p, "block": out, "new_rank": new_rank,
              "new_world": dist.get_world_size(), "rank_sum": int(total),
              "old_key_seen": world_store().check([f"seen{rank}"])}
    dist.destroy_process_group()
    with open(f"{os.environ['DIST_OUT']}.{rank}", "wb") as fh:
        pickle.dump(result, fh)


# ------------------------------------------------------------- reference

def _reference_hook() -> dict:
    import functools

    import jax
    import jax.numpy as jnp
    from repro.core import pfft_dist as D
    from repro.launch.mesh import make_fft_mesh
    from repro.plan import PlanConfig
    from repro.runtime import (inject, largest_fft_axis, rebuild_fft_mesh,
                               rebuild_mesh)

    mesh = make_fft_mesh(RANKS)
    m = jnp.asarray(signal())
    out = {}
    for name, cfg in (("radix4", PlanConfig(radix=4)),
                      ("fused", PlanConfig(radix=4, fused=True))):
        with inject() as inj:
            inj.slow_group(1, SLOW)
            out[f"hook/{name}"] = np.asarray(jax.jit(functools.partial(
                D.pfft2_distributed, mesh=mesh, config=cfg))(m))
    grid = rebuild_mesh(model_axis=1)
    odd = rebuild_mesh(model_axis=2 * RANKS - 1)
    fft = rebuild_fft_mesh(N)
    elastic = {"grid": (grid.used, grid.dropped),
               "odd": (odd.used, odd.dropped),
               "fft": (fft.used, fft.dropped, fft.mesh.devices.size),
               "largest_fft_axis": largest_fft_axis(RANKS, N)}
    return {"blocks": out, "elastic": elastic}


def _reference_straggler() -> dict:
    from repro.core.fpm import FPMSet, SpeedFunction
    from repro.plan.cost import CostParams
    from repro.plan.tune import tune_dist_schedule
    from repro.runtime.faults import inject
    from repro.runtime.resilient import ResilientPlan

    fpms = FPMSet([SpeedFunction(xs, ys, sp, name=nm)
                   for xs, ys, sp, nm in straggler_fpm_arrays()])
    params = straggler_params(CostParams, "xla", "pallas")
    x = signal()
    out, seen = {}, {}
    with inject() as inj:
        rp = ResilientPlan(N, method="fpm-pad", fpms=fpms, tune="estimate",
                           retune_params=params, alpha=0.6,
                           drift_threshold=1.3, cooldown=2)
        seen["initial"] = (rp.plan.tuning.get("chosen"),
                           rp.schedule.describe())
        out["straggler/out0"] = np.asarray(rp.execute(x))
        inj.slow_group(0, SLOW)
        for calls in range(1, LOOP_CALLS + 1):
            rp.execute(x)
            if swapped(rp) is not None:
                break
        seen["loop_calls"] = calls
        seen["final"] = rp.schedule.describe()
        seen["source"] = rp.plan.tuning.get("source")
        out["straggler/out1"] = np.asarray(rp.execute(x))
        degraded = rp.last_degraded_fpms
        oracle, _ = tune_dist_schedule(
            N, rp.mesh, "fft", pad_lengths=rp._pad_lengths(degraded),
            mode="estimate", pad="fpm", fpms=degraded, params=params)
        seen["oracle"] = oracle.describe()
        seen["events"] = events(rp, ("replan", "replan_noop"), REPLAN_FIELDS)
    return {"blocks": out, "seen": seen}


def _reference_loss(tmp: str) -> dict:
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import repro.plan.tune as T
    from repro.launch.mesh import make_fft_mesh
    from repro.runtime.faults import inject
    from repro.runtime.resilient import ResilientPlan

    store = os.path.join(tmp, "reference_wisdom.json")
    x = signal(1)
    out, seen = {}, {}
    with inject() as inj:
        rp = ResilientPlan(N, method="lb", tune="measure", wisdom=store)
        seen["topo4"] = rp.plan.tuning.get("topology")
        out["loss/first"] = np.asarray(rp.execute(x))
        rp.register_state({"acc": jnp.asarray(x)}, {"acc": P("fft", None)})
        inj.fail_execute(rp.calls, lost=LOST)
        out["loss/retried"] = np.asarray(rp.execute(x))
        seen["p"] = rp.p
        seen["state_axis"] = rp.state["acc"].sharding.mesh.shape["fft"]
        inj.fail_execute(rp.calls)
        out["loss/unknown"] = np.asarray(rp.execute(x))
        seen["events"] = events(rp, ("device_loss",), LOSS_FIELDS)

    def boom(*a, **k):
        raise AssertionError("re-measured a wisdom-served topology")
    T.measure_dist_configs = T._measure_local_phase = boom
    rp2 = ResilientPlan(N, method="lb", tune="measure", wisdom=store,
                        mesh=make_fft_mesh(3))
    seen["second_source"] = rp2.plan.tuning.get("source")
    out["loss/second"] = np.asarray(rp2.execute(x))
    return {"blocks": out, "seen": seen}


def _reference_runtime(p: int, tmp: str) -> dict:
    from repro.runtime import get_injector
    from repro.runtime.resilient import ResilientPlan

    ResilientPlan._probe_group_times = (
        lambda self: probe_times(self, get_injector().repeat_for))
    hook = _reference_hook()
    straggler = _reference_straggler()
    loss = _reference_loss(tmp)
    return {"blocks": dict(hook["blocks"], **straggler["blocks"],
                           **loss["blocks"]),
            "elastic": hook["elastic"], "straggler": straggler["seen"],
            "loss": loss["seen"]}


def reference_main() -> None:
    base.reference_main({"runtime": _reference_runtime})
