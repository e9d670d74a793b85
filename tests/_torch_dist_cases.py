"""Cases of the distributed parity tests, and the two programs that run them.

``run_job(job, tmp)`` starts, for each mesh size of ``WORLDS``, ``p``
processes of the port as the ranks of one gloo world on the host
(``device_type="cpu"``), each running ``job`` on its own row block with rank
0 gathering the blocks, and one process of the JAX package running the same
job on a forced p-device CPU; all at once, so a test module waits for the
slowest alone.  Both sides read the same seeded numpy inputs from here.  The
module imports neither package at the top: each program imports its own.
"""

from __future__ import annotations

import os
import pickle
import re
import socket
import subprocess
import sys

import numpy as np

N = 64
PAD_LEN = 80          # a smooth non-power-of-two pad, so the crop engages
WORLDS = (2, 4)       # mesh sizes; the 4-rank mesh is 2 hosts x 2 as well
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TESTS = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 300


def signal(n: int = N, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n))
            + 1j * rng.standard_normal((n, n))).astype(np.complex64)


def real_signal(n: int = N, seed: int = 8) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)


# name -> pfft2_distributed keyword arguments, with ``config`` and
# ``schedule`` spelled as data (each side builds its own objects).
COMPLEX_CASES = {
    "plain": {"config": {}},
    "radix2": {"config": {"radix": 2}},
    "radix4": {"config": {"radix": 4}},
    "fused": {"config": {"radix": 4, "fused": True}},
    "fused_auto": {"config": {"fused": True}},
    "panels2": {"config": {"pipeline_panels": 2}},
    "panels4": {"config": {"radix": 4, "pipeline_panels": 4}},
    "fused_panels2": {"config": {"radix": 4, "fused": True,
                                 "pipeline_panels": 2}},
    "crop": {"padded": "crop", "pad_len": PAD_LEN},
    "crop_panels2": {"config": {"pad": "fpm", "pipeline_panels": 2},
                     "pad_len": PAD_LEN},
    "czt": {"padded": "czt"},
    "czt_panels4": {"config": {"pad": "czt", "pipeline_panels": 4}},
    "grouped": {"schedule": "grouped"},
    "grouped_pad": {"schedule": "grouped_pad"},
    "legacy": {"use_stockham": True, "pipeline_panels": 2},
}
# The hierarchical exchange, on the 4-rank mesh of 2 hosts x 2.
HIER_CASES = {
    "hier": {"config": {"exchange": "hier"}},
    "hier_radix4": {"config": {"radix": 4, "exchange": "hier"}},
    "hier_fused": {"config": {"radix": 4, "fused": True, "exchange": "hier"}},
    "hier_panels2": {"config": {"pipeline_panels": 2, "exchange": "hier"}},
}
REAL_CASES = {
    "rfft": {"config": {"real": True}},
    "rfft_radix4": {"config": {"real": True, "radix": 4}},
    "rfft_crop": {"config": {"real": True, "pad": "fpm"}, "pad_len": PAD_LEN},
}
# Pairs that must agree element for element (same program, other layout).
EQUAL_PAIRS = [("panels2", "plain"), ("panels4", "radix4"),
               ("fused_panels2", "fused"), ("crop_panels2", "crop"),
               ("czt_panels4", "czt"), ("legacy", "radix2")]
HIER_EQUAL_PAIRS = [("hier", "plain"), ("hier_radix4", "radix4"),
                    ("hier_fused", "fused"), ("hier_panels2", "plain")]


def schedule_parts(kind: str, n: int, p: int):
    """(d, pad_lengths, config kwargs per rank) of a heterogeneous
    schedule: the first half of the ranks on the library, the rest on the
    kernel (``grouped``); the same over mixed pad lengths (``grouped_pad``:
    the kernel ranks pad to 2N, every rank runs at the uniform 2N)."""
    d = [n // p] * p
    half = p // 2
    if kind == "grouped":
        return d, None, [{}] * half + [{"radix": 4}] * (p - half)
    pads = [n] * half + [2 * n] * (p - half)
    return d, pads, [{"pad": "fpm"}] * half + [{"pad": "fpm", "radix": 4}] * (p - half)


def pad_fpm_arrays(n: int, p: int):
    """One slow, flat processor and ``p - 1`` fast ones whose speed peaks
    at 2N, so that FPM-PAD pads the fast ranks to 2N."""
    xs = np.array(sorted({1, n // 2, n}))
    ys = np.array(sorted({n, 2 * n, 4 * n}))
    fast = np.tile([1e9, 4e9, 1e9], (len(xs), 1))
    slow = np.full((len(xs), len(ys)), 2.5e8)
    return [(xs, ys, slow if i == 0 else fast, f"P{i}") for i in range(p)]


def _kwargs(spec: dict, n: int, p: int, PlanConfig, SegmentSchedule) -> dict:
    kw = dict(spec)
    if "config" in kw:
        kw["config"] = PlanConfig(**kw["config"])
    if "schedule" in kw:
        d, pads, cfgs = schedule_parts(kw["schedule"], n, p)
        kw["schedule"] = SegmentSchedule.from_parts(
            n, np.asarray(d), None if pads is None else np.asarray(pads),
            [PlanConfig(**c) for c in cfgs])
    return kw


def cheap_kernel_params(CostParams, library: str, kernel: str):
    """The host constants with the row-FFT kernel at half the library's
    cost, so the estimate picks take it where a power of two allows."""
    import dataclasses
    cpu = CostParams.for_backend("cpu")
    return dataclasses.replace(cpu, backend_factor={
        library: 1.0, "stockham": 8.0, kernel: 0.5}, fused_factor=0.4)


def mixed_pads(n: int, p: int) -> np.ndarray:
    """Rank 0 unpadded (a power of two), the others at ``PAD_LEN`` (not):
    the kernel-cheap estimate then picks a mixed, grouped schedule."""
    return np.array([n] + [PAD_LEN] * (p - 1))


def _tuned(schedule_or_config, info: dict) -> dict:
    """What the parity test compares of a tuner's answer: the pick and the
    order of the ranking."""
    return {"pick": schedule_or_config.to_dict(),
            "ranked": [c for c, *_ in info["ranked"]],
            "chosen": info.get("chosen"), "path": info.get("chosen_path"),
            "grouped": info.get("heterogeneous", {}).get("schedule")}


def psum_grads(p: int) -> list[dict]:
    """Each rank's gradients for ``compressed_psum``: leaves of several
    shapes at a scale that grows with the rank, so the ranks' own int8
    scales differ and the shared (maxed) one decides."""
    out = []
    for r in range(p):
        rng = np.random.default_rng(100 + r)
        out.append({"w": (rng.standard_normal((37, 5)) * (1 + r)).astype(np.float32),
                    "b": (rng.standard_normal(11) * 0.01 * (r + 1)).astype(np.float32),
                    "s": np.linspace(-1, 1, 128, dtype=np.float32) * (r + 1)})
    return out


# ------------------------------------------------------------------ port

def _port_psum(p: int, tmp: str) -> dict:
    import torch
    from repro_torch.optim import compressed_psum

    mine = psum_grads(p)[_rank()]
    out = compressed_psum({k: torch.from_numpy(v) for k, v in mine.items()})
    return {k: v.numpy() for k, v in out.items()}


def _port_pfft(p: int, tmp: str) -> dict:
    import torch
    from repro_torch.core import pfft_dist as D
    from repro_torch.launch.mesh import make_fft_mesh
    from repro_torch.plan import PlanConfig, SegmentSchedule

    hosts = 2 if p == 4 else None
    mesh = make_fft_mesh(p, hosts=hosts, device_type="cpu")
    rows = slice(_rank() * N // p, (_rank() + 1) * N // p)
    blk = torch.from_numpy(signal()[rows])
    xblk = torch.from_numpy(real_signal()[rows])
    out = {}
    cases = dict(COMPLEX_CASES, **(HIER_CASES if hosts else {}))
    for name, spec in cases.items():
        kw = _kwargs(spec, N, p, PlanConfig, SegmentSchedule)
        out[name] = D.pfft2_distributed(blk, mesh, "fft", **kw)
    for name, spec in REAL_CASES.items():
        kw = _kwargs(spec, N, p, PlanConfig, SegmentSchedule)
        out[name] = D.rpfft2_distributed(xblk, mesh, "fft", **kw)
        out["i" + name] = D.irpfft2_distributed(out[name], mesh, "fft")
    if hosts:
        for split in (0, 1):
            out[f"hier_all_to_all{split}"] = D.hier_all_to_all(
                blk, mesh, split_axis=split, concat_axis=1 - split)
    else:
        # No host structure: the hierarchical pick runs the flat exchange.
        out["hier_on_flat"] = D.pfft2_distributed(
            blk, mesh, "fft", config=PlanConfig(exchange="hier"))
    result = _gathered({k: v.numpy() for k, v in out.items()})
    result["errors"] = _refusals(blk, xblk, mesh, D, PlanConfig)
    return result


def _refusals(blk, xblk, mesh, D, PlanConfig) -> dict:
    """{case: the exception type name} of calls that must be refused
    before any exchange (every rank refuses alike)."""
    calls = {
        "panels_not_dividing": lambda: D.pfft2_distributed(
            blk, mesh, config=PlanConfig(pipeline_panels=3)),
        "not_a_row_block": lambda: D.pfft2_distributed(blk.T, mesh),
        "unknown_axis": lambda: D.pfft2_distributed(blk, mesh, "nope"),
        "not_a_mesh": lambda: D.pfft2_distributed(blk, object()),
        "real_fused": lambda: D.rpfft2_distributed(
            xblk, mesh, config=PlanConfig(real=True, fused=True)),
        "real_panels": lambda: D.rpfft2_distributed(
            xblk, mesh, config=PlanConfig(real=True, pipeline_panels=2)),
        "real_hier": lambda: D.rpfft2_distributed(
            xblk, mesh, config=PlanConfig(real=True, exchange="hier")),
        "real_complex_input": lambda: D.rpfft2_distributed(blk, mesh),
        "config_and_legacy": lambda: D.pfft2_distributed(
            blk, mesh, config=PlanConfig(), pipeline_panels=2),
        "pad_conflict": lambda: D.pfft2_distributed(
            blk, mesh, config=PlanConfig(pad="czt"), padded="crop"),
    }
    seen = {}
    for name, call in calls.items():
        try:
            call()
            seen[name] = None
        except Exception as err:  # the test names the type it expects
            seen[name] = type(err).__name__
    return seen


def _port_plan(p: int, tmp: str) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.core import pfft_dist as D
    from repro_torch.core.api import plan_pfft, rfft2
    from repro_torch.launch.mesh import make_fft_mesh
    from repro_torch.plan import (CostParams, PlanConfig,
                                  measure_dist_configs, tune_dist_config,
                                  tune_dist_schedule, tune_rfft_dist)
    from repro_torch.plan.pads import fpm_pad_lengths

    mesh = make_fft_mesh(p, device_type="cpu")
    rows = slice(_rank() * N // p, (_rank() + 1) * N // p)
    blk = torch.from_numpy(signal()[rows])
    xblk = torch.from_numpy(real_signal()[rows])
    fpms = convert.fpms_from_arrays(pad_fpm_arrays(N, p))
    out, picks, keys = {}, {}, {}
    plans = {
        "lb": dict(method="lb"),
        "lb_fused": dict(method="lb", config=PlanConfig(radix=4, fused=True)),
        "lb_estimate": dict(method="lb", tune="estimate"),
        "fpm_pad": dict(method="fpm-pad", fpms=fpms, tune="estimate"),
        "fpm_czt": dict(method="fpm-czt", fpms=fpms, tune="estimate"),
        "rfft_lb": dict(method="rfft-lb", dtype="float32", tune="estimate"),
        "rfft_lb_radix4": dict(method="rfft-lb", dtype="float32",
                               config=PlanConfig(radix=4)),
    }
    for name, kw in plans.items():
        plan = plan_pfft(N, mesh=mesh, **kw)
        out[name] = plan.execute(xblk if "rfft" in name else blk)
        picks[name] = plan.schedule.to_dict()
        keys[name] = plan.tuning.get("wisdom_key")
    # A batch of two signals (the second 2x the first), as a stack and as
    # host arrays: (2, N/p, N) on each rank, kept as (N/p, 2, N) rows.
    plan = plan_pfft(N, mesh=mesh, method="lb", config=PlanConfig(radix=4))
    out["lb_batch"] = plan.execute(torch.stack([blk, 2 * blk])).transpose(0, 1)
    out["lb_many"] = torch.from_numpy(np.stack(plan.execute_many(
        [blk.numpy(), 2 * blk.numpy()]))).transpose(0, 1)
    out["rfft2"] = rfft2(xblk, mesh=mesh)
    out["pfft2_fn"] = D.make_pfft2_fn(
        mesh, N, config=PlanConfig(radix=4, pipeline_panels=2))(blk)
    out["pfft2_fn_tuned"] = D.make_pfft2_fn(mesh, N, tune="estimate")(blk)
    tuned = {}
    for pad in ("none", "fpm", "czt"):
        cfg, info = tune_dist_config(N, mesh, pad=pad)
        tuned[f"config/{pad}"] = _tuned(cfg, info)
    sched, info = tune_rfft_dist(N, mesh)
    tuned["rfft"] = _tuned(sched, info)
    sched, info = tune_dist_schedule(N, mesh)
    tuned["schedule"] = _tuned(sched, info)
    pads = fpm_pad_lengths(fpms, np.full(p, N // p), N)
    sched, info = tune_dist_schedule(N, mesh, pad_lengths=pads, fpms=fpms,
                                     pad="fpm")
    tuned["schedule/fpm"] = _tuned(sched, info)
    cheap = cheap_kernel_params(CostParams, "torch", "cuda")
    cfg, info = tune_dist_config(N, mesh, params=cheap)
    tuned["config/kernel"] = _tuned(cfg, info)
    grouped, info = tune_dist_schedule(N, mesh, pad_lengths=mixed_pads(N, p),
                                       pad="fpm", params=cheap)
    tuned["schedule/kernel"] = _tuned(grouped, info)
    result = _gathered({k: v.numpy() for k, v in out.items()})
    result.update(picks=picks, keys=keys, tuned=tuned)
    if p == 2:
        # The grouped race of the measure mode, times agreed over ranks.
        raced = measure_dist_configs(
            [grouped, PlanConfig(pad="fpm")], N, mesh, pad_len=PAD_LEN,
            rounds=1)
        seen = [None] * p
        dist.all_gather_object(seen, list(raced.values()))
        result["raced"] = seen
        store = os.path.join(tmp, "wisdom.json")
        first = plan_pfft(N, mesh=mesh, method="lb", tune="measure",
                          wisdom=store)
        second = plan_pfft(N, mesh=mesh, method="lb", tune="measure",
                           wisdom=store)
        seen = [None] * p
        dist.all_gather_object(seen, {
            "first": (first.tuning["source"], first.schedule.to_dict()),
            "second": (second.tuning["source"], second.schedule.to_dict()),
            "measured": first.tuning.get("measured"),
            "time_s": first.tuning.get("time_s")})
        result["measure"] = seen
        result["measure_out"] = _gathered(
            {"second": second.execute(blk).numpy()})["second"]
        result["store"] = open(store).read()
        # A raw call plans by the same rules: served from the plan's entry
        # (nothing recorded), and a fresh store gets the plan's key.
        raw = D.pfft2_distributed(blk, mesh, tune="measure", wisdom=store)
        result["raw_served"] = open(store).read() == result["store"]
        result["raw_out"] = _gathered({"raw": raw.numpy()})["raw"]
        raw_store = os.path.join(tmp, "raw_wisdom.json")
        D.pfft2_distributed(blk, mesh, tune="measure", wisdom=raw_store)
        result["raw_store"] = open(raw_store).read()
    else:
        # Last: a host-major mesh of 2 x 2 over the same ranks.
        hier = make_fft_mesh(hosts=2, local=2, device_type="cpu")
        cfg, info = tune_dist_config(N, hier, params=cheap)
        tuned["config/hier"] = _tuned(cfg, info)
    return result


def _port_digest(p: int, tmp: str) -> dict:
    from repro_torch.launch.mesh import (hier_process_groups, make_fft_mesh,
                                         mesh_host_shape)
    from repro_torch.plan import dist_panel_space, topology_digest

    panels = dist_panel_space(N, p)
    mesh = make_fft_mesh(p, device_type="cpu")
    out = {"flat": topology_digest(mesh, "fft", panels=panels),
           "flat_axes": topology_digest(mesh, ("fft",), panels=panels),
           "flat_shape": mesh_host_shape(mesh, "fft")}
    if p == 4:
        hier = make_fft_mesh(hosts=2, local=2, device_type="cpu")
        out["hier"] = topology_digest(hier, "fft", panels=panels)
        out["hier_shape"] = mesh_host_shape(hier, "fft")
        # Meshes built later, over the same ranks and axis name, leave the
        # first one's host structure and groups as they were.
        flat = make_fft_mesh(p, device_type="cpu")
        again = make_fft_mesh(hosts=2, local=2, device_type="cpu")
        groups = hier_process_groups(hier, "fft")
        out["later_meshes"] = {
            "hier_shape": mesh_host_shape(hier, "fft"),
            "flat_shape": mesh_host_shape(flat, "fft"),
            "hier_digest": topology_digest(hier, "fft", panels=panels),
            "groups_reused": all(a is b for a, b in zip(
                groups, hier_process_groups(again, "fft"))),
        }
    named = make_fft_mesh(p, "rows", device_type="cpu")
    out["named"] = topology_digest(named, "rows")
    return out


PORT_JOBS = {"pfft": _port_pfft, "plan": _port_plan, "digest": _port_digest,
             "psum": _port_psum}


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _gathered(blocks: dict) -> dict:
    """Every rank's row blocks, stacked in rank order on every rank."""
    import torch.distributed as dist
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, blocks)
    return {k: np.concatenate([s[k] for s in seen]) for k in blocks}


def port_main(jobs: dict | None = None) -> None:
    """One rank of a port world (the environment of ``_start_port_world``),
    running its job from ``jobs`` (default ``PORT_JOBS``)."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    p, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
        world_size=p, rank=rank)
    try:
        jobs = PORT_JOBS if jobs is None else jobs
        result = jobs[os.environ["DIST_JOB"]](p, os.environ["DIST_TMP"])
        if rank == 0:
            with open(os.environ["DIST_OUT"], "wb") as fh:
                pickle.dump(result, fh)
    finally:
        dist.destroy_process_group()


def _env(extra: dict) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, TESTS] + ([os.environ["PYTHONPATH"]]
                        if os.environ.get("PYTHONPATH") else [])),
        OMP_NUM_THREADS="1", **extra)
    return env


def _start(program: str, env: dict, module: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", f"import {module} as c; c.{program}()"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _start_port_world(p: int, job: str, tmp: str, out: str,
                      module: str) -> list:
    """The ``p`` ranks of a gloo world running ``job`` (``module``'s
    ``port_main``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return [_start("port_main", _env({
        "WORLD_SIZE": str(p), "RANK": str(r), "MASTER_PORT": str(port),
        "DIST_JOB": job, "DIST_TMP": tmp, "DIST_OUT": out}), module)
        for r in range(p)]


def _start_reference(p: int, job: str, tmp: str, out: str,
                     module: str) -> list:
    """``job`` through the JAX package on a forced p-device CPU
    (``module``'s ``reference_main``)."""
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                   os.environ.get("XLA_FLAGS", ""))
    return [_start("reference_main", _env({
        "DIST_JOB": job, "DIST_TMP": tmp, "DIST_OUT": out,
        "DIST_WORLD": str(p), "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": f"{flags} --xla_force_host_platform_device_count={p}"
                     .strip()}), module)]


def run_job(job: str, tmp: str, worlds=WORLDS,
            module: str = "_torch_dist_cases") -> tuple[dict, dict]:
    """``job`` (of ``module``'s job tables) on a port world and through the
    reference, for every mesh size of ``worlds``, all started at once:
    ({p: port result}, {p: reference result}).  Raises with the failing
    processes' errors."""
    started = []
    for p in worlds:
        for side, start in (("port", _start_port_world),
                            ("reference", _start_reference)):
            out = os.path.join(tmp, f"{side}_{job}_{p}.pkl")
            started.append((side, p, out, start(p, job, tmp, out, module)))
    errors = []
    try:
        for side, p, _, procs in started:
            for r, proc in enumerate(procs):
                _, err = proc.communicate(timeout=TIMEOUT_S)
                if proc.returncode:
                    errors.append(f"{side} p={p} process {r} exited "
                                  f"{proc.returncode}:\n{err[-3000:]}")
    finally:
        for *_, procs in started:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
    if errors:
        raise RuntimeError("\n".join(errors))
    results: dict = {"port": {}, "reference": {}}
    for side, p, out, _ in started:
        with open(out, "rb") as fh:
            results[side][p] = pickle.load(fh)
    return results["port"], results["reference"]


# ------------------------------------------------------------- reference

def _reference_pfft(p: int, tmp: str) -> dict:
    import functools

    import jax
    import jax.numpy as jnp
    from repro.core import pfft_dist as D
    from repro.launch.mesh import make_fft_mesh
    from repro.plan import PlanConfig, SegmentSchedule

    hosts = 2 if p == 4 else None
    mesh = (make_fft_mesh(hosts=2, local=2) if hosts else make_fft_mesh(p))
    m, x = jnp.asarray(signal()), jnp.asarray(real_signal())
    out = {}

    def run(fn, arg, **kw):
        # jitted as make_pfft2_fn jits: one trace, not op by op.
        return jax.jit(functools.partial(fn, mesh=mesh, axis_name="fft",
                                         **kw))(arg)

    cases = dict(COMPLEX_CASES, **(HIER_CASES if hosts else {}))
    for name, spec in cases.items():
        kw = _kwargs(spec, N, p, PlanConfig, SegmentSchedule)
        out[name] = run(D.pfft2_distributed, m, **kw)
    for name, spec in REAL_CASES.items():
        kw = _kwargs(spec, N, p, PlanConfig, SegmentSchedule)
        out[name] = run(D.rpfft2_distributed, x, **kw)
        out["i" + name] = run(D.irpfft2_distributed, out[name])
    return {k: np.asarray(v) for k, v in out.items()}


def _reference_plan(p: int, tmp: str) -> dict:
    import jax.numpy as jnp
    from repro.core import FPMSet, SpeedFunction
    from repro.core import pfft_dist as D
    from repro.core.api import plan_pfft, rfft2
    from repro.launch.mesh import make_fft_mesh
    from repro.plan import (CostParams, PlanConfig, tune_dist_config,
                            tune_dist_schedule, tune_rfft_dist)
    from repro.plan.pads import fpm_pad_lengths

    mesh = make_fft_mesh(p)
    m, x = jnp.asarray(signal()), jnp.asarray(real_signal())
    fpms = FPMSet([SpeedFunction(xs, ys, sp, name=nm)
                   for xs, ys, sp, nm in pad_fpm_arrays(N, p)])
    out, picks, keys = {}, {}, {}
    plans = {
        "lb": dict(method="lb"),
        "lb_fused": dict(method="lb", config=PlanConfig(radix=4, fused=True)),
        "lb_estimate": dict(method="lb", tune="estimate"),
        "fpm_pad": dict(method="fpm-pad", fpms=fpms, tune="estimate"),
        "fpm_czt": dict(method="fpm-czt", fpms=fpms, tune="estimate"),
        "rfft_lb": dict(method="rfft-lb", dtype="float32", tune="estimate"),
        "rfft_lb_radix4": dict(method="rfft-lb", dtype="float32",
                               config=PlanConfig(radix=4)),
    }
    for name, kw in plans.items():
        plan = plan_pfft(N, mesh=mesh, **kw)
        out[name] = plan.execute(x if "rfft" in name else m)
        picks[name] = plan.schedule.to_dict()
        keys[name] = plan.tuning.get("wisdom_key")
    out["rfft2"] = rfft2(x, p=p, mesh=mesh)
    out["pfft2_fn"] = D.make_pfft2_fn(
        mesh, N, config=PlanConfig(radix=4, pipeline_panels=2))(m)
    out["pfft2_fn_tuned"] = D.make_pfft2_fn(mesh, N, tune="estimate")(m)
    tuned = {}
    for pad in ("none", "fpm", "czt"):
        cfg, info = tune_dist_config(N, mesh, pad=pad)
        tuned[f"config/{pad}"] = _tuned(cfg, info)
    sched, info = tune_rfft_dist(N, mesh)
    tuned["rfft"] = _tuned(sched, info)
    sched, info = tune_dist_schedule(N, mesh)
    tuned["schedule"] = _tuned(sched, info)
    pads = fpm_pad_lengths(fpms, np.full(p, N // p), N)
    sched, info = tune_dist_schedule(N, mesh, pad_lengths=pads, fpms=fpms,
                                     pad="fpm")
    tuned["schedule/fpm"] = _tuned(sched, info)
    cheap = cheap_kernel_params(CostParams, "xla", "pallas")
    cfg, info = tune_dist_config(N, mesh, params=cheap)
    tuned["config/kernel"] = _tuned(cfg, info)
    sched, info = tune_dist_schedule(N, mesh, pad_lengths=mixed_pads(N, p),
                                     pad="fpm", params=cheap)
    tuned["schedule/kernel"] = _tuned(sched, info)
    if p == 4:
        hier = make_fft_mesh(hosts=2, local=2)
        cfg, info = tune_dist_config(N, hier, params=cheap)
        tuned["config/hier"] = _tuned(cfg, info)
    result = {k: np.asarray(v) for k, v in out.items()}
    result.update(picks=picks, keys=keys, tuned=tuned)
    return result


def _reference_digest(p: int, tmp: str) -> dict:
    from repro.launch.mesh import make_fft_mesh, mesh_host_shape
    from repro.plan import dist_panel_space, topology_digest

    panels = dist_panel_space(N, p)
    mesh = make_fft_mesh(p)
    out = {"flat": topology_digest(mesh, "fft", panels=panels),
           "flat_axes": topology_digest(mesh, ("fft",), panels=panels),
           "flat_shape": mesh_host_shape(mesh, "fft")}
    if p == 4:
        mesh = make_fft_mesh(hosts=2, local=2)
        out["hier"] = topology_digest(mesh, "fft", panels=panels)
        out["hier_shape"] = mesh_host_shape(mesh, "fft")
    out["named"] = topology_digest(make_fft_mesh(p, "rows"), "rows")
    return out


def _reference_psum(p: int, tmp: str) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.optim.grad_compress import compressed_psum

    grads = psum_grads(p)
    stacked = {k: jnp.stack([g[k] for g in grads]) for k in grads[0]}
    mesh = Mesh(np.array(jax.devices()[:p]), ("pods",))
    f = shard_map(lambda x: compressed_psum(x, "pods"), mesh=mesh,
                  in_specs=P("pods"), out_specs=P("pods"))
    return {k: np.asarray(v[0]) for k, v in jax.jit(f)(stacked).items()}


REFERENCE_JOBS = {"pfft": _reference_pfft, "plan": _reference_plan,
                  "digest": _reference_digest, "psum": _reference_psum}


def reference_main(jobs: dict | None = None) -> None:
    """The reference's side of one mesh size (the environment of
    ``_start_reference``), running its job from ``jobs`` (default
    ``REFERENCE_JOBS``)."""
    p = int(os.environ["DIST_WORLD"])
    jobs = REFERENCE_JOBS if jobs is None else jobs
    result = jobs[os.environ["DIST_JOB"]](p, os.environ["DIST_TMP"])
    with open(os.environ["DIST_OUT"], "wb") as fh:
        pickle.dump(result, fh)
