"""Multi-pod dry-run of the port: every (arch x shape x mesh) cell traced on
one rank of a fake production world (counterpart of
``repro.launch.dryrun``).

This is the scale proof without the cards: an in-process ``"fake"``
process group of 256 (or 512) ranks lets ``make_production_mesh`` build
the real 16x16 (single-pod) and 2x16x16 (multi-pod) ``DeviceMesh``; under
``FakeTensorMode`` every cell builds its real state at full width (no
memory allocated) laid out by the production rules, and runs its real step
once on rank 0: the train step with its optimizer, prefill, or a serve
step against the full cache.  ``StepCounter`` counts what that rank's
program does: FLOPs, bytes, each collective's bytes, the live memory it
adds; ``roofline_terms`` turns them into seconds on an H100.

The per-rank program is the port's own, not the reference's partitioned
one.  Parameters are stored as DTensors by the reference's rules, but each
rank gathers every parameter whole (``sharding.whole_parameters``) and
computes on its own rows of the batch: compute is replicated over
``"model"``.  Serving gives each rank its rows' whole cache (the reference
shards its sequence over ``"model"``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx_132b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --analysis \\
        --jobs 8
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm_125m \\
        --shape decode_32k --device cpu

Fake tensors carry the device they stand for: ``--device cuda`` (the
default) needs the card's PyTorch build, not its memory; ``--device cpu``
runs anywhere.  ``--jobs N`` traces N (cell, mesh) pairs at a time, each in
a process of its own with its output in ``<out>/logs/``.  Records go to
``<out>/<arch>__<shape>__<pod|multipod>__<tag>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCfg, TrainCfg
from repro_torch.data.specs import input_specs
from repro_torch.launch.mesh import (host_major_devices, join_world,
                                     make_local_mesh, make_production_mesh)
from repro_torch.launch.roofline import (StepCounter, active_param_count,
                                         model_flops, param_count,
                                         roofline_terms, tensor_bytes)
from repro_torch.launch.train import state_pspecs
from repro_torch.models import sharding
from repro_torch.models import transformer as model
from repro_torch.models.registry import ARCH_IDS, get_config
from repro_torch.models.sharding import (batch_pspecs, embed_dshard,
                                         param_pspecs, sanitize_pspecs)
from repro_torch.optim.adamw import adamw_update
from repro_torch.runtime.elastic import reshard
from repro_torch.train.step import (init_train_state, make_serve_step,
                                    make_train_step)

__all__ = ["cell_plan", "run_cell", "main"]

DEFAULT_OUT = "experiments/dryrun"

# the reference's perf-iteration overrides (``lower_cell``)
OPTS = ("shard_grad_accum", "ssd_remat", "ssd_chunk", "capacity_factor",
        "cache_data_shard", "no_fsdp", "seq_shard")


def cell_plan() -> list[tuple[str, str]]:
    """All runnable (arch, shape) cells with the skips from DESIGN.md §4."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            if shape.kind == "decode" and not cfg.supports_decode():
                continue  # encoder-only: no autoregressive decode
            if sname == "long_500k" and not cfg.subquadratic():
                continue  # 500k dense-KV decode needs sub-quadratic archs
            cells.append((arch, sname))
    return cells


def _axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _train_cfg_for(cfg: ArchConfig, shape: ShapeCfg, mesh: DeviceMesh) -> TrainCfg:
    # Microbatch count keeps per-microbatch global batch >= the DP extent.
    sizes = _axis_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    nmb = max(1, shape.global_batch // dp)
    nmb = min(nmb, 8)
    while shape.global_batch % nmb:
        nmb -= 1
    return TrainCfg(microbatches=nmb, remat=True)


def _drop_fsdp(specs: Any) -> Any:
    """Remove the 'data' axis from every param spec (inference serving).
    ``specs``: a spec (a tuple of axis entries) or a dict of them."""
    if isinstance(specs, dict):
        return {k: _drop_fsdp(v) for k, v in specs.items()}
    out = []
    for e in tuple(specs):
        if e == "data":
            out.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a != "data")
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(e)
    return tuple(out)


@dataclasses.dataclass
class Part:
    """One traced part of a cell: ``run()`` runs it once on this rank;
    ``args`` is what it reads that exists before it runs (this rank's
    shards of its inputs)."""
    run: Callable[[], Any]
    args: Any


@contextlib.contextmanager
def fake_world(shape: tuple[int, ...] = (16, 16), *,
               device: str | torch.device = "cuda", fake_tensors: bool = True):
    """Rank 0 of an in-process ``"fake"`` process group (collectives return
    without moving data) of ``prod(shape)`` ranks; yields the mesh of that
    shape over it (``make_production_mesh`` for 16x16 and 2x16x16,
    ``make_local_mesh`` for another 2-D shape, ``("pod", "data", "model")``
    for another 3-D one), built before ``FakeTensorMode`` is entered
    (``fake_tensors=False``, for holding a fake trace against the same step
    on real tensors, enters none); the world is torn down after.
    ``ValueError`` when a process group exists already: the dry-run never
    joins or ends a caller's world."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise ValueError("the dry-run brings up its own fake world of "
                         f"{math.prod(shape)} ranks, but a process group "
                         "exists already")
    shape = tuple(int(n) for n in shape)
    device_type = torch.device(device).type
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        if shape in ((16, 16), (2, 16, 16)):
            mesh = make_production_mesh(multi_pod=len(shape) == 3,
                                        device_type=device_type)
        elif len(shape) == 2:
            mesh = make_local_mesh(*shape, device_type=device_type)
        else:
            join_world(device_type, None)
            mesh = DeviceMesh(device_type, torch.tensor(
                host_major_devices()).reshape(shape),
                mesh_dim_names=("pod", "data", "model"))
        with (FakeTensorMode(allow_non_fake_inputs=True) if fake_tensors
              else contextlib.nullcontext()):
            yield mesh
    finally:
        dist.destroy_process_group()


def _local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The shape of this rank's block of a tensor of ``shape`` under a
    sanitized ``spec`` (each sharded dimension divides evenly)."""
    sizes = _axis_sizes(mesh)
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        for a in (() if entry is None else (entry,) if isinstance(entry, str)
                  else entry):
            n //= sizes[a]
        out.append(n)
    return tuple(out)


def _own_rows(specs: dict, mesh, have_pod: bool, device) -> dict:
    """Zeros of this rank's rows of each input of ``specs`` (meta tensors
    of the global batch), split over the data axes as the batch specs
    say."""
    bspec = sanitize_pspecs(batch_pspecs(specs, have_pod), specs, mesh)
    return {k: torch.zeros(_local_shape(tuple(t.shape), bspec[k], mesh),
                           dtype=t.dtype, device=device)
            for k, t in specs.items()}


def _apply_opts(cfg: ArchConfig, shape: ShapeCfg, opts: dict) -> ArchConfig:
    """``cfg`` under the opts that change it, exactly as the reference
    does; ``ValueError`` for an opt the port cannot act on or that does not
    apply to the cell's kind."""
    unknown = sorted(set(opts) - set(OPTS))
    if unknown:
        raise ValueError(f"unknown dry-run opts {unknown}; known: {list(OPTS)}")
    if opts.get("cache_data_shard"):
        raise ValueError("cache_data_shard: the port's decode holds each rank's "
                         "rows' whole cache (replicated over 'model'); it has "
                         "no sequence sharding to spread over 'data'")
    if opts.get("no_fsdp") and shape.kind == "train":
        raise ValueError("no_fsdp: inference-only (prefill / decode cells)")
    if opts.get("shard_grad_accum") and shape.kind != "train":
        raise ValueError("shard_grad_accum: train cells only")
    sharding.set_seq_shard(bool(opts.get("seq_shard", False)))
    if opts.get("capacity_factor") and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(opts["capacity_factor"])))
    if cfg.ssm is not None and (opts.get("ssd_remat") or opts.get("ssd_chunk")):
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm,
            remat_chunk=bool(opts.get("ssd_remat", cfg.ssm.remat_chunk)),
            chunk=int(opts.get("ssd_chunk", cfg.ssm.chunk))))
    return cfg


def lower_cell(arch: str, shape_name: str, *, mesh: DeviceMesh,
               analysis: bool = False, opts: dict | None = None,
               device: str | torch.device = "cuda",
               cfg: ArchConfig | None = None, shape: ShapeCfg | None = None,
               tcfg: TrainCfg | None = None):
    """Lay the cell's state out on ``mesh`` and build its step.  Runs in
    the mesh's world (``fake_world``, which yields the mesh), on fake
    tensors for a production-size cell; a ``"pod"`` axis makes it a
    multi-pod cell.

    Returns (parts, meta): parts is a list of (name, ``Part``, weight) whose
    weighted count sum is one production step.  ``analysis=True`` counts
    the train step as the reference does: one microbatch's gradients
    without remat (``grad_mb``, weight = microbatches; ``run_cell`` applies
    the 4/3 remat correction to its FLOPs) and the optimizer (``opt``,
    weight 1) apart; an eager step costs the same op by op unrolled or not,
    so this only saves tracing the other microbatches.

    ``opts`` (the reference's perf overrides; any other key raises):
      shard_grad_accum: bool — the accumulators laid out as the parameters
                               (``grad_shardings=``; train cells)
      ssd_remat: bool, ssd_chunk: int, capacity_factor: float — the config
                               changed as the reference changes it
      cache_data_shard: bool — raises: the port's cache is not sequence-
                               sharded
      no_fsdp: bool          — the 'data' storage dim dropped from the param
                               specs (prefill / decode cells)
      seq_shard: bool        — ``sharding.set_seq_shard`` (the port's
                               activations are plain tensors, which it
                               leaves as they are)

    Port-only keywords: ``mesh`` (in place of ``multi_pod``), ``device``
    (the device the fake tensors stand for), ``cfg``,
    ``shape`` and ``tcfg`` in place of the arch's FULL config, the named
    shape and ``_train_cfg_for``'s choice.
    """
    opts = dict(opts or {})
    shape = shape if shape is not None else SHAPES[shape_name]
    cfg = _apply_opts(cfg if cfg is not None else get_config(arch), shape, opts)
    device = torch.device(device)
    have_pod = "pod" in mesh.mesh_dim_names
    chips = mesh.size()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    specs = input_specs(cfg, shape)

    if shape.kind == "train":
        tcfg = tcfg if tcfg is not None else _train_cfg_for(cfg, shape, mesh)
        state = init_train_state(gen, cfg, tcfg, device=device)
        n_params = param_count(state.params)
        sspec = state_pspecs(state, mesh)
        state = reshard(state, mesh, sspec, dtensor=True)
        params = state.params
        if not analysis:
            batch = {k: torch.zeros(tuple(t.shape), dtype=t.dtype, device=device)
                     for k, t in specs.items()}
            batch = reshard(batch, mesh, sanitize_pspecs(
                batch_pspecs(batch, have_pod), batch, mesh), dtensor=True)
            step = make_train_step(cfg, tcfg, grad_shardings=(
                sspec.params if opts.get("shard_grad_accum") else None))
            parts = [("train_step", Part(lambda: step(state, batch),
                                         (state, batch)), 1.0)]
        else:
            nmb = tcfg.microbatches
            mb_specs = {k: torch.empty((t.shape[0] // nmb,) + tuple(t.shape[1:]),
                                       dtype=t.dtype, device="meta")
                        for k, t in specs.items()}
            mb = _own_rows(mb_specs, mesh, have_pod, device)
            plist = list(params.parameters())

            # remat=False as the reference's analysis lowering: run_cell
            # applies the 4/3 correction (fwd 2ND + bwd 4ND + remat-fwd 2ND)
            def grad_mb():
                with torch.enable_grad(), sharding.use_mesh(mesh), \
                        sharding.whole_parameters(params):
                    loss, _ = model.loss_fn(params, mb, cfg, remat=False)
                    return torch.autograd.grad(loss, plist, allow_unused=True)

            grads = {k: torch.zeros_like(m) for k, m in state.opt.m.items()}

            def opt_fn():
                return adamw_update(grads, state.opt, params, tcfg, 1e-4)

            parts = [("grad_mb", Part(grad_mb, (params, mb)), float(nmb)),
                     ("opt", Part(opt_fn, (grads, state.opt, params)), 1.0)]
    else:
        params = model.init_params(gen, cfg, device=device)
        n_params = param_count(params)
        pspec = sanitize_pspecs(param_pspecs(params, have_pod), params, mesh)
        pspec = embed_dshard(pspec, params)
        pspec = sanitize_pspecs(pspec, params, mesh)
        if opts.get("no_fsdp"):
            pspec = _drop_fsdp(pspec)
        params = reshard(params, mesh, pspec, dtensor=True)
        if shape.kind == "prefill":
            batch = _own_rows(specs, mesh, have_pod, device)
            rows = next(iter(batch.values())).shape[0]
            cache = model.init_cache(cfg, rows, shape.seq_len, device=device)

            def prefill():
                with torch.no_grad(), sharding.whole_parameters(params):
                    return model.prefill(params, batch, cfg, cache)

            parts = [("prefill", Part(prefill, (params, batch, cache)), 1.0)]
        else:  # decode
            tokens = _own_rows({"tokens": specs["tokens"]}, mesh, have_pod,
                               device)["tokens"]
            cache = model.init_cache(cfg, tokens.shape[0], shape.seq_len,
                                     device=device)
            serve = make_serve_step(cfg)
            pos = shape.seq_len - 1      # the last slot: the whole cache read

            def serve_step():
                with torch.no_grad(), sharding.whole_parameters(params):
                    return serve(params, cache, tokens, pos)

            parts = [("serve_step", Part(serve_step, (params, cache, tokens)),
                      1.0)]

    n_active = active_param_count(cfg, n_params)
    meta = {"arch": arch, "shape": shape_name, "multi_pod": have_pod,
            "chips": chips, "n_params": n_params, "n_active": n_active,
            "model_flops": model_flops(cfg, shape, n_params, n_active),
            "kind": shape.kind,
            "remat_flop_correction": (4.0 / 3.0 if analysis and
                                      shape.kind == "train" else 1.0)}
    return parts, meta


def trace_parts(parts, meta: dict) -> tuple[dict, dict, list]:
    """Run each part once under a ``StepCounter``: (the weighted
    {"flops", "bytes accessed"} of one step, the weighted collective bytes
    by kind, [(part name, {"argument_bytes", "output_bytes",
    "temp_bytes"})])."""
    cost_sum: dict[str, float] = {}
    coll_sum: dict[str, int] = {}
    mems = []
    for name, part, weight in parts:
        with StepCounter() as counter:
            out = part.run()
        cost = counter.cost()
        corr = meta.get("remat_flop_correction", 1.0) if name == "grad_mb" else 1.0
        cost_sum["flops"] = cost_sum.get("flops", 0.0) + \
            weight * corr * cost["flops"]
        cost_sum["bytes accessed"] = cost_sum.get("bytes accessed", 0.0) + \
            weight * cost["bytes accessed"]
        for k, v in counter.coll_bytes.items():
            coll_sum[k] = coll_sum.get(k, 0) + int(weight * v)
        mems.append((name, {"argument_bytes": tensor_bytes(part.args),
                            "output_bytes": tensor_bytes(out),
                            "temp_bytes": counter.peak_bytes}))
        del out
    return cost_sum, coll_sum, mems


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: str = DEFAULT_OUT, tag: str = "baseline",
             analysis: bool = False, opts: dict | None = None,
             device: str | torch.device = "cuda") -> dict:
    """Trace one cell on rank 0 of a fake world of 256 (``multi_pod``: 512)
    ranks on fake ``device`` tensors; print and write its record.  In
    ``memory``: ``argument_bytes`` is this rank's shards of the first
    part's inputs, ``output_bytes`` what it returns (the train step writes
    its state in place: the state again), ``temp_bytes`` the peak of the
    live bytes the part adds while it runs."""
    with fake_world((2, 16, 16) if multi_pod else (16, 16), device=device) as mesh:
        t0 = time.perf_counter()
        parts, meta = lower_cell(arch, shape_name, mesh=mesh, analysis=analysis,
                                 opts=opts, device=device)
        meta["opts"] = opts or {}
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
        cost_sum, coll_sum, mems = trace_parts(parts, meta)
        t_compile = time.perf_counter() - t0
        names = [n for n, _, _ in parts]
        del parts

    terms = roofline_terms(cost_sum, "", meta["chips"], meta["model_flops"],
                           coll_bytes=coll_sum)

    rec = {
        **meta, "tag": tag, "analysis": analysis,
        "parts": names,
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "memory": mems[0][1],
        "roofline": terms.to_dict(),
    }
    print(f"[dryrun] {arch} x {shape_name} mesh={'2x16x16' if multi_pod else '16x16'}"
          f" tag={tag} trace={t_compile:.1f}s dominant={terms.dominant}"
          f" useful={terms.useful_ratio:.3f}", flush=True)
    for name, m in mems:
        print(f"  memory[{name}]: {m}")
    print(f"  cost(step-weighted): flops={cost_sum.get('flops', 0):.3e}"
          f" bytes={cost_sum.get('bytes accessed', 0):.3e}")
    print(f"  collectives: {coll_sum}", flush=True)

    os.makedirs(out_dir, exist_ok=True)
    mesh_tag = "multipod" if multi_pod else "pod"
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_tag}__{tag}.json")
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=1)
    return rec


def _run_in_processes(runs: list[tuple[str, str, bool]], args, jobs: int) -> list:
    """``python -m repro_torch.launch.dryrun`` for each (arch, shape,
    multi_pod) of ``runs``, ``jobs`` at a time, with ``args``' other flags,
    each run's output in ``<out>/logs/``; returns the runs that failed."""
    logs = os.path.join(args.out, "logs")
    os.makedirs(logs, exist_ok=True)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    flags = ["--out", args.out, "--tag", args.tag, "--device", args.device]
    flags += ["--analysis"] if args.analysis else []
    for kv in args.opt:
        flags += ["--opt", kv]
    pending, running, failures = list(runs), [], []
    try:
        while pending or running:
            while pending and len(running) < jobs:
                arch, shape, mp = run = pending.pop(0)
                name = f"{arch}__{shape}__{'multipod' if mp else 'pod'}__{args.tag}"
                log = open(os.path.join(logs, name + ".log"), "w")
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                       arch, "--shape", shape, *(["--multi-pod"] if mp else []),
                       *flags]
                running.append((run, name, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT, env=env), log,
                    time.perf_counter()))
            time.sleep(0.2)
            for item in [r for r in running if r[2].poll() is not None]:
                run, name, proc, log, t0 = item
                running.remove(item)
                log.close()
                print(f"[dryrun] {name} exit {proc.returncode} "
                      f"{time.perf_counter() - t0:.1f}s", flush=True)
                if proc.returncode:
                    failures.append((*run, f"exit {proc.returncode}: logs/{name}.log"))
    finally:
        for _, _, proc, log, _ in running:
            proc.kill()
            proc.wait()
            log.close()
    return failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--analysis", action="store_true",
                    help="grad microbatch and optimizer traced apart")
    ap.add_argument("--opt", action="append", default=[],
                    help="perf override key=value (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors stand for (default cuda)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="(cell, mesh) pairs traced at a time, each in a process")
    args = ap.parse_args(argv)

    opts = {}
    for kv in args.opt:
        k, v = kv.split("=", 1)
        try:
            opts[k] = json.loads(v)
        except json.JSONDecodeError:
            opts[k] = v

    cells = cell_plan() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    runs = [(arch, shape, mp) for arch, shape in cells for mp in meshes]
    if args.jobs > 1:
        failures = _run_in_processes(runs, args, args.jobs)
    else:
        failures = []
        for arch, shape, mp in runs:
            try:
                run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                         tag=args.tag, analysis=args.analysis, opts=opts,
                         device=args.device)
            except Exception as e:  # noqa: BLE001 - report and continue
                failures.append((arch, shape, mp, repr(e)))
                traceback.print_exc()
    if failures:
        print(f"FAILED {len(failures)} cells: {failures}")
        return 1
    print("dry-run: all requested cells traced")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
