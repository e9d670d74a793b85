"""End-to-end training loop with checkpoint/restart, straggler monitoring
and elastic restart (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/run1
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch internlm2_1_8b --smoke --data-axis 2 --model-axis 2

Runs on the CUDA device unless ``--device`` / ``device=`` says otherwise.
In a world of processes (torchrun's environment, or any process group
already joined), or with ``--data-axis`` / ``--model-axis`` above 1, it
trains on the ``("data", "model")`` mesh of ``launch.mesh.make_local_mesh``:
parameters, moments and residuals laid out as DTensors by the reference's
sharding rules (``models.sharding``), the batch split over ``"data"``.  A
single process without a group trains on plain tensors.
Fault tolerance contract:
  * SIGKILL at any point: rerun with the same --ckpt-dir resumes from the
    last complete checkpoint (atomic dirs), with the data pipeline cursor
    restored — the loss curve continues exactly.  A mesh checkpoint holds
    whole tensors by parameter name, so it restores on any layout.
  * Rank loss (``main``): a ``RuntimeError`` during training rebuilds the
    grid from the surviving ranks (a ``DeviceLostError``'s ``lost`` names
    ranks of the world) with ``runtime.elastic.rebuild_mesh``, reshards the
    last checkpoint onto it and continues; a rank outside the rebuilt grid
    leaves the world.
  * Straggler drift: each step's time (the slowest rank's) feeds a
    ``StragglerMonitor``.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.configs.base import TrainCfg
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch.mesh import make_local_mesh, max_over_axis
from repro_torch.models.registry import get_config, get_smoke_config
from repro_torch.models.sharding import (batch_pspecs, param_pspecs,
                                        sanitize_pspecs)
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import rebuild_mesh, reshard
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.optim.adamw import OptState
from repro_torch.train.step import TrainState, init_train_state, make_train_step

__all__ = ["run_training", "main"]


def _on_mesh(data_axis: int, model_axis: int) -> bool:
    return data_axis * model_axis > 1 or (dist.is_available()
                                          and dist.is_initialized())


def state_pspecs(state: TrainState, mesh) -> TrainState:
    """The sanitized reference specs of every leaf of ``state`` (moments and
    residuals as their parameters; the step counter None, whole)."""
    specs = sanitize_pspecs(param_pspecs(state.params), state.params, mesh)
    return TrainState(specs, OptState(None, specs, specs),
                      {k: specs[k] for k in state.residual})


def run_training(arch: str, *, smoke: bool = True, steps: int = 20,
                 lr: float = 3e-3,
                 batch: int = 8, seq: int = 64, ckpt_dir: str | None = None,
                 ckpt_every: int = 10, microbatches: int = 2,
                 data_axis: int = 1, model_axis: int = 1,
                 grad_compress: str = "none", seed: int = 0,
                 log_every: int = 1, async_ckpt: bool = True,
                 device: str | torch.device | None = None) -> list[float]:
    """Train ``arch`` (its SMOKE config when ``smoke``) for ``steps`` steps
    of ``batch`` x ``seq`` synthetic tokens from weights drawn from a
    generator seeded with ``seed`` on ``device``; resume from the latest
    checkpoint of ``ckpt_dir`` when there is one, checkpoint every
    ``ckpt_every`` steps and at the end.  On a mesh (module docstring)
    every rank draws the same weights and batches, and the state is
    resharded onto the ``data_axis x model_axis`` mesh, which must span the
    world.  Returns the losses of the steps this call ran."""
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    tcfg = TrainCfg(lr=lr, microbatches=microbatches, total_steps=steps,
                    warmup=max(1, steps // 10), grad_compress=grad_compress,
                    seed=seed)
    mesh = (make_local_mesh(data_axis, model_axis, device_type=device.type)
            if _on_mesh(data_axis, model_axis) else None)
    weights = torch.Generator(device=device)
    weights.manual_seed(seed)
    state = init_train_state(weights, cfg, tcfg, device=device)
    pipe = SyntheticTokenPipeline(cfg, batch, seq, seed=seed, device=device)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(ckpt.latest_step(), state)
        pipe.load_state_dict(extra["pipeline"])
        start_step = int(extra["step"])
        print(f"[train] resumed from checkpoint step {start_step}")
    if mesh is not None:
        state = reshard(state, mesh, state_pspecs(state, mesh), dtensor=True)

    step_fn = make_train_step(cfg, tcfg)
    monitor = StragglerMonitor(n_groups=max(1, data_axis))
    losses: list[float] = []
    try:
        for step in range(start_step, steps):
            batch_data = pipe.next()
            if mesh is not None:        # the rows split over "data"
                batch_data = reshard(batch_data, mesh, sanitize_pspecs(
                    batch_pspecs(batch_data), batch_data, mesh), dtensor=True)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_data)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if mesh is not None:
                dt = max_over_axis([dt], mesh, ("data", "model"))[0]
            monitor.record(0, dt)
            losses.append(loss)
            if step % log_every == 0:
                print(f"[train] step={step} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} dt={dt:.2f}s")
            if ckpt is not None and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, state,
                          extra={"step": step + 1, "pipeline": pipe.state_dict()},
                          blocking=not async_ckpt)
    except BaseException:
        if ckpt is not None:
            ckpt.wait()              # the last checkpoint complete on disk
        raise
    if ckpt is not None:
        ckpt.wait()
        ckpt.save(steps, state, extra={"step": steps,
                                       "pipeline": pipe.state_dict()})
    return losses


def main(argv: list[str] | None = None) -> int:
    """The command line (``argv``, default ``sys.argv``): ``run_training``,
    rerun after a ``RuntimeError`` (at most twice, and only with
    ``--ckpt-dir``) from the last checkpoint on the grid that
    ``rebuild_mesh`` makes of the surviving ranks."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    args = ap.parse_args(argv)

    data_axis, model_axis = args.data_axis, args.model_axis
    attempts = 0
    while True:
        try:
            run_training(args.arch, smoke=args.smoke, steps=args.steps,
                         lr=args.lr, batch=args.batch, seq=args.seq,
                         microbatches=args.microbatches,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         data_axis=data_axis, model_axis=model_axis,
                         grad_compress=args.grad_compress, seed=args.seed,
                         device=args.device)
            return 0
        except RuntimeError as e:  # device failure path: elastic restart
            attempts += 1
            if attempts > 2 or args.ckpt_dir is None:
                raise
            print(f"[train] runtime error ({e}); rebuilding mesh from "
                  f"surviving ranks and resuming from checkpoint")
            device = resolve_device(args.device)
            lost = set(getattr(e, "lost", ()))
            world = dist.get_world_size() if dist.is_initialized() else 1
            rebuilt = rebuild_mesh([r for r in range(world) if r not in lost],
                                   model_axis=model_axis,
                                   device_type=device.type, reform_world=True)
            print(f"[train] rebuilt grid uses {rebuilt.used} ranks; "
                  f"{rebuilt.dropped} survivor(s) do not fit and idle")
            if rebuilt.mesh is None:
                print("[train] this rank is outside the rebuilt grid; "
                      "leaving the world")
                return 0
            # the rebuilt grid's own shape (a smaller world fits no other)
            data_axis, model_axis = (int(n) for n in rebuilt.mesh.mesh.shape)


if __name__ == "__main__":
    raise SystemExit(main())
