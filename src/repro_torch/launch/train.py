"""End-to-end training loop with checkpoint/restart and straggler
monitoring, on one device (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/run1

Runs on the CUDA device unless ``--device`` / ``device=`` says otherwise.
Fault tolerance contract:
  * SIGKILL at any point: rerun with the same --ckpt-dir resumes from the
    last complete checkpoint (atomic dirs), with the data pipeline cursor
    restored — the loss curve continues exactly.
  * Straggler drift: each step's time feeds a ``StragglerMonitor``.
The trainer on a mesh (data / model axes above 1, resharding the restored
state, ``main``'s restart over a rebuilt mesh) is ROADMAP M11d-b.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import TrainCfg
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.models.registry import get_config, get_smoke_config
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train.step import init_train_state, make_train_step

__all__ = ["run_training", "main"]


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
    ``ckpt_every`` steps and at the end.  Returns the losses of the steps
    this call ran."""
    if data_axis != 1 or model_axis != 1:
        raise NotImplementedError(
            f"a {data_axis} x {model_axis} mesh: the trainer on a mesh is "
            "ROADMAP M11d-b; this one runs on one device")
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    tcfg = TrainCfg(lr=lr, microbatches=microbatches, total_steps=steps,
                    warmup=max(1, steps // 10), grad_compress=grad_compress,
                    seed=seed)
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

    step_fn = make_train_step(cfg, tcfg)
    monitor = StragglerMonitor(n_groups=1)
    losses: list[float] = []
    for step in range(start_step, steps):
        batch_data = pipe.next()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch_data)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        monitor.record(0, dt)
        losses.append(loss)
        if step % log_every == 0:
            print(f"[train] step={step} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} dt={dt:.2f}s")
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, state,
                      extra={"step": step + 1, "pipeline": pipe.state_dict()},
                      blocking=not async_ckpt)
    if ckpt is not None:
        ckpt.wait()
        ckpt.save(steps, state, extra={"step": steps,
                                       "pipeline": pipe.state_dict()})
    return losses


def main() -> int:
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
    args = ap.parse_args()
    run_training(args.arch, smoke=args.smoke, steps=args.steps, lr=args.lr,
                 batch=args.batch, seq=args.seq,
                 microbatches=args.microbatches,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 data_axis=args.data_axis, model_axis=args.model_axis,
                 grad_compress=args.grad_compress, seed=args.seed,
                 device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
