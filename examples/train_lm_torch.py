"""End-to-end example on the PyTorch/CUDA port: train a small LM with the
whole stack — microbatched train_step, AdamW, checkpoints, restart,
straggler monitor — on one device, or on a ("data", "model") mesh of
processes.

The default model is internlm2-1.8b's SMOKE config; pass --full for the
1.9 B-parameter config (it needs a card with room for ~30 GB of state).

Run on the GPU:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 40]
or on the host:  PYTHONPATH=src python examples/train_lm_torch.py --device cpu
on a 2 x 2 mesh of gloo host ranks (one per process; the world comes from
torchrun's environment):
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/train_lm_torch.py \
        --device cpu --data-axis 2 --model-axis 2
"""

import argparse
import tempfile

from repro_torch.launch.train import run_training


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as ckpt_dir:
        losses = run_training(args.arch, smoke=not args.full, lr=args.lr,
                              steps=args.steps, batch=args.batch,
                              seq=args.seq, ckpt_dir=ckpt_dir,
                              ckpt_every=max(10, args.steps // 3),
                              microbatches=2, log_every=5,
                              data_axis=args.data_axis, model_axis=args.model_axis,
                              device=args.device)
    first, last = losses[0], sum(losses[-5:]) / len(losses[-5:])
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if last < first - 0.3 else 'no clear drop'})")


if __name__ == "__main__":
    main()
