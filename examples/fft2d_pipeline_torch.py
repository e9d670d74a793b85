#!/usr/bin/env python3
"""Distributed 2-D FFT pipeline on a device mesh, in the PyTorch port: the
paper's algorithm with the transpose steps realised as all_to_all
collectives, each rank transforming its ``(N/p, N)`` block of rows.

Every variant is named by a ``PlanConfig`` (the planner's currency): the
explicit configs below show the space, and the last run lets the
estimate-mode tuner price pipeline_panels candidates (comm volume
included) and pick one — the same selection point ``plan_pfft`` uses.

Starts ``--ranks`` processes on this host as one ``torch.distributed``
world (gloo, a free localhost port, ``make_fft_mesh(device_type="cpu")``):
the kernels run their plain PyTorch versions here; on a machine with cards
the same code runs one NCCL rank per card.  Rank 0 gathers the blocks and
prints each variant's error against ``numpy.fft.fft2``.

Run:  PYTHONPATH=src python examples/fft2d_pipeline_torch.py [--n 256] [--ranks 8]
"""

from __future__ import annotations

import argparse
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.pfft_dist import make_pfft2_fn  # noqa: E402
from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402
from repro_torch.plan import PlanConfig, tune_config  # noqa: E402


def signal(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, n))
            + 1j * rng.standard_normal((n, n))).astype(np.complex64)


def rank_main(rank: int, ranks: int, port: int, n: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=ranks, rank=rank)
    mesh = make_fft_mesh(device_type="cpu")
    sig = signal(n)
    rows = n // ranks
    block = torch.from_numpy(sig[rank * rows:(rank + 1) * rows])

    # Each phase exchanges the whole matrix minus the diagonal block.
    comm_bytes = n * n * 8 * (ranks - 1) / ranks
    planned, _ = tune_config(n, mode="estimate", panels=(1, 2, 4),
                             comm_bytes=comm_bytes, device="cpu")
    configs = [
        (PlanConfig(), "plain"),
        (PlanConfig(pad="czt"), "czt-padded (exact)"),
        (PlanConfig(radix=2), "stockham local FFT"),
        (PlanConfig(pipeline_panels=4), "4-panel overlap pipeline"),
        (planned, f"estimate-planned [{planned.describe()}]"),
    ]
    want = np.fft.fft2(sig)
    for cfg, label in configs:
        out = make_pfft2_fn(mesh, n, "fft", config=cfg)(block)
        blocks = [None] * ranks
        dist.all_gather_object(blocks, out.numpy())
        if rank == 0:
            err = float(np.abs(np.concatenate(blocks) - want).max())
            print(f"distributed pfft2 [{label:40s}] max_err={err:.2e} "
                  f"shards={len(blocks)}")
    if rank == 0:
        print("collective transpose pattern:",
              "row FFT -> all_to_all -> col FFT -> all_to_all")
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--ranks", type=int, default=8)
    args = ap.parse_args()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(rank_main, args=(args.ranks, port, args.n), nprocs=args.ranks)


if __name__ == "__main__":
    main()
