#!/usr/bin/env python3
"""The port's 3-D mesh pipelines on a gloo world of CPU ranks.

    PYTHONPATH=src python examples/pfft3_mesh_torch.py [--n 32] [--ranks 4]

Starts ``--ranks`` processes on this host as one ``torch.distributed`` world
(gloo, a free localhost port).  Every rank builds the same pencil mesh
(``make_pfft3_mesh(device_type="cpu")``, the most-square ``r x c``), plans
``plan_pfft3(n, mesh=, tune="estimate")``, transforms its ``(N/r, N/c, N)``
pencil of one seeded cube in the plan's orientation, and rank 0 gathers the
``(N, N/r, N/c)`` blocks by mesh coordinates and prints the error against
``numpy.fft.fftn``; then the same through the slab (``pfft3_slab`` on a 1-D
``make_fft_mesh``).  The kernels run their plain PyTorch versions here.
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

from repro_torch.core import pfft3_slab, plan_pfft3  # noqa: E402
from repro_torch.launch import make_fft_mesh, make_pfft3_mesh  # noqa: E402


def cube(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, n, n))
            + 1j * rng.standard_normal((n, n, n))).astype(np.complex64)


def rank_main(rank: int, ranks: int, port: int, n: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=ranks, rank=rank)
    x = cube(n)
    mesh = make_pfft3_mesh(device_type="cpu")
    plan = plan_pfft3(n, mesh=mesh, tune="estimate")
    (ax_r, ax_c), (rows, cols, _) = plan.axis_names, plan.block_shape
    i, j = mesh.get_local_rank(ax_r), mesh.get_local_rank(ax_c)
    block = x[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols]
    out = plan.execute(torch.from_numpy(block))
    seen = [None] * ranks
    dist.all_gather_object(seen, ((i, j), out.numpy()))

    slab = make_fft_mesh(device_type="cpu")
    q = slab.get_local_rank("fft")
    slabs = [None] * ranks
    dist.all_gather_object(slabs, (q, pfft3_slab(
        torch.from_numpy(x[q * n // ranks:(q + 1) * n // ranks]), slab).numpy()))
    if rank == 0:
        want = np.fft.fftn(x)
        full = np.zeros_like(want)
        for (bi, bj), b in seen:
            full[:, bi * rows:(bi + 1) * rows, bj * cols:(bj + 1) * cols] = b
        print(f"pencil {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
              f"orientation {plan.axis_names} pick {plan.config.describe()} "
              f"topology {plan.tuning['topology']}: max |err| "
              f"{np.abs(full - want).max():.3e}")
        full = np.concatenate([b for _, b in sorted(slabs, key=lambda t: t[0])])
        print(f"slab over {ranks} ranks: max |err| {np.abs(full - want).max():.3e}"
              f" (tolerance {2e-4 * n ** 1.5:.3e})")
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(rank_main, args=(args.ranks, port, args.n), nprocs=args.ranks)


if __name__ == "__main__":
    main()
