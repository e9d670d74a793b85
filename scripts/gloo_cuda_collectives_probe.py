#!/usr/bin/env python3
"""Which collectives gloo serves on CUDA tensors, one at a time, on four
processes that share one card.

    python3 scripts/gloo_cuda_collectives_probe.py [out_prefix]

Each rank runs, in order: c10d ``all_reduce``, ``all_gather_into_tensor``
and ``reduce_scatter_tensor`` over the world and over one axis of a 2 x 2
``DeviceMesh``, then DTensor ``redistribute`` Shard -> Replicate, Partial
-> Shard and Partial -> Replicate (the functional collectives the mesh
trainer's parameter gathers and gradient reduce-scatters use).  Each rank
logs ``start``, then ``ok``, ``refused`` (the exception) or, under
``faulthandler``, the stack of a crash, to ``<out_prefix>.<rank>``
(default ``chiprun_out/gloo_probe``); the parent prints the four logs and
each rank's exit code.  Needs a CUDA device.
"""

from __future__ import annotations

import faulthandler
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

RANKS = 4


def worker(rank: int, port: int, out: str) -> None:
    log = open(f"{out}.{rank}", "w", buffering=1)
    faulthandler.enable(file=log)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=RANKS, rank=rank)
    torch.cuda.set_device(0)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = DeviceMesh("cuda", torch.arange(RANKS).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    x = torch.full((4, 4), float(rank), device="cuda")

    def attempt(name, fn):
        log.write(f"start {name}\n")
        try:
            fn()
            torch.cuda.synchronize()
            log.write(f"ok {name}\n")
        except Exception as e:  # a refusal is the finding; a crash kills the rank
            log.write(f"refused {name}: {type(e).__name__}: {str(e)[:300]}\n")

    def empty(rows):
        return torch.empty(rows, 4, device="cuda")

    attempt("all_reduce", lambda: dist.all_reduce(x.clone()))
    attempt("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(empty(16), x))
    attempt("reduce_scatter_tensor",
            lambda: dist.reduce_scatter_tensor(empty(1), x.clone()))
    attempt("all_gather_into_tensor over data",
            lambda: dist.all_gather_into_tensor(empty(8), x, group=mesh.get_group(0)))
    attempt("reduce_scatter_tensor over data",
            lambda: dist.reduce_scatter_tensor(empty(2), x.clone(),
                                               group=mesh.get_group(0)))
    shard = DTensor.from_local(x, mesh, [Shard(0), Shard(1)], run_check=False)
    partial = DTensor.from_local(x, mesh, [Partial(), Replicate()], run_check=False)
    attempt("DTensor redistribute Shard -> Replicate",
            lambda: shard.redistribute(mesh, [Replicate(), Replicate()]).to_local())
    attempt("DTensor redistribute Partial -> Shard",
            lambda: partial.redistribute(mesh, [Shard(0), Replicate()]).to_local())
    attempt("DTensor redistribute Partial -> Replicate",
            lambda: partial.redistribute(mesh, [Replicate(), Replicate()]).to_local())
    log.write("done\n")
    dist.destroy_process_group()


def main() -> int:
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join("chiprun_out", "gloo_probe")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r), str(port), out])
             for r in range(RANKS)]
    for proc in procs:
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    for r, proc in enumerate(procs):
        print(f"--- rank {r} exit {proc.returncode}")
        with open(f"{out}.{r}") as fh:
            print(fh.read())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        raise SystemExit(main())
