"""Cases of the mesh trainer's parity tests, and the two programs that run
them.

``run(tmp)`` writes the inputs (a seeded numpy parameter tree of each
arch's float32 SMOKE config, made by the test, and the batches) to ``tmp``,
then starts at once 4 processes of the port as the ranks of one gloo world
on the host (``launch.mesh.make_local_mesh(device_type="cpu")``) and one
process of the JAX package on a forced 4-device CPU.  The port's world
runs, in order:

* ``layouts``: each arch of ``ARCHS`` trained ``STEPS`` steps on the 2x2,
  4x1 and 1x4 meshes from the tree (``convert.lm_params_from_arrays``,
  resharded by ``launch.train``'s specs), the whole state gathered after;
  the 2x2 also with the int8 codec, its decisions recorded;
* ``checkpoint``: the 2x2 state saved, restored onto the 4x1 mesh (and by
  the test onto one rank);
* ``main``: ``launch.train.main`` on 2x2 unbroken, then with a
  ``RuntimeError`` raised on every rank at step ``KILL_AT`` (the same grid
  rebuilt, resumed from the checkpoint), then with rank 3 lost there (a
  ``DeviceLostError``): the grid rebuilt to 1x2, rank 2 dropped, both
  leaving the world, ranks 0 and 1 resuming.

The reference trains each arch on ``make_local_mesh(2, 2)`` with
``jax.jit(make_train_step(..., grad_shardings=))``.  Rank 0 writes the
port's results; every rank a rank that left the world writes
``left_<rank>.json``.  The module imports neither package at the top: each
program imports its own.
"""

from __future__ import annotations

import json
import os
import pickle

import _torch_dist_cases as base

ARCHS = ("internlm2_1_8b", "dbrx_132b")
LAYOUTS = ((2, 2), (4, 1), (1, 4))
RANKS = 4
STEPS = 3
BATCH, SEQ = 8, 32
TRAIN = dict(lr=1e-2, total_steps=10, warmup=2, microbatches=2)
MAIN_ARGS = ["--arch", "internlm2_1_8b", "--smoke", "--steps", "8",
             "--batch", "4", "--seq", "16", "--microbatches", "1",
             "--ckpt-every", "4", "--lr", "1e-3", "--device", "cpu"]
KILL_AT = 5          # the step whose batch fails (after the checkpoint at 4)
LOST = (3,)


def inputs_path(tmp: str) -> str:
    return os.path.join(tmp, "mesh_inputs.pkl")


# ------------------------------------------------------------------ port

def _port_state(tree, cfg, tcfg, mesh):
    """The state from the numpy tree, on ``mesh`` (None: one rank)."""
    import torch
    from repro_torch import convert
    from repro_torch.launch import train as launch
    from repro_torch.runtime.elastic import reshard
    from repro_torch.train import step as port_step

    model = convert.lm_params_from_arrays(tree, cfg, device="cpu")
    residual = ({k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in model.named_parameters()}
                if tcfg.grad_compress != "none" else {})
    state = port_step.TrainState(model, port_step.adamw_init(model), residual)
    if mesh is not None:
        state = reshard(state, mesh, launch.state_pspecs(state, mesh),
                        dtensor=True)
    return state


def _whole_state(state) -> dict:
    """params, m, v (and residual) by parameter name as numpy arrays (the
    DTensors gathered whole: collective)."""
    from torch.distributed.tensor import DTensor

    def host(t):
        t = t.detach()
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.float().numpy().copy()
    out = {"params": {k: host(p) for k, p in state.params.named_parameters()},
           "m": {k: host(t) for k, t in state.opt.m.items()},
           "v": {k: host(t) for k, t in state.opt.v.items()}}
    if state.residual:
        out["residual"] = {k: host(t) for k, t in state.residual.items()}
    assert not isinstance(state.opt.step, DTensor)
    return out


def _laid_out(state, mesh) -> bool:
    """Whether every parameter, moment and residual is a DTensor with the
    placements of its sanitized reference spec."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import sharding

    specs = sharding.sanitize_pspecs(sharding.param_pspecs(state.params),
                                     state.params, mesh)
    for name, p in state.params.named_parameters():
        want = sharding.placements(specs[name], mesh)
        for t in (p, state.opt.m[name], state.opt.v[name],
                  *([state.residual[name]] if state.residual else [])):
            if not isinstance(t, DTensor) or tuple(t.placements) != want:
                return False
    return True


def train_steps(tree, cfg, tcfg, batches, mesh) -> tuple:
    """(losses, state) of ``len(batches)`` steps from the tree."""
    import torch
    from repro_torch.train import step as port_step

    state = _port_state(tree, cfg, tcfg, mesh)
    step = port_step.make_train_step(cfg, tcfg)
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.tensor(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, state


def _recording(store: list):
    """Record every decompressed gradient of ``train.step``'s codec (whole)
    while the block runs."""
    import contextlib
    from torch.distributed.tensor import DTensor
    from repro_torch.train import step as port_step

    fn = port_step.error_feedback_update

    def recorded(g, residual, codec="int8", **kw):
        dec, new_r = fn(g, residual, codec=codec, **kw)
        whole = dec.full_tensor() if isinstance(dec, DTensor) else dec
        store.append(whole.numpy().copy())
        return dec, new_r

    @contextlib.contextmanager
    def ctx():
        port_step.error_feedback_update = recorded
        try:
            yield
        finally:
            port_step.error_feedback_update = fn
    return ctx()


def _layouts(inputs: dict, tmp: str) -> dict:
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs.base import TrainCfg
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_smoke_config
    from repro_torch.runtime import CheckpointManager

    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        tree, batches = inputs[arch]
        for d, m in LAYOUTS:
            mesh = make_local_mesh(d, m, device_type="cpu")
            losses, state = train_steps(tree, cfg, TrainCfg(**TRAIN), batches, mesh)
            out[f"{arch}/{d}x{m}"] = {"losses": losses, "state": _whole_state(state),
                                      "laid_out": _laid_out(state, mesh)}
            if (arch, d, m) == (ARCHS[0], 2, 2):
                saved = state
    cfg = dataclasses.replace(get_smoke_config(ARCHS[0]), dtype="float32")
    tree, batches = inputs[ARCHS[0]]
    mesh = make_local_mesh(2, 2, device_type="cpu")
    decisions: list = []
    with _recording(decisions):
        losses, state = train_steps(tree, cfg, TrainCfg(grad_compress="int8", **TRAIN),
                                    batches, mesh)
    out["int8/2x2"] = {"losses": losses, "state": _whole_state(state),
                       "decisions": decisions, "laid_out": _laid_out(state, mesh)}

    out["constrain"] = _constrain(mesh)

    # the 2x2 state through a checkpoint, onto the 4x1 mesh
    ckpt = CheckpointManager(os.path.join(tmp, "mesh_ckpt"))
    ckpt.save(STEPS, saved, extra={"step": STEPS})
    other = make_local_mesh(4, 1, device_type="cpu")
    like = _port_state(tree, cfg, TrainCfg(**TRAIN), other)
    restored, extra = ckpt.restore(STEPS, like)
    out["restored/4x1"] = {"state": _whole_state(restored),
                           "laid_out": _laid_out(restored, other),
                           "extra": extra, "files": sorted(os.listdir(ckpt.dir))}
    dist.barrier()
    return out


def _constrain(mesh) -> dict:
    """``constrain_batch`` of replicated DTensors on the 2x2 mesh: the
    placements it gives, and whether the whole tensor is unchanged."""
    import torch
    from torch.distributed.tensor import Replicate
    from repro_torch.models import sharding

    out = {}
    with sharding.use_mesh(mesh):
        for name, shape, seq in (("batch", (8, 4, 2), False), ("seq", (8, 4, 2), True),
                                 ("odd", (3, 4), False), ("flat", (8,), False)):
            x = torch.arange(float(torch.Size(shape).numel())).reshape(shape)
            d = sharding.distribute_whole(x, mesh, [Replicate(), Replicate()])
            sharding.set_seq_shard(seq)
            try:
                y = sharding.constrain_batch(d)
            finally:
                sharding.set_seq_shard(False)
            out[name] = {"placements": [repr(p) for p in y.placements],
                         "equal": bool(torch.equal(y.full_tensor(), x))}
    return out


class _Fail:
    """Patch ``SyntheticTokenPipeline.next`` to raise ``exc`` at step
    ``KILL_AT`` once."""

    def __init__(self, exc):
        self.exc, self.fired = exc, False

    def __enter__(self):
        from repro_torch.data.pipeline import SyntheticTokenPipeline
        nxt = self.nxt = SyntheticTokenPipeline.next

        def failing(pipe):
            if pipe.step == KILL_AT and not self.fired:
                self.fired = True
                raise self.exc
            return nxt(pipe)
        SyntheticTokenPipeline.next = failing
        return self

    def __exit__(self, *exc):
        from repro_torch.data.pipeline import SyntheticTokenPipeline
        SyntheticTokenPipeline.next = self.nxt


def _main(tmp: str) -> dict:
    """``launch.train.main`` unbroken, after a ``RuntimeError``, and after a
    rank loss: each run's losses in order (``run_training`` wrapped to
    record them), the lines it printed, and the rank's place after."""
    import contextlib
    import io
    import torch.distributed as dist
    from repro_torch.launch import train as launch
    from repro_torch.runtime.faults import DeviceLostError

    runs: dict = {}
    real = launch.run_training

    def recorded(*a, **kw):
        losses = real(*a, **kw)
        runs[current].append({"losses": losses, "data_axis": kw["data_axis"],
                              "model_axis": kw["model_axis"]})
        return losses
    launch.run_training = recorded
    out = {}
    try:
        for current, exc in (("unbroken", None),
                             ("error", RuntimeError("step failed")),
                             ("lost", DeviceLostError(LOST))):
            runs[current] = []
            args = MAIN_ARGS + ["--data-axis", "2", "--model-axis", "2",
                                "--ckpt-dir", os.path.join(tmp, f"main_{current}")]
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed), \
                    (_Fail(exc) if exc else contextlib.nullcontext()):
                rc = launch.main(args)
            out[current] = {"rc": rc, "runs": runs[current],
                            "printed": printed.getvalue(),
                            "in_world": dist.is_initialized()}
    finally:
        launch.run_training = real
    return out


def port_main() -> None:
    """One rank of the port's world (the environment of
    ``_torch_dist_cases._start_port_world``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_multihost

    torch.set_num_threads(1)
    p, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    tmp = os.environ["DIST_TMP"]
    init_multihost(f"127.0.0.1:{os.environ['MASTER_PORT']}", p, rank,
                   device_type="cpu")
    with open(inputs_path(tmp), "rb") as fh:
        inputs = pickle.load(fh)
    result = {"layouts": _layouts(inputs, tmp)}
    result["main"] = _main(tmp)
    if not dist.is_initialized():
        with open(os.path.join(tmp, f"left_{rank}.json"), "w") as fh:
            json.dump(result["main"]["lost"], fh)
        return
    if rank == 0:
        with open(os.environ["DIST_OUT"], "wb") as fh:
            pickle.dump(result, fh)
    dist.destroy_process_group()


# ------------------------------------------------------------- reference

def _reference(p: int, tmp: str) -> dict:
    import dataclasses

    import jax
    import numpy as np
    from jax.sharding import NamedSharding
    from repro.configs.base import TrainCfg
    from repro.launch.mesh import make_local_mesh
    from repro.models.registry import get_smoke_config
    from repro.models.sharding import param_pspecs, sanitize_pspecs
    from repro.optim.adamw import adamw_init
    from repro.runtime.elastic import reshard
    from repro.train.step import TrainState, make_train_step

    with open(inputs_path(tmp), "rb") as fh:
        inputs = pickle.load(fh)
    mesh = make_local_mesh(2, 2)
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        tcfg = TrainCfg(**TRAIN)
        tree, batches = inputs[arch]
        params = jax.tree.map(jax.numpy.asarray, tree)
        state = TrainState(params, adamw_init(params), {})
        sspec = sanitize_pspecs(param_pspecs(state), state, mesh)
        state = reshard(state, mesh, sspec)
        shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), sspec.params)
        step = jax.jit(make_train_step(cfg, tcfg, grad_shardings=shardings))
        losses = []
        with mesh:
            for b in batches:
                state, m = step(state, b)
                losses.append(float(m["loss"]))
        out[arch] = {"losses": losses, "params": jax.tree.map(np.asarray, state.params),
                     "m": jax.tree.map(np.asarray, state.opt.m),
                     "v": jax.tree.map(np.asarray, state.opt.v)}
    return out


def reference_main() -> None:
    base.reference_main({"mesh": _reference})


def run(tmp: str) -> tuple[dict, dict]:
    """(the port world's result, the reference's), the inputs written to
    ``tmp`` first by the caller (``inputs_path``)."""
    port, ref = base.run_job("mesh", tmp, worlds=(RANKS,), module=__name__)
    return port[RANKS], ref[RANKS]
