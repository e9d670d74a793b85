"""Elastic scaling: rebuild the world from the surviving ranks and re-shard
live state onto it.

Counterpart of ``repro.runtime.elastic``.  Under ``torch.distributed`` a
lost device is a lost rank, and the port's meshes span the whole world, so
a rebuild is a new world: every rank of the old one takes its groups down
and the ranks that fit the rebuilt grid form the new default group on the
same store (``launch.mesh.rebuild_world``), with new ranks in host-major
order.  A rank that was lost, or that survived but does not fit, leaves
the world: its ``RebuildResult.mesh`` is None.

Rebuilds return a ``RebuildResult``: a grid that does not fill (7
survivors on a model_axis-4 grid, 3 survivors for an N no 3 divides)
leaves ranks idle, and the result carries the dropped count so the caller
can log capacity it is leaving on the floor.

State: ``reshard`` cuts this rank's share of whole tensors for a mesh: a
plain row block for the FFT runtime, a DTensor for any other layout (a
trainer's state on its ``("data", "model")`` mesh).  The
runtime gathers the whole tensors over the old world before it goes away
(``gather_whole``); an emulated loss leaves the old world intact for that.
A rank that truly died takes its block with it, and only a checkpoint
(``runtime.checkpoint``) brings it back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement

from repro_torch.launch.mesh import (axis_size, host_major_devices,
                                     join_world, make_fft_mesh,
                                     make_local_mesh, mesh_device,
                                     rebuild_world)
from repro_torch.models.sharding import distribute_whole, placements

__all__ = ["RebuildResult", "rebuild_mesh", "rebuild_fft_mesh", "reshard",
           "largest_grid", "largest_fft_axis"]


@dataclasses.dataclass(frozen=True)
class RebuildResult:
    """Outcome of a mesh rebuild.

    ``used`` ranks are in the mesh; ``dropped`` survivors did not fit the
    grid (non-filling (data, model) product, or an FFT axis capped by N's
    divisors) and sit idle — surfaced, never silent.  ``mesh`` is None on a
    rank that is not in it.
    """

    mesh: DeviceMesh | None
    used: int
    dropped: int


def largest_grid(n_devices: int, model_axis: int) -> tuple[int, int]:
    """Largest (data, model) grid using <= n_devices, preserving the model
    axis if possible (TP degree is fixed by the model's sharding), else
    halving it until it fits (a non-power-of-two axis bottoms out at 1)."""
    model_axis = max(int(model_axis), 1)
    while model_axis > 1 and n_devices < model_axis:
        model_axis //= 2
    model_axis = max(model_axis, 1)
    data = max(1, n_devices // model_axis)
    return data, model_axis


def rebuild_mesh(ranks: Sequence[int] | None = None, *, model_axis: int = 16,
                 device_type: str | None = None,
                 backend: str | None = None,
                 reform_world: bool = False) -> RebuildResult:
    """The (data, model) grid of a trainer as a 2-D ``DeviceMesh`` over
    ``ranks`` of the current world (default: all of them, host-major);
    ranks past the grid are dropped.  Every rank of the world calls it
    (it creates process groups).

    ``reform_world=True`` (the trainer's restart): when the grid is not the
    whole world, the world is first rebuilt over the grid's ranks
    (``launch.mesh.rebuild_world``) and every other rank leaves it; the
    mesh is then ``launch.mesh.make_local_mesh`` of the new world."""
    device_type, world = join_world(device_type, backend)
    ranks = host_major_devices(ranks)
    data, model = largest_grid(len(ranks), model_axis)
    used = data * model
    dropped = len(ranks) - used
    if reform_world:
        members = ranks[:used]
        if members != list(range(world)) and rebuild_world(members) is None:
            return RebuildResult(mesh=None, used=used, dropped=dropped)
        return RebuildResult(mesh=make_local_mesh(data, model,
                                                  device_type=device_type,
                                                  backend=dist.get_backend()),
                             used=used, dropped=dropped)
    grid = torch.tensor(ranks[:used]).reshape(data, model)
    mesh = DeviceMesh(device_type, grid,
                      mesh_dim_names=("data", "model"))
    return RebuildResult(mesh=mesh if dist.get_rank() in ranks[:used] else None,
                         used=used, dropped=dropped)


def largest_fft_axis(n_devices: int, n: int) -> int:
    """Largest p <= n_devices with n % p == 0 — the distributed PFFT
    pipeline requires the row count to divide evenly over the mesh axis,
    so after a device loss the rebuilt axis is N's largest divisor that
    the survivors can still staff."""
    for p in range(min(int(n_devices), int(n)), 1, -1):
        if n % p == 0:
            return p
    return 1


def rebuild_fft_mesh(n: int, survivors: Sequence[int] | None = None, *,
                     axis_name: str = "fft", hosts: int | None = None,
                     device_type: str | None = None) -> RebuildResult:
    """Rebuild the 1-D PFFT mesh from the surviving ranks.

    ``survivors`` are ranks of the current world (default: all of them).
    The FFT axis is capped by N's divisibility — 3 survivors for N=8192
    can only staff a 2-wide axis, and the third is *dropped*.  The axis is
    host-major: survivors are ordered by (host, rank) before it is cut, so
    whole surviving hosts stay contiguous.  ``hosts`` carries the caller's
    surviving-host count on emulated-host rigs: when it divides the
    rebuilt axis it is registered on the new mesh (``make_fft_mesh(
    hosts=)``); when it does not — a partial host loss — the axis is flat,
    exactly the topology the re-tune should price.  Either way the reduced
    topology gets a distinct digest.

    Collective over the whole current world, lost ranks included (an
    emulated loss leaves them running): when the members differ from the
    world, the world is rebuilt over them (``launch.mesh.rebuild_world``)
    and every other rank leaves it.  ``device_type`` is the mesh's, as
    ``make_fft_mesh`` takes it; the backend stays the world's.
    """
    world = dist.get_world_size()
    backend = dist.get_backend()
    survivors = host_major_devices(range(world) if survivors is None
                                   else survivors)
    p = largest_fft_axis(len(survivors), n)
    members = survivors[:p]
    dropped = len(survivors) - p
    if members != list(range(world)) and rebuild_world(members) is None:
        return RebuildResult(mesh=None, used=p, dropped=dropped)
    eff = int(hosts) if hosts else 1
    if eff < 1 or p % eff:
        eff = 1
    mesh = make_fft_mesh(axis_name=axis_name, hosts=eff,
                         device_type=device_type, backend=backend)
    return RebuildResult(mesh=mesh, used=p, dropped=dropped)


def _row_axis(spec) -> str | None:
    """The mesh axis a spec splits rows over: its first entry (a string is
    a one-entry spec), or None for a replicated leaf.  Only rows split."""
    if spec is None or isinstance(spec, str):
        return spec
    spec = tuple(spec)
    if any(s is not None for s in spec[1:]):
        raise ValueError(f"only the leading dimension can be split, got {spec}")
    return spec[0] if spec else None


def _splits_rows_only(spec) -> bool:
    """Whether a spec is a plain row block's (``_row_axis``): None, an axis
    name, or one axis on the leading dimension alone."""
    if spec is None or isinstance(spec, str):
        return True
    spec = tuple(spec)
    return (all(s is None for s in spec[1:])
            and not (spec and isinstance(spec[0], tuple)))


def _is_placements(spec) -> bool:
    return (isinstance(spec, (tuple, list)) and len(spec) > 0
            and all(isinstance(p, Placement) for p in spec))


def _as_dtensor(x: torch.Tensor, mesh: DeviceMesh, spec) -> DTensor:
    """Whole ``x`` laid out on ``mesh`` by a spec or by placements."""
    places = tuple(spec) if _is_placements(spec) else placements(spec or (), mesh)
    return distribute_whole(x, mesh, places)


def _walk(tree: Any, specs: Any, leaf, module) -> Any:
    """``leaf(x, spec)`` of each leaf of nested dicts / lists / tuples (named
    tuples kept), ``module(m, specs)`` of each module (its specs a dict by
    parameter name), with the specs at the same place."""
    if isinstance(tree, nn.Module):
        return module(tree, specs)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, _walk(v, specs[k], leaf, module))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        out = [_walk(v, specs[i], leaf, module) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return leaf(tree, specs)


def reshard(tree: Any, mesh: DeviceMesh, pspecs: Any, *,
            dtensor: bool = False) -> Any:
    """This rank's share of whole tensors on ``mesh``.

    A leaf whose spec splits its leading dimension over one axis (``("fft",
    None)``, the reference's ``P("fft", None)``) becomes this rank's
    contiguous block of rows; a leaf whose spec is None is replicated,
    whole: the FFT runtime's plain blocks.  A leaf whose spec splits a later
    dimension, or one dimension over two axes (``(None, "model")``,
    ``(("data", "model"), None)``), or that is given as DTensor placements,
    becomes a ``DTensor`` (``models.sharding.distribute_whole``); so does
    every leaf with a spec under ``dtensor=True`` (a trainer's state, whose
    replicated moments live on the mesh too; a leaf whose spec is None, a
    step counter, stays whole and plain).  A module's parameters always become
    DTensor parameters, written into the module, its specs a dict by
    parameter name.  Leaves (tensors or host arrays) land on this rank's
    device."""
    device = mesh_device(mesh)

    def put(x, spec):
        x = torch.as_tensor(x)
        if (dtensor and spec is not None) or _is_placements(spec) \
                or not _splits_rows_only(spec):
            return _as_dtensor(x.detach().to(device), mesh, spec)
        axis = _row_axis(spec)
        if axis is not None:
            p = axis_size(mesh, axis)
            if x.shape[0] % p:
                raise ValueError(f"{x.shape[0]} rows do not split over "
                                 f"{p} ranks of axis {axis!r}")
            rows = x.shape[0] // p
            pos = mesh.get_local_rank(axis)
            x = x[pos * rows:(pos + 1) * rows]
        return x.to(device).contiguous()

    def module(node, specs):
        for name, p in list(node.named_parameters()):
            owner_name, _, attr = name.rpartition(".")
            owner = node.get_submodule(owner_name)
            owner._parameters[attr] = nn.Parameter(
                _as_dtensor(p.detach().to(device), mesh, specs[name]),
                requires_grad=p.requires_grad)
        return node

    return _walk(tree, pspecs, put, module)


def gather_whole(tree: Any, mesh: DeviceMesh, pspecs: Any) -> Any:
    """The inverse of ``reshard``: a DTensor leaf gathered whole
    (``full_tensor``), every rank's blocks of each row-split leaf gathered,
    in mesh order, into the whole tensor on every rank of the axis;
    replicated leaves as they are; a module as the dict of its parameters
    by name.  Collective over the axes the specs name."""
    def whole(x, spec):
        if isinstance(x, DTensor):
            return x.full_tensor()
        axis = _row_axis(spec)
        if axis is None:
            return x
        group = mesh.get_group(axis)
        send = torch.view_as_real(x) if x.is_complex() else x
        parts = [None] * axis_size(mesh, axis)
        dist.all_gather_object(parts, (mesh.get_local_rank(axis), send.cpu()),
                               group=group)
        blocks = [b for _, b in sorted(parts, key=lambda pb: pb[0])]
        out = torch.cat(blocks).to(x.device)
        return torch.view_as_complex(out) if x.is_complex() else out

    def module(node, specs):
        return {name: whole(p.detach(), specs[name])
                for name, p in node.named_parameters()}

    return _walk(tree, pspecs, whole, module)
