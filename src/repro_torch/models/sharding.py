"""Parameter / batch / cache partition rules for the production mesh, and
their layout on a ``torch.distributed`` ``DeviceMesh`` (counterpart of
``repro.models.sharding``).

Mesh axes: ('pod', 'data', 'model') multi-pod, ('data', 'model') single-pod.

Policy (megatron-style TP + ZeRO-ish FSDP over 'data', pure DP over 'pod'):

  * up-projections  (wq/wk/wv/wu/wg, mamba in_proj, xlstm gates):
      last dim -> 'model', second-to-last -> 'data'
  * down-projections (wo/wd, out_proj):
      last dim -> 'data',  second-to-last -> 'model'
  * MoE expert banks (E, d, f): E -> 'model', f/d -> 'data'
  * embeddings (V, d): V -> 'model'
  * norms / biases / gates / small vectors: replicated

KV caches: sequence axis -> 'model', batch axis -> ('pod', 'data');  SSM
states: batch -> ('pod','data'), heads -> 'model'.  Batches: batch ->
('pod', 'data').

A spec is a tuple with the entries of the reference's ``PartitionSpec``:
``None``, an axis name, or a tuple of names.  The rules are host functions
of path names and shapes.  The port's parameters are a module's
``named_parameters()``, where the reference stacks the layers of a family on
leading axes: ``param_pspecs`` looks each name up in the reference's tree
(``models.transformer.stacked_leaf``), applies the reference's rule to the
stacked path and shape there, and drops the stacked dimensions, which the
rules always leave replicated.

On a mesh (``use_mesh``) a spec becomes DTensor placements
(``placements``); ``distribute_whole`` lays a whole tensor out by them.  The
trainer (``train.step``) stores parameters, moments and residuals so, and
computes on each rank's own rows of the batch as plain tensors, with every
parameter gathered whole for the step (``whole_parameters``): its gradient
reduce-scatters back onto the parameter's layout.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard

__all__ = ["param_pspecs", "batch_pspecs", "cache_pspecs", "sanitize_pspecs",
           "constrain_batch", "embed_dshard", "DATA_AXES", "set_seq_shard",
           "placements", "local_block", "distribute_whole", "use_mesh",
           "current_mesh",
           "whole_parameters", "data_ranks", "data_mean"]

DATA_AXES = ("pod", "data")

_UP_NAMES = ("wq", "wk", "wv", "wu", "wg", "wi", "wf", "in_proj", "w_dkv",
             "w_uk", "w_uv", "lm_head", "w")
_DOWN_NAMES = ("wo", "wd", "out_proj")


def _spec_for(names: list[str], shape: tuple[int, ...], have_pod: bool) -> tuple:
    data = "data"
    nd = len(shape)
    joined = set(names)

    def pad(spec_tail: tuple) -> tuple:
        # stacked-layer / group leading dims replicate
        return (None,) * (nd - len(spec_tail)) + spec_tail

    if "table" in joined or "embed" in joined:
        # vocabulary over 'model' (the training default; ``embed_dshard``
        # flips inference lowerings to d-sharded)
        return pad(("model", None)) if nd >= 2 else ()
    if nd >= 2 and ("moe" in joined) and names[-1] in ("wg", "wu"):
        return pad(("model", None, data))       # (E, d, f): EP + FSDP-f
    if nd >= 2 and ("moe" in joined) and names[-1] == "wd":
        return pad(("model", data, None))       # (E, f, d)
    if "router" in joined:
        return (None,) * nd
    if names[-1] == "r":                        # xlstm recurrent (H, hd, 4hd)
        return pad(("model", None, None)) if nd >= 3 else (None,) * nd
    if nd >= 2:
        # dense params: the array is named "w"/"b" under a module
        mod = names[-2] if names[-1] in ("w", "b") else names[-1]
        if names[-1] == "b":
            return (None,) * nd
        if any(mod == u or mod.startswith(u) for u in _DOWN_NAMES):
            return pad(("model", data))
        if any(mod == u or mod.startswith(u) for u in _UP_NAMES):
            return pad((data, "model"))
        if mod == "conv_w":
            return pad((None, "model"))
    return (None,) * nd


def param_pspecs(params: nn.Module, have_pod: bool = False) -> dict[str, tuple]:
    """The spec of each parameter of ``params`` (a model of
    ``models.transformer``, whose ``cfg`` places it in the reference's
    tree), by parameter name: the reference's rule at the stacked leaf,
    without the stacked dimensions."""
    from repro_torch.models.transformer import stacked_leaf

    out = {}
    for name, p in params.named_parameters():
        path, _, lead = stacked_leaf(name, params.cfg)
        spec = _spec_for(list(path), tuple(lead) + tuple(p.shape), have_pod)
        out[name] = tuple(spec[len(lead):])
    return out


def _map_with_names(fn, tree: Any, names: tuple = ()) -> Any:
    """``fn(names, leaf)`` of each leaf of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_names(fn, v, names + (str(i),))
                          for i, v in enumerate(tree))
    return fn(list(names), tree)


def batch_pspecs(batch: Any, have_pod: bool = False) -> Any:
    dax = DATA_AXES if have_pod else "data"
    return _map_with_names(lambda names, leaf: (dax,) + (None,) * (leaf.ndim - 1),
                           batch)


def _cache_spec(names: list[str], shape, have_pod: bool,
                seq_axes="model") -> tuple:
    dax = DATA_AXES if have_pod else "data"
    nd = len(shape)
    name = names[-1]
    if name in ("k", "v"):        # (L?, B, S, KV, hd): seq -> seq_axes
        return (None,) * (nd - 4) + (dax, seq_axes, None, None)
    if name in ("ckv", "krope"):  # (L?, B, S, r): seq -> seq_axes
        return (None,) * (nd - 3) + (dax, seq_axes, None)
    if name == "ssm":             # (..., B, H, P, N): heads -> model
        return (None,) * (nd - 4) + (dax, "model", None, None)
    if name == "conv":            # (..., B, w, ch)
        return (None,) * (nd - 3) + (dax, None, "model")
    # xLSTM states (C, n, h, c, m; 4 heads) and the rest: batch only
    return (dax,) + (None,) * (nd - 1)


def cache_pspecs(cache: Any, have_pod: bool = False, seq_axes="model") -> Any:
    """The spec of each tensor of a cache of ``models.transformer.init_cache``,
    in its structure."""
    return _map_with_names(
        lambda names, leaf: _cache_spec(names, tuple(leaf.shape), have_pod,
                                        seq_axes), cache)


def embed_dshard(specs: Any, params_shape: Any) -> Any:
    """Flip embedding tables to d-sharded (None, 'model'): inference
    lowerings only.  ``specs`` and ``params_shape`` are dicts by parameter
    name (or nested trees of one structure)."""
    def fix(names, pair):
        spec, leaf = pair.spec, pair.leaf
        path = [part for name in names for part in name.split(".")]
        if ("table" in path or "embed" in path) and len(leaf.shape) >= 2:
            return (None,) * (len(leaf.shape) - 1) + ("model",)
        return spec
    return _map_with_names(fix, _zip_trees(specs, params_shape))


class _Pair:
    """A spec and its leaf, a leaf of ``_zip_trees``' tree."""

    def __init__(self, spec, leaf):
        self.spec, self.leaf = spec, leaf


def _zip_trees(a: Any, b: Any) -> Any:
    """``_Pair(a leaf, b leaf)`` in ``a``'s structure; a spec (a tuple of
    axis entries) is a leaf of ``a``.  A module ``b`` is its parameters."""
    if isinstance(b, nn.Module):
        b = dict(b.named_parameters())
    if isinstance(a, dict):
        return {k: _zip_trees(v, b[k]) for k, v in a.items()}
    if isinstance(a, list) or (isinstance(a, tuple) and not _is_spec(a)):
        return type(a)(_zip_trees(v, b[i]) for i, v in enumerate(a))
    return _Pair(a, b)


def _is_spec(x: Any) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(n, str) for n in e))
        for e in x)


def _axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of anything with the
    reference mesh's ``axis_names`` and ``devices``."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def sanitize_pspecs(specs: Any, shapes: Any, mesh) -> Any:
    """Drop mesh axes from any dim they don't divide evenly (a 504-way vocab
    over a 16-way model axis, batch=1 over the data axes): the leaf falls
    back to replication on that dim.  ``shapes``: tensors (or anything with
    ``.shape``) in ``specs``' structure, or the module whose parameters the
    specs are by name."""
    axis_size = _axis_sizes(mesh)

    def fix(spec, leaf):
        dims = tuple(spec) + (None,) * (len(leaf.shape) - len(tuple(spec)))
        out = []
        for dim_size, entry in zip(leaf.shape, dims):
            if entry is None:
                out.append(None)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            axes = tuple(a for a in axes if a in axis_size)
            ext = 1
            for a in axes:
                ext *= axis_size[a]
            if ext <= 1 or dim_size % ext:
                # try a prefix of the axes that still divides
                kept = []
                ext = 1
                for a in axes:
                    if dim_size % (ext * axis_size[a]) == 0:
                        kept.append(a)
                        ext *= axis_size[a]
                axes = tuple(kept)
            if not axes:
                out.append(None)
            elif len(axes) == 1:
                out.append(axes[0])
            else:
                out.append(axes)
        return tuple(out)

    return _map_with_names(lambda names, pair: fix(pair.spec, pair.leaf),
                           _zip_trees(specs, shapes))


# ---------------------------------------------------------------- on a mesh

_MESH: list[DeviceMesh] = []


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """The mesh ``constrain_batch`` and the model's batch-wide reductions
    see while the block runs (the reference's ``with mesh:``)."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def current_mesh() -> DeviceMesh | None:
    return _MESH[-1] if _MESH else None


def placements(spec: Sequence, mesh: DeviceMesh) -> tuple[Placement, ...]:
    """The DTensor placements of a sanitized ``spec`` on ``mesh``: for each
    mesh dimension, ``Shard(d)`` when the spec puts that axis on tensor
    dimension ``d``, else ``Replicate()``.  A dimension on two axes shards
    over both, in mesh order (the reference's major-to-minor order)."""
    names = tuple(mesh.mesh_dim_names)
    out: list[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(tuple(spec)):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        dims = [names.index(a) for a in axes if a in names]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axes} of dimension {d} are "
                             f"not in the mesh's order {names}")
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


def local_block(t: torch.Tensor, mesh: DeviceMesh,
                 places: Sequence[Placement]) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``places`` (each
    sharded dimension divides evenly: a sanitized spec)."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(places):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if t.shape[pl.dim] % n:
                raise ValueError(f"dimension {pl.dim} of {tuple(t.shape)} does "
                                 f"not split over {n} ranks")
            t = t.chunk(n, dim=pl.dim)[coord[i]]
    return t


def distribute_whole(t: torch.Tensor, mesh: DeviceMesh,
                     places: Sequence[Placement]) -> DTensor:
    """The whole tensor ``t`` (the same on every rank) as a DTensor laid
    out by ``places``: each rank keeps its own block, with no
    communication."""
    local = local_block(t, mesh, places).contiguous()
    return DTensor.from_local(local, mesh, tuple(places), run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())


def _data_dims(mesh: DeviceMesh) -> list[int]:
    return [i for i, a in enumerate(mesh.mesh_dim_names) if a in DATA_AXES]


def data_ranks() -> int:
    """The number of ranks the batch is split over on the current mesh (1
    outside one)."""
    mesh = current_mesh()
    out = 1
    if mesh is not None:
        for i in _data_dims(mesh):
            out *= mesh.size(i)
    return out


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the data ranks of the current mesh of ``x``, a plain
    tensor each holds (not differentiated); ``x`` outside a mesh."""
    mesh = current_mesh()
    if mesh is None or data_ranks() == 1:
        return x
    x = x.detach().clone()
    for i in _data_dims(mesh):
        if mesh.size(i) > 1:
            dist.all_reduce(x, group=mesh.get_group(i))
    return x / data_ranks()


@contextlib.contextmanager
def whole_parameters(module: nn.Module) -> Iterator[nn.Module]:
    """While the block runs, each DTensor parameter of ``module`` reads as
    the whole plain tensor (all-gathered over the mesh), differentiable:
    the gradient of the whole tensor, each data rank's from its own rows
    (``Partial`` over the data axes, the same on every rank of the others),
    reduce-scatters onto the parameter's layout.  Run the forward and the
    backward inside it (a rematerialised layer reads its parameters again
    in the backward)."""
    swapped = []
    for name, p in list(module.named_parameters()):
        if not isinstance(p, DTensor):
            continue
        mesh = p.device_mesh
        data = set(_data_dims(mesh))
        whole = p.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=[Partial() if i in data else Replicate()
                             for i in range(mesh.ndim)])
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        swapped.append((owner, attr, owner._parameters[attr]))
        owner._parameters[attr] = whole
    try:
        yield module
    finally:
        for owner, attr, p in reversed(swapped):
            owner._parameters[attr] = p


# ---------------------------------------------------------- the batch axes

SEQ_SHARD = False  # sequence-parallel activations (set via set_seq_shard)


def set_seq_shard(enabled: bool) -> None:
    """Sequence parallelism for full-sequence activations: constrain
    (B, T, d) tensors to (data-axes, 'model', None) between blocks."""
    global SEQ_SHARD
    SEQ_SHARD = bool(enabled)


def constrain_batch(x):
    """Pin an activation's leading (batch) dim to the data axes (and, when
    sequence parallelism is on, the seq dim to 'model').

    A DTensor is redistributed so; a plain tensor is returned as it is (the
    port's trainer computes on each rank's own rows as plain tensors, which
    already are the data-split batch).  No-op outside a mesh context, below
    two dimensions, or when the batch dim does not divide the data axes."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor) or x.ndim < 2:
        return x
    sizes = _axis_sizes(mesh)
    dax = [a for a in DATA_AXES if sizes.get(a, 1) > 1]
    if not dax:
        return x
    ext = 1
    for a in dax:
        ext *= sizes[a]
    if x.shape[0] % ext:
        return x
    spec: list = [None] * x.ndim
    spec[0] = tuple(dax) if len(dax) > 1 else dax[0]
    if (SEQ_SHARD and x.ndim == 3 and sizes.get("model", 1) > 1
            and x.shape[1] % sizes["model"] == 0):
        spec[1] = "model"
    return x.redistribute(mesh, placements(spec, mesh))
