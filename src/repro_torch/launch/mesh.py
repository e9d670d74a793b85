"""Device meshes and multi-process launch for the distributed pipeline.

Counterpart of ``repro.launch.mesh`` for the 2-D pipeline.  The port runs
SPMD over ``torch.distributed``: one process per device, each holding its
own block of the signal, so a mesh is a ``DeviceMesh`` over the ranks of the
default process group and every rank takes part in every collective.

* ``init_multihost`` / ``init_multihost_from_env`` bring a process into the
  process group (torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
  ``MASTER_PORT`` contract); ``make_fft_mesh`` does so itself, for a world
  of one process, when no group exists yet.
* ``make_fft_mesh(hosts=, local=)`` builds the FFT axis *host-major*: rank
  ``H*local + L`` is local device ``L`` of host ``H``, so the hierarchical
  exchange's intra-host groups are contiguous runs along the axis.  The
  host structure is kept on the mesh object itself, together with this
  rank's two process groups of the hierarchical exchange, so a plan keeps
  the hierarchy its mesh was built with whatever meshes come after.  The
  groups are built while the first mesh of a host partition is built, on
  every rank in the same order (creating a process group is collective),
  and every later mesh of that partition reuses them.
* ``make_local_mesh(data, model)`` builds the trainer's 2-D ``("data",
  "model")`` mesh over the world, row by row in host-major order;
  ``make_production_mesh`` the 16 x 16 (or 2 x 16 x 16, with ``"pod"``)
  mesh of 256 (512) ranks the dry-run traces a rank of.
* ``make_pfft3_mesh(r, c, hosts=)`` builds the 2-D ``r x c`` mesh of the
  pencil pipeline over the same host-major ranks, the hosts riding the
  ``r`` axis: each host owns ``r/hosts`` contiguous mesh rows, so every
  ``c``-axis communicator stays inside one host.
* ``mesh_host_shape`` reads ``(hosts, local)`` back along the axis asked
  for: the structure declared by ``hosts=``/``local=`` (emulated, as in the
  reference's single-process tests) or, without them, the launcher's
  processes per host (``LOCAL_WORLD_SIZE``).
* ``rebuild_world`` re-forms the default group over surviving ranks under a
  fresh key prefix of the store the world joined on (torch's own
  rendezvous, torchrun's agent store included), for the elastic rebuild of
  ``repro_torch.runtime.elastic``; ``world_store`` is the current world's
  key-value namespace.  A process keeps the card it was given when it
  first joined a world.

The device type decides the backend: ``"cuda"`` (the default, which raises
without a card) runs NCCL, ``"cpu"`` runs gloo.  ``device_type="cuda",
backend="gloo"`` (several ranks sharing one card, the exchange through the
host) is taken only when asked for.

The collectives every rank must agree on while planning (the first rank's
wisdom lookup, the slowest rank's measured times) are the helpers at the
end: under SPMD each rank plans for itself, and ranks that chose
differently would meet at different collectives.  They agree over one
axis's group, or over the whole mesh when given a sequence of axis names
(a pencil plan decides for all ``r*c`` ranks).  ``agree_on_failure`` tells
every rank whether any rank's local step failed, so that all retry or give
way together.
"""

from __future__ import annotations

import dataclasses
import math
import os
import socket
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_production_mesh", "make_local_mesh", "make_fft_mesh",
           "make_pfft3_mesh",
           "mesh_host_shape", "register_emulated_hosts", "host_major_devices",
           "init_multihost",
           "init_multihost_from_env", "axis_size", "mesh_device",
           "rebuild_world", "world_store", "join_world"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

# This process's side of its world: the store the first default group
# joined on (kept once a rebuild has taken that group down), the number of
# rebuilds since (each re-forms the group under its own key prefix), and
# the card the process was given first.
_WORLD: dict = {"store": None, "generation": 0, "card": None}


@dataclasses.dataclass(frozen=True)
class _HostLayout:
    """A registered host structure: the host count and this rank's two
    process groups of the hierarchical exchange (``None`` when the
    hierarchy is degenerate)."""
    hosts: int
    intra: object = None
    inter: object = None


# The attribute of a DeviceMesh that holds its {axis_name: _HostLayout}.
_LAYOUT_ATTR = "_fft_host_layouts"

# (default process group, the axis's lines of ranks, hosts) -> this rank's
# (intra, inter) groups.  Filled on every rank alike (the builders are
# called alike), so either every rank creates a partition's groups or none.
_HIER_GROUPS: dict[tuple, tuple] = {}


def _backend_for(device_type: str | None, backend: str | None) -> tuple[str, str]:
    """(device type, backend): ``None`` is ``"cuda"``, which needs a card;
    each device type's backend unless one is named."""
    device_type = "cuda" if device_type is None else device_type
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_fft_mesh: device_type 'cuda' (the default) needs a CUDA "
            "device and none is available; pass device_type='cpu' for gloo "
            "ranks on the host")
    backend = _BACKENDS[device_type] if backend is None else backend
    if device_type == "cpu" and backend != "gloo":
        raise ValueError(f"a cpu mesh runs gloo, got backend={backend!r}")
    return device_type, backend


def _set_cuda_device(rank: int) -> None:
    """This process's card: the launcher's ``LOCAL_RANK``, else the rank
    modulo the cards visible (several ranks may share one); chosen when the
    process first joins a world and kept when a rebuilt world renumbers
    its rank."""
    if _WORLD["card"] is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        _WORLD["card"] = local % torch.cuda.device_count()
    torch.cuda.set_device(_WORLD["card"])


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, *, device_type: str | None = None,
                   backend: str | None = None) -> None:
    """Join the default process group at ``coordinator_address``
    (``host:port``, served by process 0); a second call is a no-op.

    ``device_type`` / ``backend`` as ``make_fft_mesh`` takes them; a CUDA
    process also selects its card here, before any communicator exists.
    """
    if dist.is_initialized():
        return
    device_type, backend = _backend_for(device_type, backend)
    if device_type == "cuda":
        _set_cuda_device(int(process_id))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    _WORLD.update(store=None, generation=0)


def _base_store():
    """The store the first default group of this world joined on."""
    if _WORLD["store"] is None:
        _WORLD["store"] = dist.distributed_c10d._get_default_store()
    return _WORLD["store"]


def world_store():
    """The key-value namespace of this process's current world: a prefix of
    the store the world joined on, one per rebuild, so that keys set in one
    world are never read in a rebuilt one."""
    return dist.PrefixStore(f"repro-kv{_WORLD['generation']}", _base_store())


def rebuild_world(members: Sequence[int]) -> int | None:
    """Re-form the default process group over ``members``, ranks of the
    current world listed in their new rank order; returns this rank's new
    rank, or None when it is not a member (it has left the world).

    Collective over the whole current world: every rank arrives at a
    barrier, then takes the old groups down (every mesh and process group
    made in it is gone), and the members form the new group on the same
    store under a fresh key prefix.  The store's server lives in
    torchrun's agent, else in the process that was rank 0 when the world
    was first joined, which must then outlive the rebuilt world.
    """
    store = _base_store()
    backend = dist.get_backend()
    me = dist.get_rank()
    members = [int(r) for r in members]
    dist.barrier()
    dist.destroy_process_group()
    _HIER_GROUPS.clear()
    _WORLD["generation"] += 1
    if me not in members:
        return None
    dist.init_process_group(
        backend, store=dist.PrefixStore(f"repro-world{_WORLD['generation']}", store),
        rank=members.index(me), world_size=len(members))
    return members.index(me)


def init_multihost_from_env(*, device_type: str | None = None,
                            backend: str | None = None) -> bool:
    """``init_multihost`` from torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``; returns False when they are unset."""
    if "MASTER_ADDR" not in os.environ or "RANK" not in os.environ:
        return False
    init_multihost(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                   int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                   device_type=device_type, backend=backend)
    return True


def _init_single_process(device_type: str, backend: str) -> None:
    """A world of this process alone, on a free port of this host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_multihost(f"127.0.0.1:{port}", 1, 0, device_type=device_type,
                   backend=backend)


def host_major_devices(ranks=None) -> list[int]:
    """The ranks (default: the whole world) sorted host-major: by (host,
    rank), the host of a rank being ``rank // LOCAL_WORLD_SIZE`` under a
    launcher that says how many processes each host runs."""
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or len(ranks) or 1
    return sorted(ranks, key=lambda r: (r // per_host, r))


def axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    """The number of ranks along ``axis_name``; ``KeyError`` for an axis
    the mesh does not have (as ``jax.sharding.Mesh.shape[axis]``),
    ``TypeError`` for what is not a ``DeviceMesh``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            "the distributed pipeline runs on a torch.distributed DeviceMesh "
            f"(launch.mesh.make_fft_mesh), got {type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise KeyError(f"mesh has no axis {axis_name!r}: {names}")
    return int(mesh.size(names.index(axis_name)))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's blocks live on: the host for a cpu mesh, the
    process's current card for a cuda one."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _axis_lines(mesh: DeviceMesh, axis_name: str) -> list[tuple[int, ...]]:
    """Every line of ranks along ``axis_name`` (one per coordinate of the
    other axes, in row-major order of those), each in axis order: the
    ranks of one communicator of the axis.  A 1-D mesh has one line."""
    axis_size(mesh, axis_name)
    dim = tuple(mesh.mesh_dim_names).index(axis_name)
    grid = mesh.mesh.movedim(dim, -1)
    return [tuple(int(r) for r in line)
            for line in grid.reshape(-1, grid.shape[-1]).tolist()]


def _axis_ranks(mesh: DeviceMesh, axis_name: str) -> tuple[int, ...]:
    """This rank's line along ``axis_name`` (``_axis_lines``)."""
    me = dist.get_rank()
    return next(line for line in _axis_lines(mesh, axis_name) if me in line)


def register_emulated_hosts(mesh: DeviceMesh, axis_name: str, hosts: int) -> None:
    """Declare that ``mesh``'s ``axis_name`` axis is ``hosts`` host-major
    groups of ranks, with the process groups of the hierarchical exchange
    over them (built for the first mesh of this partition, then reused).

    The declaration lives on ``mesh`` alone: other meshes over the same
    ranks, whatever their axis name, keep their own.  On a 2-D mesh each
    line of ranks along the axis is one host-major axis, and the groups of
    every line are built.  Collective: every rank of the world calls it, in
    the same order as every other group creation.  ``hosts=1`` clears a
    prior declaration on this mesh.
    """
    lines = _axis_lines(mesh, axis_name)
    p = len(lines[0])
    hosts = int(hosts)
    layouts = getattr(mesh, _LAYOUT_ATTR, None)
    if layouts is None:
        layouts = {}
        setattr(mesh, _LAYOUT_ATTR, layouts)
    if hosts <= 1:
        layouts.pop(axis_name, None)
        return
    if p % hosts:
        raise ValueError(f"{hosts} hosts do not divide the {p} ranks of "
                         f"axis {axis_name!r}")
    layout = _HostLayout(hosts)
    if p // hosts > 1:
        layout = _HostLayout(hosts, *_hier_process_groups(lines, hosts))
    layouts[axis_name] = layout


def _hier_process_groups(lines: list[tuple[int, ...]], hosts: int) -> tuple:
    """This rank's (intra-host, inter-host) groups over the host-major
    ``lines`` of ranks (each line one axis communicator): made once per
    partition (collectively, every line's groups on every rank, in the same
    order), then reused."""
    from repro_torch.core.pfft_dist import _hier_groups  # lazy: core imports launch
    key = (dist.group.WORLD, tuple(lines), hosts)
    if key not in _HIER_GROUPS:
        me = dist.get_rank()
        mine = {}
        families = _hier_groups(hosts, len(lines[0]) // hosts)
        for ranks in lines:
            for tier, family in zip(("intra", "inter"), families):
                for positions in family:
                    members = [ranks[i] for i in positions]
                    group = dist.new_group(members)
                    if me in members:
                        mine[tier] = group
        _HIER_GROUPS[key] = (mine["intra"], mine["inter"])
    return _HIER_GROUPS[key]


def _layout(mesh: DeviceMesh, axis_name: str) -> _HostLayout | None:
    """The host layout registered on ``mesh``'s axis, if any."""
    return getattr(mesh, _LAYOUT_ATTR, {}).get(axis_name)


def mesh_host_shape(mesh: DeviceMesh, axis_name: str = "fft") -> tuple[int, int]:
    """``(hosts, local)`` along ``mesh``'s ``axis_name`` axis: the
    registered host-major structure, else ``(1, p)`` (no exploitable
    hierarchy; the exchange still works, with no fast tier to group on)."""
    try:
        ranks = _axis_ranks(mesh, axis_name)
    except KeyError as err:
        raise ValueError(*err.args) from None
    layout = _layout(mesh, axis_name)
    if layout is None:
        return 1, len(ranks)
    return layout.hosts, len(ranks) // layout.hosts


def hier_process_groups(mesh: DeviceMesh, axis_name: str):
    """This rank's (intra-host, inter-host) process groups of the
    hierarchical exchange, built with the mesh; ``ValueError`` when the
    axis has no non-degenerate host structure."""
    _axis_ranks(mesh, axis_name)
    layout = _layout(mesh, axis_name)
    if layout is None or layout.intra is None:
        raise ValueError(f"axis {axis_name!r} has no registered host "
                         "hierarchy; build the mesh with make_fft_mesh(hosts=)")
    return layout.intra, layout.inter


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device_type: str | None = None,
                    backend: str | None = None) -> DeviceMesh:
    """The trainer's ``data x model`` mesh, axes named ``("data", "model")``,
    over the whole world: rank ``(i, j)`` is the ``i*model + j``-th of the
    host-major ranks, so a ``"model"`` line stays on one host.  The process
    group comes up as in ``make_fft_mesh`` (a world of this process alone
    when there is none); ``ValueError`` when ``data * model`` is not the
    world size.  Every rank must call this alike."""
    device_type, world = join_world(device_type, backend)
    data, model = int(data), int(model)
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(
            f"the training mesh spans the whole world: {data}x{model}, but "
            f"{world} ranks are in the process group")
    grid = torch.tensor(host_major_devices()).reshape(data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks ('data', 'model').  Multi-pod: 2 pods
    = 512 ranks ('pod', 'data', 'model'); the pod axis carries pure DP so
    only gradient all-reduces cross the (slow) pod interconnect.  Over the
    whole world, host-major as ``make_local_mesh``: a ``"model"`` line stays
    on one host.  ``ValueError`` when the world is not the mesh's 256 (512)
    ranks; the dry-run builds it over a ``"fake"`` process group of that
    size.  Every rank must call this alike."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    device_type, world = join_world(device_type, None)
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {'x'.join(map(str, shape))} spans "
            f"{math.prod(shape)} ranks, but {world} are in the process group")
    grid = torch.tensor(host_major_devices()).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=axes)


def make_fft_mesh(p: int | None = None, axis_name: str = "fft", *,
                  hosts: int | None = None, local: int | None = None,
                  device_type: str | None = None,
                  backend: str | None = None) -> DeviceMesh:
    """1-D mesh for the distributed PFFT pipeline (and its tuner).

    Spans the whole world of ranks: ``p`` defaults to the world size and
    must equal it (each rank holds one block of the signal).  Without a
    process group, one is made from torchrun's environment, else for this
    process alone.  The axis name is part of the plan's
    ``topology_digest``, so callers who rename it get distinct wisdom keys.

    ``hosts``/``local`` make the axis host-major over ``hosts x local``
    ranks (either may be derived from the other and the world size);
    without either, the launcher's ``LOCAL_WORLD_SIZE`` gives the hosts
    when it divides the world.  ``hosts=1`` is the flat mesh.  Every rank
    must call this alike: it creates process groups.
    """
    device_type, world = join_world(device_type, backend)
    if hosts is None and local is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", 0))
        if 1 < per_host < world and world % per_host == 0:
            hosts = world // per_host
    elif hosts is None:
        hosts = (int(p) if p is not None else world) // int(local)
    elif local is None:
        local = (int(p) if p is not None else world) // int(hosts)
    if hosts is not None and local is not None:
        if int(hosts) < 1 or int(local) < 1:
            raise ValueError(f"hosts x local must be positive, got {hosts}x{local}")
        p = int(hosts) * int(local)
    p = world if p is None else int(p)
    if p != world:
        raise ValueError(
            f"the FFT mesh spans the whole world: p={p}, but {world} ranks "
            "are in the process group (one rank per block of the signal)")
    mesh = DeviceMesh(device_type, host_major_devices(), mesh_dim_names=(axis_name,))
    register_emulated_hosts(mesh, axis_name, int(hosts) if hosts else 1)
    return mesh


def join_world(device_type: str | None, backend: str | None) -> tuple[str, int]:
    """The process group a mesh builder runs in (made from torchrun's
    environment, else for this process alone, when none exists), checked
    against the backend the mesh asks for (the dry-run's ``"fake"`` group
    stands in for any); this process's card selected.
    Returns (device type, world size)."""
    device_type, backend = _backend_for(device_type, backend)
    if not dist.is_initialized():
        if not init_multihost_from_env(device_type=device_type, backend=backend):
            _init_single_process(device_type, backend)
    elif dist.get_backend() not in (backend, "fake"):
        raise ValueError(
            f"the process group runs {dist.get_backend()!r}, the mesh asks "
            f"for {backend!r} (device_type={device_type!r})")
    if device_type == "cuda":
        _set_cuda_device(dist.get_rank())
    return device_type, dist.get_world_size()


def make_pfft3_mesh(r: int | None = None, c: int | None = None,
                    axis_names: tuple[str, str] = ("fft_r", "fft_c"), *,
                    hosts: int | None = None, device_type: str | None = None,
                    backend: str | None = None) -> DeviceMesh:
    """2-D ``r x c`` mesh for the pencil-parallel 3-D PFFT.

    Spans the whole world of ranks (``r*c`` must equal it), laid out from
    the host-major ranks row by row: rank ``(i, j)`` is the ``i*c + j``-th.
    Defaults to the most-square factorization of the world (``r <= c``);
    passing one of ``r``/``c`` derives the other.  Both axis names enter
    the plan's ``topology_digest``, so a transposed mesh gets distinct
    wisdom keys.

    ``hosts`` builds the grid host-major with the host dimension riding
    the ``r`` axis (the default is then ``r = hosts``): each host owns
    ``r/hosts`` contiguous mesh rows, so every ``c``-axis communicator
    stays inside one host and only the ``r``-axis exchange crosses the
    slow tier.  Requires ``hosts | r``.  Without it, the launcher's
    ``LOCAL_WORLD_SIZE`` gives the hosts when they divide ``r``.  The
    process group comes up as in ``make_fft_mesh``; every rank must call
    this alike.
    """
    device_type, world = join_world(device_type, backend)
    if r is None and c is None:
        if hosts is not None and int(hosts) > 1:
            r = int(hosts)
        else:
            r = next(f for f in range(math.isqrt(world), 0, -1)
                     if world % f == 0)
        c = world // r
    elif r is None:
        r = world // int(c)
    elif c is None:
        c = world // int(r)
    r, c = int(r), int(c)
    if r < 1 or c < 1 or r * c != world:
        raise ValueError(
            f"the pencil mesh spans the whole world: {r}x{c}, but {world} "
            "ranks are in the process group (one rank per pencil)")
    if hosts is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", 0))
        if 1 < per_host < world and world % per_host == 0 \
                and r % (world // per_host) == 0:
            hosts = world // per_host
    else:
        hosts = int(hosts)
        if hosts < 1 or r % hosts:
            raise ValueError(
                f"host count must divide the r axis: hosts={hosts}, r={r}")
    grid = torch.tensor(host_major_devices()).reshape(r, c)
    mesh = DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))
    register_emulated_hosts(mesh, axis_names[0], hosts or 1)
    return mesh


# ----------------------------------------------- decisions agreed by ranks

def _axis_group(mesh: DeviceMesh, axes):
    """The group of ranks that agree: the axis's communicator for one axis
    name; for a sequence of names (each of which the mesh must have), the
    whole mesh — the default group, which every mesh spans."""
    if isinstance(axes, str):
        axis_size(mesh, axes)
        return mesh.get_group(axes)
    for name in axes:
        axis_size(mesh, name)
    if mesh.mesh.numel() != dist.get_world_size():
        raise ValueError("a whole-mesh decision needs a mesh over the whole "
                         f"world, got {mesh.mesh.numel()} of "
                         f"{dist.get_world_size()} ranks")
    return dist.group.WORLD


def first_rank_value(mesh: DeviceMesh, axis_name, fn):
    """``fn()`` run on the first rank alone and handed to every rank (a
    wisdom lookup, fitted constants): one answer for the whole mesh.
    ``axis_name``: one axis (its group agrees), or a sequence of names (all
    the mesh's ranks agree)."""
    group = _axis_group(mesh, axis_name)
    box = [fn() if dist.get_rank(group) == 0 else None]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def first_rank_does(mesh: DeviceMesh, axis_name, fn) -> None:
    """``fn()`` on the first rank alone (a wisdom write, under the store's
    own lock), then a barrier, so no rank reads before it is done; over one
    axis or, for a sequence of names, the whole mesh."""
    group = _axis_group(mesh, axis_name)
    if dist.get_rank(group) == 0:
        fn()
    dist.barrier(group=group)


def _agreement_device(mesh: DeviceMesh, group) -> torch.device:
    """Where a small tensor agreed over ``group`` lives: this rank's card
    under NCCL, the host otherwise."""
    return (mesh_device(mesh) if dist.get_backend(group) == "nccl"
            else torch.device("cpu"))


def agree_on_failure(failed: BaseException | None, mesh: DeviceMesh,
                     axis_name) -> str | None:
    """Whether any rank of the axis (or, for a sequence of names, of the
    whole mesh) failed its local step: None on every rank when none did,
    else the ``repr`` of the first failing rank's error, on every rank.
    One ``all_reduce`` (the lowest failing rank), and a broadcast only
    after a failure.  Every rank must call it, failed or not."""
    group = _axis_group(mesh, axis_name)
    size, me = dist.get_world_size(group), dist.get_rank(group)
    first = torch.tensor([me if failed is not None else size],
                         dtype=torch.int64, device=_agreement_device(mesh, group))
    dist.all_reduce(first, op=dist.ReduceOp.MIN, group=group)
    src = int(first.item())
    if src >= size:
        return None
    box = [repr(failed) if me == src else None]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src),
                               group=group)
    return box[0]


def max_over_axis(values: list[float], mesh: DeviceMesh,
                  axis_name) -> list[float]:
    """Each value's maximum over the ranks of the axis (or, for a sequence
    of names, of the whole mesh): a measured time of an SPMD program is its
    slowest rank's, and every rank ranks the same numbers."""
    group = _axis_group(mesh, axis_name)
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=_agreement_device(mesh, group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()
