"""Cases of the 3-D mesh parity tests, and the two programs that run them.

``_torch_dist_cases.run_job("pfft3", tmp, worlds=(4,), module=__name__)``
starts 4 processes of the port as the ranks of one gloo world on the host
(``device_type="cpu"``) and one process of the JAX package on a forced
4-device CPU, at once.  Both sides build the same meshes over the 4 ranks —
pencil meshes of 2x2, 1x4, 4x1 and 4x1 over 2 emulated hosts, slab meshes
flat and of 2 hosts x 2 — and run the same cases on one seeded numpy cube.
The port's rank 0 gathers every rank's block by its mesh coordinates into
the global array the reference returns.  The module imports neither
package at the top: each program imports its own.
"""

from __future__ import annotations

import os

import numpy as np

import _torch_dist_cases as base

N = 16
PAD_LEN = 20          # a smooth non-power-of-two pad, so the crop engages
BAD_N = 18            # divisible by no axis of 4
RANKS = 4

# name -> (r, c, hosts) of a pencil mesh over the 4 ranks.
PENCIL_MESHES = {"2x2": (2, 2, None), "1x4": (1, 4, None),
                 "4x1": (4, 1, None), "4x1h2": (4, 1, 2)}
# name -> pfft3_pencil keyword arguments, with ``config`` spelled as data.
PENCIL_CASES = {
    "library": {"config": {}},
    "radix2": {"config": {"radix": 2}},
    "radix4": {"config": {"radix": 4}},
    "panels2": {"config": {"pipeline_panels": 2}},
    "radix4_panels2": {"config": {"radix": 4, "pipeline_panels": 2}},
    "crop": {"config": {"pad": "fpm"}, "pad_len": PAD_LEN},
    "czt": {"config": {"pad": "czt"}},
    "grouped": {"schedule": "grouped"},
    "raw": {"config": {}, "transpose_back": False},
    "hier": {"config": {"exchange": "hier"}},
    "hier_panels2": {"config": {"exchange": "hier", "pipeline_panels": 2}},
}
# The cases each pencil mesh runs: all on the square mesh, the layouts'
# own on the others.
MESH_CASES = {
    "2x2": list(PENCIL_CASES),
    "1x4": ["library", "radix4", "panels2", "raw", "hier"],
    "4x1": ["library", "radix4", "panels2", "raw", "hier"],
    "4x1h2": ["library", "radix4", "raw", "hier", "hier_panels2"],
}
# name -> (slab mesh hosts, pfft3_slab keyword arguments).
SLAB_CASES = {
    "library": (None, {"config": {}}),
    "radix4": (None, {"config": {"radix": 4}}),
    "crop": (None, {"config": {"pad": "fpm"}, "pad_len": PAD_LEN}),
    "hier": (2, {"config": {"exchange": "hier"}}),
    "hier_radix4": (2, {"config": {"radix": 4, "exchange": "hier"}}),
}
# Pairs that must agree element for element (same transform, other
# program): pipelined panels and the monolithic round, the hierarchical
# exchange and the flat one, the dispatcher and the entry it dispatches to.
PENCIL_EQUAL = [("panels2", "library"), ("radix4_panels2", "radix4"),
                ("hier", "library"), ("hier_panels2", "library")]
SLAB_EQUAL = [("hier", "library"), ("hier_radix4", "radix4")]
# plan_pfft3(mesh=) at tune="estimate": (mesh, axis names).
ESTIMATE_PLANS = {"2x2": ("2x2", ("fft_r", "fft_c")),
                  "1x4": ("1x4", ("fft_r", "fft_c")),
                  "1x4_swapped": ("1x4", ("fft_c", "fft_r")),
                  "4x1": ("4x1", ("fft_r", "fft_c")),
                  "4x1h2": ("4x1h2", ("fft_r", "fft_c"))}
MEASURE_MESHES = ("1x4", "4x1h2")
# make_pfft3_mesh's defaults: name -> keyword arguments.
DEFAULT_MESHES = {"default": {}, "hosts2": {"hosts": 2}, "c4": {"c": 4},
                  "r4": {"r": 4}}


def cube(n: int = N, seed: int = 11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n, n))
            + 1j * rng.standard_normal((n, n, n))).astype(np.complex64)


def _kwargs(spec: dict, PlanConfig, SegmentSchedule) -> dict:
    """A case's keyword arguments as the side's own objects: the grouped
    schedule is ``_torch_dist_cases``' over the 4 ranks (library on the
    first half, the kernel on the rest)."""
    kw = dict(spec)
    if "config" in kw:
        kw["config"] = PlanConfig(**kw["config"])
    if "schedule" in kw:
        d, pads, cfgs = base.schedule_parts(kw["schedule"], N, RANKS)
        kw["schedule"] = SegmentSchedule.from_parts(
            N, np.asarray(d), None if pads is None else np.asarray(pads),
            [PlanConfig(**c) for c in cfgs])
    return kw


def _layout(mesh, names, sizes, host_shape) -> dict:
    """What the parity test compares of a built pencil mesh: its axes and
    sizes and the host shape along each axis."""
    return {"axes": [(a, int(sz)) for a, sz in zip(names, sizes)],
            "hosts": [tuple(host_shape(mesh, a)) for a in names]}


def _plan_record(plan) -> dict:
    """What the parity test compares of a planned pencil transform."""
    return {"describe": plan.config.describe(),
            "orientation": list(plan.axis_names),
            "topology": plan.tuning.get("topology"),
            "key": plan.tuning.get("wisdom_key"),
            "source": plan.tuning.get("source"),
            "ranked": [(c, a) for c, a, _ in plan.tuning.get("ranked", [])]}


# ------------------------------------------------------------------ port

def _pencil_of(x: np.ndarray, mesh, axes) -> tuple[tuple[int, int], np.ndarray]:
    """This rank's coordinates along ``axes`` and its pencil of ``x``."""
    i, j = (mesh.get_local_rank(a) for a in axes)
    r, c = (mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)
    n = x.shape[-1]
    return (i, j), x[i * n // r:(i + 1) * n // r, j * n // c:(j + 1) * n // c]


def _assemble(parts: list, r: int, c: int, layout: str) -> np.ndarray:
    """The global array from every rank's ((i, j), block) of an ``r x c``
    mesh: a pencil result in ``fftn`` order is laid out ``P(None, r, c)``,
    a ``raw`` one ``[k2, k1, k0]`` with block (i, j) at ``raw[j·N/c:,
    i·N/r:, :]``, and a ``slab`` result (c = 1) ``P(r, None, None)``."""
    full = np.zeros((N, N, N), np.complex64)
    for (i, j), block in parts:
        rows = slice(i * N // r, (i + 1) * N // r)
        cols = slice(j * N // c, (j + 1) * N // c)
        if layout == "raw":
            full[cols, rows] = block
        elif layout == "slab":
            full[rows] = block
        else:
            full[:, rows, cols] = block
    return full


def _gather(value):
    import torch.distributed as dist
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, value)
    return seen


def _port_pfft3(p: int, tmp: str) -> dict:
    import torch
    from repro_torch.core import pfft3d as D
    from repro_torch.core.api import plan_pfft3
    from repro_torch.launch.mesh import (make_fft_mesh, make_pfft3_mesh,
                                         mesh_host_shape)
    from repro_torch.plan import PlanConfig, SegmentSchedule

    x = cube()
    axes = ("fft_r", "fft_c")
    meshes = {name: make_pfft3_mesh(r, c, hosts=h, device_type="cpu")
              for name, (r, c, h) in PENCIL_MESHES.items()}
    out: dict = {}
    for name, mesh in meshes.items():
        r, c, _ = PENCIL_MESHES[name]
        coords, blk = _pencil_of(x, mesh, axes)
        for case in MESH_CASES[name]:
            kw = _kwargs(PENCIL_CASES[case], PlanConfig, SegmentSchedule)
            got = D.pfft3_pencil(torch.from_numpy(blk), mesh, axes, **kw)
            out[f"pencil/{name}/{case}"] = (
                coords, got.numpy(), r, c, "raw" if case == "raw" else "fftn")
        got = D.pfft3_distributed(torch.from_numpy(blk), mesh, list(axes))
        out[f"pencil/{name}/distributed"] = (coords, got.numpy(), r, c, "fftn")
    slabs = {None: make_fft_mesh(RANKS, device_type="cpu"),
             2: make_fft_mesh(hosts=2, local=2, device_type="cpu")}
    for case, (hosts, spec) in SLAB_CASES.items():
        mesh = slabs[hosts]
        q = mesh.get_local_rank("fft")
        kw = _kwargs(spec, PlanConfig, SegmentSchedule)
        got = D.pfft3_slab(torch.from_numpy(x[q * N // RANKS:(q + 1) * N // RANKS]),
                           mesh, "fft", **kw)
        out[f"slab/{case}"] = ((q, 0), got.numpy(), RANKS, 1, "slab")
    q = slabs[None].get_local_rank("fft")
    got = D.pfft3_distributed(
        torch.from_numpy(x[q * N // RANKS:(q + 1) * N // RANKS]), slabs[None])
    out["slab/distributed"] = ((q, 0), got.numpy(), RANKS, 1, "slab")

    plans, planned = {}, {}
    for name, (mesh_name, names) in ESTIMATE_PLANS.items():
        mesh = meshes[mesh_name]
        plan = plan_pfft3(N, mesh=mesh, axis_names=names, tune="estimate")
        plans[name] = _plan_record(plan)
        coords, blk = _pencil_of(x, mesh, plan.axis_names)
        r, c = (mesh.size(mesh.mesh_dim_names.index(a)) for a in plan.axis_names)
        planned[f"plan/{name}"] = (coords, plan.execute(
            torch.from_numpy(blk)).numpy(), r, c, "fftn")
    out.update(planned)

    measured = {}
    for name in MEASURE_MESHES:
        store = os.path.join(tmp, f"wisdom_{name}.json")
        first = plan_pfft3(N, mesh=meshes[name], tune="measure", wisdom=store)
        stored = open(store).read()
        second = plan_pfft3(N, mesh=meshes[name], tune="measure", wisdom=store)
        coords, blk = _pencil_of(x, meshes[name], second.axis_names)
        r, c = (meshes[name].size(meshes[name].mesh_dim_names.index(a))
                for a in second.axis_names)
        out[f"measure/{name}"] = (coords, second.execute(
            torch.from_numpy(blk)).numpy(), r, c, "fftn")
        measured[name] = {
            "first": _plan_record(first), "second": _plan_record(second),
            "measured": first.tuning.get("measured"),
            "second_measured": "measured" in second.tuning,
            "pfft3": first.tuning.get("pfft3"),
            "store": stored, "store_after": open(store).read()}

    layouts = {}
    for name, kw in DEFAULT_MESHES.items():
        mesh = make_pfft3_mesh(device_type="cpu", **kw)
        layouts[name] = _layout(mesh, mesh.mesh_dim_names, mesh.mesh.shape,
                                mesh_host_shape)
    blocks = _gather(out)
    result = {"picks": plans, "measured": _gather(measured),
              "layouts": layouts,
              "errors": _refusals(x, meshes, D, plan_pfft3, PlanConfig)}
    for key in out:
        parts = [(b[key][0], b[key][1]) for b in blocks]
        _, _, r, c, layout = out[key]
        result[key] = _assemble(parts, r, c, layout)
    return result


def _refusals(x, meshes, D, plan_pfft3, PlanConfig) -> dict:
    """{case: (exception type name, message)} of calls that must be refused
    before any exchange (every rank refuses alike)."""
    import torch
    from repro_torch.launch.mesh import make_pfft3_mesh
    from repro_torch.plan import SegmentSchedule

    axes = ("fft_r", "fft_c")
    _, blk = _pencil_of(x, meshes["2x2"], axes)
    blk = torch.from_numpy(blk)
    grouped = _kwargs({"schedule": "grouped"}, PlanConfig, SegmentSchedule)
    bad = torch.zeros((BAD_N // 4 + 1, BAD_N, BAD_N), dtype=torch.complex64)
    plan = plan_pfft3(N, mesh=meshes["2x2"])
    calls = {
        "hosts_not_dividing_r": lambda: make_pfft3_mesh(
            1, 4, hosts=2, device_type="cpu"),
        "mesh_not_the_world": lambda: make_pfft3_mesh(3, 1, device_type="cpu"),
        "fused": lambda: D.pfft3_pencil(
            blk, meshes["2x2"], config=PlanConfig(radix=4, fused=True)),
        "schedule_and_config": lambda: D.pfft3_pencil(
            blk, meshes["2x2"], config=PlanConfig(), **grouped),
        "not_divisible": lambda: D.pfft3_pencil(bad, meshes["4x1"]),
        "plan_not_divisible": lambda: plan_pfft3(BAD_N, mesh=meshes["4x1"]),
        "slab_not_divisible": lambda: D.pfft3_slab(bad, meshes["4x1"], "fft_r"),
        "panels_not_dividing": lambda: D.pfft3_pencil(
            torch.from_numpy(_pencil_of(x, meshes["1x4"], axes)[1]),
            meshes["1x4"], config=PlanConfig(pipeline_panels=8)),
        "plan_p_conflict": lambda: plan_pfft3(N, p=3, mesh=meshes["2x2"]),
        "plan_batch": lambda: plan.execute(torch.stack([blk, blk])),
        "not_a_mesh": lambda: D.pfft3_pencil(blk, object()),
        "unknown_axis": lambda: D.pfft3_pencil(blk, meshes["2x2"], ("a", "b")),
        "not_this_ranks_block": lambda: D.pfft3_pencil(
            torch.from_numpy(x), meshes["2x2"]),
    }
    seen = {}
    for name, call in calls.items():
        try:
            call()
            seen[name] = None
        except Exception as err:  # the test names the type it expects
            seen[name] = (type(err).__name__, str(err))
    return seen


PORT_JOBS = {"pfft3": _port_pfft3}


def port_main() -> None:
    base.port_main(PORT_JOBS)


# ------------------------------------------------------------- reference

def _reference_pfft3(p: int, tmp: str) -> dict:
    import functools

    import jax
    import jax.numpy as jnp
    from repro.core import pfft3d as D
    from repro.core.api import plan_pfft3
    from repro.launch.mesh import (make_fft_mesh, make_pfft3_mesh,
                                   mesh_host_shape)
    from repro.plan import PlanConfig, SegmentSchedule

    m = jnp.asarray(cube())
    axes = ("fft_r", "fft_c")
    out = {}

    def mesh_of(name: str):
        # Built anew before each use: the reference keeps emulated hosts in
        # one registry keyed by (axis name, devices), where the last mesh
        # built over the same devices wins; a port mesh keeps its own.
        r, c, h = PENCIL_MESHES[name]
        return make_pfft3_mesh(r, c, hosts=h)


    def run(fn, mesh, *args, **kw):
        # jitted, as a plan jits: one trace, not op by op.
        return jax.jit(functools.partial(fn, mesh=mesh, **kw))(m, *args)

    for name in PENCIL_MESHES:
        for case in MESH_CASES[name]:
            kw = _kwargs(PENCIL_CASES[case], PlanConfig, SegmentSchedule)
            out[f"pencil/{name}/{case}"] = run(D.pfft3_pencil, mesh_of(name),
                                               axis_names=axes, **kw)
    for case, (hosts, spec) in SLAB_CASES.items():
        slab = (make_fft_mesh(hosts=2, local=2) if hosts
                else make_fft_mesh(RANKS))
        kw = _kwargs(spec, PlanConfig, SegmentSchedule)
        out[f"slab/{case}"] = run(D.pfft3_slab, slab, axis_name="fft", **kw)
    plans = {}
    for name, (mesh_name, names) in ESTIMATE_PLANS.items():
        plan = plan_pfft3(N, mesh=mesh_of(mesh_name), axis_names=names,
                          tune="estimate")
        plans[name] = _plan_record(plan)
        out[f"plan/{name}"] = plan.execute(m)
    layouts = {}
    for name, kw in DEFAULT_MESHES.items():
        mesh = make_pfft3_mesh(**kw)
        layouts[name] = _layout(mesh, mesh.axis_names,
                                [mesh.shape[a] for a in mesh.axis_names],
                                mesh_host_shape)
    errors = {}
    bad = jnp.zeros((BAD_N,) * 3, jnp.complex64)
    square = mesh_of("2x2")
    calls = {
        "hosts_not_dividing_r": lambda: make_pfft3_mesh(1, 4, hosts=2),
        "fused": lambda: D.pfft3_pencil(
            m, square, config=PlanConfig(radix=4, fused=True)),
        "schedule_and_config": lambda: D.pfft3_pencil(
            m, square, config=PlanConfig(),
            **_kwargs({"schedule": "grouped"}, PlanConfig, SegmentSchedule)),
        "not_divisible": lambda: D.pfft3_pencil(bad, mesh_of("4x1")),
        "plan_not_divisible": lambda: plan_pfft3(BAD_N, mesh=mesh_of("4x1")),
        "slab_not_divisible": lambda: D.pfft3_slab(bad, mesh_of("4x1"), "fft_r"),
        "panels_not_dividing": lambda: D.pfft3_pencil(
            m, mesh_of("1x4"), config=PlanConfig(pipeline_panels=8)),
        "plan_p_conflict": lambda: plan_pfft3(N, p=3, mesh=square),
        "plan_batch": lambda: plan_pfft3(N, mesh=square).execute(
            jnp.stack([m, m])),
    }
    for name, call in calls.items():
        try:
            call()
            errors[name] = None
        except Exception as err:  # the test compares type and message
            errors[name] = (type(err).__name__, str(err))
    result = {k: np.asarray(v) for k, v in out.items()}
    result.update(picks=plans, errors=errors, layouts=layouts)
    return result


REFERENCE_JOBS = {"pfft3": _reference_pfft3}


def reference_main() -> None:
    base.reference_main(REFERENCE_JOBS)
