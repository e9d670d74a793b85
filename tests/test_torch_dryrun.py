"""The port's dry-run (``repro_torch.launch.dryrun``) and production mesh
(``launch.mesh.make_production_mesh``) against the JAX package's:
``cell_plan``, ``_train_cfg_for`` on both production meshes, ``_drop_fsdp``
and the parts of each kind of cell, all exact; then SMOKE configs traced
through ``lower_cell`` / ``trace_parts`` on fake worlds: on 1 x 1 the
counts over fake tensors equal the same counts over real CPU tensors
running the same step; on 2 x 2 and 2 x 2 x 2 the all-gathered bytes equal
what each parameter's placements say; one ``python -m
repro_torch.launch.dryrun`` run on the CPU writes a record with the
reference's keys.  The reference's module is imported as its own
``tests/test_launch.py`` imports it (host logic only)."""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro.launch import dryrun as ref_dryrun
import repro.models.registry as ref_registry
import repro_torch.launch.dryrun as port_dryrun
import repro_torch.models.registry as port_registry
from repro.configs.base import SHAPES as REF_SHAPES
from repro_torch.configs.base import SHAPES as PORT_SHAPES
from repro_torch.configs.base import ShapeCfg, TrainCfg
from repro_torch.launch.mesh import make_production_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(ref_registry.ARCH_IDS)


class FakeMesh:
    """The reference's mesh as its ``_train_cfg_for`` reads it."""

    def __init__(self, shape: dict):
        self.shape = shape


PRODUCTION = {"16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def test_cell_plan_equals_the_reference():
    assert port_dryrun.cell_plan() == ref_dryrun.cell_plan()
    assert len(port_dryrun.cell_plan()) == 31


@pytest.mark.parametrize("mesh", sorted(PRODUCTION))
def test_train_cfg_for_equals_the_reference_on_the_production_meshes(mesh):
    sizes = PRODUCTION[mesh]
    shape = (2, 16, 16) if "pod" in sizes else (16, 16)
    with port_dryrun.fake_world(shape, device="cpu") as device_mesh:
        assert dict(zip(device_mesh.mesh_dim_names, device_mesh.shape)) == sizes
        for arch in ARCHS:
            for name, ref_shape in REF_SHAPES.items():
                if ref_shape.kind != "train":
                    continue
                ref = ref_dryrun._train_cfg_for(ref_registry.get_config(arch),
                                                ref_shape, FakeMesh(sizes))
                port = port_dryrun._train_cfg_for(
                    port_registry.get_config(arch), PORT_SHAPES[name], device_mesh)
                assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_drop_fsdp_equals_the_reference():
    from jax.sharding import PartitionSpec as P
    # tests/test_launch.py's specs
    ref = ref_dryrun._drop_fsdp({"a": P("data", "model"), "b": P(("pod", "data"), None),
                                 "c": P("model", "data"), "d": P(None)})
    port = port_dryrun._drop_fsdp({"a": ("data", "model"), "b": (("pod", "data"), None),
                                   "c": ("model", "data"), "d": (None,)})
    assert port == {k: tuple(v) for k, v in ref.items()}
    assert port == {"a": (None, "model"), "b": ("pod", None),
                    "c": ("model", None), "d": (None,)}
    assert port_dryrun._drop_fsdp((("pod", "data", "model"), "data")) == \
        (("pod", "model"), None)


SMALL = {"train": ShapeCfg("t", 32, 8, "train"),
         "prefill": ShapeCfg("p", 32, 4, "prefill"),
         "decode": ShapeCfg("d", 32, 4, "decode")}


def lowered(arch, kind, mesh, analysis=False, microbatches=2, **kw):
    return port_dryrun.lower_cell(
        arch, SMALL[kind].name, mesh=mesh, analysis=analysis, device="cpu",
        cfg=port_registry.get_smoke_config(arch), shape=SMALL[kind],
        tcfg=TrainCfg(microbatches=microbatches), **kw)


def test_parts_of_each_kind_are_the_references():
    """The names and weights of ``src/repro/launch/dryrun.py``'s parts:
    one ``train_step``, or ``grad_mb`` x microbatches and ``opt`` under
    analysis (with the 4/3 remat correction); one ``prefill``; one
    ``serve_step``."""
    want = {("train", False): [("train_step", 1.0)],
            ("train", True): [("grad_mb", 4.0), ("opt", 1.0)],
            ("prefill", False): [("prefill", 1.0)],
            ("decode", False): [("serve_step", 1.0)]}
    for (kind, analysis), names in want.items():
        with port_dryrun.fake_world((1, 1), device="cpu") as mesh:
            parts, meta = lowered("internlm2_1_8b", kind, mesh, analysis,
                                  microbatches=4)
        assert [(n, w) for n, _, w in parts] == names
        assert meta["remat_flop_correction"] == (4 / 3 if analysis else 1.0)
        assert meta["kind"] == kind and meta["chips"] == 1


CASES = [(arch, kind, analysis)
         for arch in ("internlm2_1_8b", "deepseek_v2_lite_16b", "zamba2_7b")
         for kind, analysis in (("train", False), ("train", True),
                                ("prefill", False), ("decode", False))
         if (arch, kind, analysis) != ("zamba2_7b", "train", False)]


@pytest.mark.parametrize("arch,kind,analysis", CASES)
def test_fake_counts_equal_real_counts_on_one_rank(arch, kind, analysis):
    """On a 1 x 1 mesh the same step counted over fake tensors and over
    real CPU tensors gives the same FLOPs, bytes, collectives and memory."""
    got = []
    for fake in (True, False):
        with port_dryrun.fake_world((1, 1), device="cpu", fake_tensors=fake) as mesh:
            parts, meta = lowered(arch, kind, mesh, analysis)
            got.append(port_dryrun.trace_parts(parts, meta))
    assert got[0] == got[1]
    cost, coll, mems = got[0]
    assert cost["flops"] > 0 and cost["bytes accessed"] > 0
    assert "all-gather" not in coll and "reduce-scatter" not in coll
    assert all(m["argument_bytes"] > 0 and m["temp_bytes"] > 0 for _, m in mems)


def gathered_bytes(tensors) -> int:
    """All-gather output bytes of gathering each DTensor whole, one mesh
    dimension at a time: the last gather outputs the whole tensor, the one
    before it the whole over the last dimension's size."""
    total = 0
    for p in tensors:
        whole = p.numel() * p.element_size()
        sizes = [p.device_mesh.size(i) for i, pl in enumerate(p.placements)
                 if pl.is_shard()]
        left = whole
        for n in reversed(sizes):
            total += left
            left //= n
    return total


@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("arch,kind", [
    ("internlm2_1_8b", "train"), ("dbrx_132b", "train"),
    ("internlm2_1_8b", "decode"), ("dbrx_132b", "decode"), ("zamba2_7b", "decode")])
def test_all_gather_bytes_follow_the_placements(shape, arch, kind):
    """Each microbatch gathers every parameter whole once; the train step
    also gathers the global batch (``full_tensor``), and its data ranks sum
    the loss."""
    with port_dryrun.fake_world(shape, device="cpu") as mesh:
        parts, meta = lowered(arch, kind, mesh)
        part = parts[0][1]
        params = part.args[0].params if kind == "train" else part.args[0]
        want = gathered_bytes(params.parameters())
        if kind == "train":
            want = 2 * want + gathered_bytes(part.args[1].values())
        cost, coll, mems = port_dryrun.trace_parts(parts, meta)
    assert meta["chips"] == (4 if shape == (2, 2) else 8)
    assert coll["all-gather"] == want
    if kind == "train":
        assert coll["reduce-scatter"] > 0 and coll["all-reduce"] > 0
    else:
        assert set(coll) == {"all-gather"}


def test_opts_act_or_raise():
    with port_dryrun.fake_world((2, 2), device="cpu") as mesh:
        with pytest.raises(ValueError, match="not_an_opt"):
            lowered("internlm2_1_8b", "decode", mesh, opts={"not_an_opt": 1})
        with pytest.raises(ValueError, match="cache_data_shard"):
            lowered("internlm2_1_8b", "decode", mesh, opts={"cache_data_shard": True})
        with pytest.raises(ValueError, match="no_fsdp"):
            lowered("internlm2_1_8b", "train", mesh, opts={"no_fsdp": True})
        with pytest.raises(ValueError, match="shard_grad_accum"):
            lowered("internlm2_1_8b", "prefill", mesh, opts={"shard_grad_accum": True})
        parts, _ = lowered("internlm2_1_8b", "decode", mesh, opts={"no_fsdp": True})
        params = parts[0][1].args[0]
        # no parameter keeps a block split over "data" (mesh dimension 0)
        assert all(not p.placements[0].is_shard() for p in params.parameters())
        parts, _ = lowered("internlm2_1_8b", "train", mesh,
                           opts={"shard_grad_accum": True, "seq_shard": True})
        port_dryrun.trace_parts(parts, _)
    from repro_torch.models import sharding
    assert sharding.SEQ_SHARD
    sharding.set_seq_shard(False)
    moe = port_registry.get_config("dbrx_132b")
    zamba = port_registry.get_config("zamba2_7b")
    train = PORT_SHAPES["train_4k"]
    cf = port_dryrun._apply_opts(moe, train, {"capacity_factor": 2})
    assert cf.moe.capacity_factor == 2.0
    ssd = port_dryrun._apply_opts(zamba, train, {"ssd_remat": True, "ssd_chunk": 128})
    assert (ssd.ssm.remat_chunk, ssd.ssm.chunk) == (True, 128)
    assert port_dryrun._apply_opts(moe, train, {"ssd_chunk": 128}) == moe


def test_production_mesh_and_the_fake_world():
    with port_dryrun.fake_world((2, 16, 16), device="cpu") as mesh:
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16) and dist.get_world_size() == 512
        with pytest.raises(ValueError, match="256"):
            make_production_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="process group exists"):
            with port_dryrun.fake_world((1, 1), device="cpu"):
                pass
        assert dist.is_initialized()          # the caller's world stays
    assert not dist.is_initialized()
    with port_dryrun.fake_world((2, 2), device="cpu"):
        with pytest.raises(ValueError, match="512"):
            make_production_mesh(multi_pod=True, device_type="cpu")


def reference_record_keys() -> tuple[set, set]:
    """The keys of the reference's record and of its ``memory``, read off
    ``src/repro/launch/dryrun.py`` (``meta`` in ``lower_cell``, then
    ``run_cell``'s additions)."""
    tree = ast.parse(open(os.path.join(ROOT, "src/repro/launch/dryrun.py")).read())
    keys, memory = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id in ("meta", "rec"):
                for k, v in zip(node.value.keys, node.value.values):
                    if k is None:
                        continue
                    keys.add(k.value)
                    if k.value == "memory":
                        memory = {mk.value for mk in v.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            target = node.targets[0]
            if isinstance(target.value, ast.Name) and target.value.id == "meta":
                keys.add(target.slice.value)
    return keys, memory


def test_command_line_writes_the_reference_record(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the CPU: xlstm-125m FULL
    decode_32k on the fake 16x16 mesh."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "xlstm_125m",
         "--shape", "decode_32k", "--device", "cpu", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert done.returncode == 0, done.stderr[-3000:]
    assert "all requested cells traced" in done.stdout
    rec = json.loads((tmp_path / "xlstm_125m__decode_32k__pod__baseline.json").read_text())
    keys, memory = reference_record_keys()
    assert set(rec) == keys and set(rec["memory"]) == memory
    from repro.launch.roofline import RooflineTerms
    assert set(rec["roofline"]) == set(RooflineTerms(0, 0, 0, 1, 0, {}, 0, 1).to_dict())
    assert rec["chips"] == 256 and rec["parts"] == ["serve_step"]
    assert rec["roofline"]["coll_bytes"]["all-gather"] > 0
    assert all(v > 0 for v in rec["memory"].values())


@pytest.mark.parametrize("jobs", [1, 2])
def test_main_names_the_cells_that_fail(capsys, tmp_path, jobs):
    """In this process (``--jobs 1``) and in a process a run (``--jobs 2``,
    its output in ``<out>/logs/``)."""
    code = port_dryrun.main(["--arch", "internlm2_1_8b", "--shape", "decode_32k",
                             "--device", "cpu", "--out", str(tmp_path),
                             "--opt", "cache_data_shard=true", "--jobs", str(jobs)])
    assert code == 1
    out = capsys.readouterr().out
    assert "FAILED 1 cells" in out and "internlm2_1_8b" in out
    assert not dist.is_initialized()
    if jobs > 1:
        log = tmp_path / "logs" / "internlm2_1_8b__decode_32k__pod__baseline.log"
        assert "cache_data_shard" in log.read_text()


@pytest.mark.parametrize("arch,kind", [("xlstm_125m", "prefill"), ("xlstm_125m", "train"),
                                       ("internlm2_1_8b", "decode")])
def test_fake_trace_on_2x2_counts_what_real_tensors_do(arch, kind):
    """On 2 x 2 (the sLSTM's per-position loop among them) the fake trace
    counts the FLOPs, bytes and collectives of the same step on real CPU
    tensors, and the real functional collectives' buffers live at least as
    long."""
    got = []
    for fake in (True, False):
        with port_dryrun.fake_world((2, 2), device="cpu", fake_tensors=fake) as mesh:
            parts, meta = lowered(arch, kind, mesh, analysis=kind == "train")
            got.append(port_dryrun.trace_parts(parts, meta))
    (cost, coll, mems), (real_cost, real_coll, real_mems) = got
    assert real_cost == cost and real_coll == coll
    for (_, m), (_, real) in zip(mems, real_mems):
        assert real["argument_bytes"] == m["argument_bytes"]
        assert real["temp_bytes"] >= m["temp_bytes"]


def test_a_fake_trace_leaves_the_rope_table_cache_real():
    """``layers._inv_freq`` caches the RoPE table by device: built during a
    fake trace it is still a real tensor, so a later step on real tensors
    never computes with a fake one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import layers
    layers._inv_freq.cache_clear()
    with FakeTensorMode(allow_non_fake_inputs=True):
        layers.apply_rope(torch.zeros(1, 4, 2, 8), torch.arange(4), "full")
    table = layers._inv_freq(8, "full", 10000.0, torch.device("cpu"))
    assert layers._inv_freq.cache_info().hits == 1
    assert type(table) is torch.Tensor
    assert torch.equal(table, torch.from_numpy(layers.rope_freqs(8, "full", 10000.0)[1]))
