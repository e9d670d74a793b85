"""The sharding rules of the PyTorch port (``repro_torch.models.sharding``)
against the JAX package's (``repro.models.sharding``): every case of
``tests/test_sharding.py`` as a parity case, then every parameter and cache
tensor of the 11 registered SMOKE archs, ``sanitize_pspecs`` on the 16x16
and 2x16x16 meshes of the reference's tests, ``embed_dshard``, and the
port's own layer on a ``DeviceMesh``: placements, ``distribute_whole``,
``constrain_batch``, ``make_local_mesh``.

The port's specs are tuples with the reference's ``PartitionSpec`` entries,
by parameter name; a stacked reference leaf (every layer of a family on
leading axes) gives each of its parameters the spec without those axes,
which must be replicated.  Equal means equal tuples."""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import repro.models.registry as ref_registry
import repro.models.sharding as ref_sh
import repro.models.transformer as ref_T
import repro_torch.models.registry as port_registry
import repro_torch.models.sharding as port_sh
import repro_torch.models.transformer as port_T

ARCHS = list(ref_registry.ARCH_IDS)


def flat_with_path(tree) -> dict:
    """The reference tree's leaves by ``/``-joined path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = leaf
    return out


def flat_specs(tree) -> dict:
    """A tree of reference ``PartitionSpec``s by path (a spec is a leaf)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = leaf
    return out


def port_flat(tree, prefix="") -> dict:
    """A port tree (dicts and lists) of specs or tensors by ``/``-joined
    path; a spec tuple is a leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(port_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def port_model(arch: str):
    cfg = port_registry.get_smoke_config(arch)
    return cfg, port_T.TransformerLM(cfg, device="cpu")


def ref_param_specs(arch: str) -> tuple[dict, dict]:
    """(specs, shapes) of the reference's stacked tree, by path."""
    cfg = ref_registry.get_smoke_config(arch)
    shapes = jax.eval_shape(lambda: ref_T.init_params(jax.random.PRNGKey(0), cfg))
    return flat_specs(ref_sh.param_pspecs(shapes)), flat_with_path(shapes)


class FakeMesh:
    """The reference tests' stand-in for a production mesh."""

    def __init__(self, axes, shape):
        self.axis_names = axes
        self.devices = np.empty(shape, object)


# ------------------------------------------- tests/test_sharding.py cases

def test_param_rules_dense_match_reference():
    """``test_param_rules_dense``: qwen2.5 SMOKE's projections, bias, table
    and norm."""
    _, model = port_model("qwen2_5_3b")
    fs = port_sh.param_pspecs(model)
    ref, _ = ref_param_specs("qwen2_5_3b")
    assert fs["layers.0.attn.wq.w"][-1] == "model"
    assert fs["layers.0.attn.wo.w"][-2] == "model"
    assert fs["layers.0.attn.wo.w"][-1] == "data"
    assert fs["layers.0.attn.wq.b"] == (None,) == tuple(ref["layers/attn/wq/b"])[1:]
    assert fs["embed.table"] == ("model", None) == tuple(ref["embed/table"])
    assert all(x is None for x in fs["layers.1.ln1.scale"])
    for name, path in (("layers.0.attn.wq.w", "layers/attn/wq/w"),
                       ("layers.1.attn.wo.w", "layers/attn/wo/w")):
        assert fs[name] == tuple(ref[path])[1:]


def test_param_rules_moe_match_reference():
    """``test_param_rules_moe``: dbrx SMOKE's expert banks over "model", the
    router replicated."""
    _, model = port_model("dbrx_132b")
    fs = port_sh.param_pspecs(model)
    ref, _ = ref_param_specs("dbrx_132b")
    assert fs["layers.0.moe.wg"][0] == "model" == ref["layers/moe/wg"][1]
    assert fs["layers.0.moe.wd"][0] == "model" == ref["layers/moe/wd"][1]
    assert fs["layers.0.moe.router.w"] == (None, None)
    assert ref["layers/moe/router/w"] == P(None, None, None)


def test_cache_rules_match_reference():
    """``test_cache_rules``: internlm2's stacked (L, B, S, KV, hd) cache,
    batch over "data", sequence over "model"."""
    cfg = port_registry.get_smoke_config("internlm2_1_8b")
    fs = port_sh.cache_pspecs(port_T.init_cache(cfg, 4, 64, device="cpu"))
    assert fs["k"] == (None, "data", "model", None, None)
    ref = ref_sh.cache_pspecs(jax.eval_shape(
        lambda: ref_T.init_cache(ref_registry.get_smoke_config("internlm2_1_8b"), 4, 64)))
    assert fs["k"] == tuple(ref["k"]) and fs["v"] == tuple(ref["v"])


def test_batch_specs_pod_axes_match_reference():
    batch = {"tokens": torch.zeros((8, 16), dtype=torch.int32)}
    specs = port_sh.batch_pspecs(batch, have_pod=True)
    want = ref_sh.batch_pspecs({"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32)},
                               have_pod=True)
    assert specs["tokens"][0] == ("pod", "data")
    assert specs["tokens"] == tuple(want["tokens"])
    assert port_sh.batch_pspecs(batch)["tokens"] == ("data", None)


def test_sanitize_drops_indivisible_axes_matches_reference():
    """``test_sanitize_drops_indivisible_axes`` on the 16x16 mesh."""
    specs = {"w": ("data", "model"), "v": ("model",), "ok": (None, "model")}
    shapes = {"w": torch.empty(8, 32), "v": torch.empty(504), "ok": torch.empty(4, 64)}
    out = port_sh.sanitize_pspecs(specs, shapes, FakeMesh(("data", "model"), (16, 16)))
    assert out == {"w": (None, "model"), "v": (None,), "ok": (None, "model")}
    ref = ref_sh.sanitize_pspecs(
        {k: P(*v) for k, v in specs.items()},
        {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32) for k, v in shapes.items()},
        FakeMesh(("data", "model"), (16, 16)))
    assert out == {k: tuple(v) for k, v in ref.items()}


def test_sanitize_tuple_axes_prefix_matches_reference():
    """``test_sanitize_tuple_axes_prefix`` on the 2x16x16 mesh: a batch of
    32 keeps ("pod", "data"), one of 16 the prefix "pod"."""
    mesh = FakeMesh(("pod", "data", "model"), (2, 16, 16))
    specs = {"a": (("pod", "data"),), "b": (("pod", "data"),)}
    shapes = {"a": torch.empty(32, 4), "b": torch.empty(16, 4)}
    out = port_sh.sanitize_pspecs(specs, shapes, mesh)
    assert out["a"][0] == ("pod", "data") and out["b"][0] == "pod"
    ref = ref_sh.sanitize_pspecs(
        {k: P(*v) for k, v in specs.items()},
        {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32) for k, v in shapes.items()},
        mesh)
    assert out == {k: tuple(v) for k, v in ref.items()}


def test_constrain_batch_is_the_identity_outside_a_mesh():
    """``test_constrain_batch_noop_outside_mesh``, and with sequence
    sharding on."""
    x = torch.ones((4, 8, 16))
    assert port_sh.current_mesh() is None
    assert port_sh.constrain_batch(x) is x
    port_sh.set_seq_shard(True)
    try:
        assert port_sh.constrain_batch(x) is x
    finally:
        port_sh.set_seq_shard(False)
    np.testing.assert_array_equal(np.asarray(ref_sh.constrain_batch(jnp.ones((4, 8, 16)))),
                                  x.numpy())


# ---------------------------------------------------- every SMOKE arch

@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_of_every_parameter_match_the_stacked_reference(arch):
    """Each parameter's spec is the reference's at its stacked leaf without
    the stacked dimensions (which are replicated), and every reference
    leaf is some parameter's."""
    cfg, model = port_model(arch)
    ref, shapes = ref_param_specs(arch)
    got = port_sh.param_pspecs(model)
    assert list(got) == [k for k, _ in model.named_parameters()]
    seen = set()
    for name, p in model.named_parameters():
        path, _, lead = port_T.stacked_leaf(name, cfg)
        key = "/".join(path)
        want = tuple(ref[key]) + (None,) * (len(shapes[key].shape) - len(ref[key]))
        assert tuple(shapes[key].shape) == tuple(lead) + tuple(p.shape), name
        assert want[:len(lead)] == (None,) * len(lead), key
        assert got[name] == want[len(lead):], (name, got[name], want)
        seen.add(key)
    assert seen == set(ref)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", [(("data", "model"), (16, 16)),
                                  (("pod", "data", "model"), (2, 16, 16))])
def test_sanitized_pspecs_match_reference(arch, mesh):
    """``sanitize_pspecs`` of every parameter's spec on the production
    meshes, against the reference's of the stacked leaf (an axis the
    stacked dimensions cannot take is never dropped there)."""
    cfg, model = port_model(arch)
    ref, shapes = ref_param_specs(arch)
    fake = FakeMesh(*mesh)
    have_pod = "pod" in mesh[0]
    got = port_sh.sanitize_pspecs(port_sh.param_pspecs(model, have_pod), model, fake)
    want = flat_specs(ref_sh.sanitize_pspecs(
        ref_sh.param_pspecs(jax.eval_shape(
            lambda: ref_T.init_params(jax.random.PRNGKey(0),
                                      ref_registry.get_smoke_config(arch))), have_pod),
        jax.eval_shape(lambda: ref_T.init_params(jax.random.PRNGKey(0),
                                                 ref_registry.get_smoke_config(arch))),
        fake))
    for name in got:
        path, _, lead = port_T.stacked_leaf(name, cfg)
        assert got[name] == tuple(want["/".join(path)])[len(lead):], name


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_reference(arch):
    """Every cache tensor's spec, in the cache's structure."""
    cfg = port_registry.get_smoke_config(arch)
    got = port_flat(port_sh.cache_pspecs(port_T.init_cache(cfg, 2, 16, device="cpu")))
    rc = ref_registry.get_smoke_config(arch)
    want = flat_specs(ref_sh.cache_pspecs(jax.eval_shape(
        lambda: ref_T.init_cache(rc, 2, 16))))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k] == tuple(w), k


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "llava_next_mistral_7b"])
def test_embed_dshard_matches_reference(arch):
    """Inference lowerings flip the table to (None, "model")."""
    cfg, model = port_model(arch)
    got = port_sh.embed_dshard(port_sh.param_pspecs(model), model)
    ref, shapes = ref_param_specs(arch)
    rc = ref_registry.get_smoke_config(arch)
    params = jax.eval_shape(lambda: ref_T.init_params(jax.random.PRNGKey(0), rc))
    want = flat_specs(ref_sh.embed_dshard(ref_sh.param_pspecs(params), params))
    assert got["embed.table"] == (None, "model") == tuple(want["embed/table"])
    for name in got:
        path, _, lead = port_T.stacked_leaf(name, cfg)
        assert got[name] == tuple(want["/".join(path)])[len(lead):], name


class NamedAxes:
    mesh_dim_names = ("data", "model")


@pytest.mark.parametrize("spec,want", [
    ((None, None), ("R", "R")),
    (("data", "model"), ("S0", "S1")),
    (("model", "data"), ("S1", "S0")),
    (("model", None), ("R", "S0")),
    ((None, ("data", "model")), ("S1", "S1")),
    ((), ("R", "R")),
    ((("pod", "data"), None), ("S0", "R")),
])
def test_placements_of_a_spec(spec, want):
    """A mesh axis on tensor dimension d is ``Shard(d)``; two axes on one
    dimension shard it twice, in mesh order; an axis the mesh lacks is
    ignored."""
    got = port_sh.placements(spec, NamedAxes())
    short = tuple("R" if p.is_replicate() else f"S{p.dim}" for p in got)
    assert short == want


def test_placements_refuse_axes_out_of_mesh_order():
    with pytest.raises(ValueError, match="mesh's order"):
        port_sh.placements((("model", "data"),), NamedAxes())


# ------------------------------------------------------- on a DeviceMesh

@pytest.fixture(scope="module")
def one_rank_world():
    """A gloo world of this process alone, taken down after the module."""
    from repro_torch.launch.mesh import init_multihost
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_multihost(f"127.0.0.1:{port}", 1, 0, device_type="cpu")
    yield
    dist.destroy_process_group()


def test_make_local_mesh_spans_the_world(one_rank_world):
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.mesh.shape) == (1, 1)
    for data, model in ((2, 1), (1, 2), (0, 1)):
        with pytest.raises(ValueError, match="spans the whole world"):
            make_local_mesh(data, model, device_type="cpu")


def test_distribute_whole_and_constrain_batch_on_a_mesh(one_rank_world):
    """A whole tensor laid out by placements and gathered back; inside the
    mesh context ``constrain_batch`` leaves plain tensors, and a DTensor
    whose data axes have extent 1, as they are (the reference's no-op)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(device_type="cpu")
    x = torch.arange(24.0).reshape(4, 6)
    d = port_sh.distribute_whole(x, mesh, port_sh.placements(("data", "model"), mesh))
    assert isinstance(d, DTensor) and tuple(d.shape) == (4, 6)
    assert torch.equal(d.full_tensor(), x)
    with port_sh.use_mesh(mesh):
        assert port_sh.current_mesh() is mesh
        assert port_sh.constrain_batch(x) is x
        assert port_sh.constrain_batch(d) is d
        assert port_sh.data_ranks() == 1
        assert port_sh.data_mean(x) is x
    assert port_sh.current_mesh() is None


def test_reshard_lays_out_dtensors_for_specs_past_the_rows(one_rank_world):
    """``runtime.elastic.reshard``: a spec that splits a later dimension, or
    one dimension over two axes, or placements, give DTensors; a row split
    and None keep the FFT runtime's plain blocks; ``dtensor=True`` lays out
    every leaf with a spec, a None spec staying plain; a module's
    parameters become DTensor parameters in place; ``gather_whole`` undoes
    each."""
    from torch import nn
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime.elastic import gather_whole, reshard
    mesh = make_local_mesh(device_type="cpu")
    x = torch.arange(12.0).reshape(3, 4)
    tree = {"col": x, "two": x, "placed": x, "rows": x, "whole": x}
    specs = {"col": (None, "model"), "two": (("data", "model"), None),
             "placed": (Shard(1), Replicate()), "rows": ("data", None), "whole": None}
    out = reshard(tree, mesh, specs)
    assert {k for k, v in out.items() if isinstance(v, DTensor)} == {"col", "two", "placed"}
    assert out["col"].placements == (Replicate(), Shard(1))
    assert out["two"].placements == (Shard(0), Shard(0))
    back = gather_whole(out, mesh, specs)
    assert all(torch.equal(v, x) and not isinstance(v, DTensor) for v in back.values())
    laid = reshard({"a": x, "step": torch.tensor(3)}, mesh,
                   {"a": (None, None), "step": None}, dtensor=True)
    assert isinstance(laid["a"], DTensor) and not isinstance(laid["step"], DTensor)
    model = nn.Linear(4, 3)
    w = model.weight.detach().clone()
    assert reshard(model, mesh, {"weight": ("model", "data"), "bias": (None,)}) is model
    assert isinstance(model.weight, nn.Parameter) and isinstance(model.weight, DTensor)
    assert model.weight.placements == (Shard(1), Shard(0))
    assert torch.equal(gather_whole(model, mesh, {"weight": None, "bias": None})["weight"], w)
