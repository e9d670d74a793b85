"""The optimizer of the PyTorch port against the JAX package's
(``repro.optim``): the LR schedule, AdamW with its float32 moments and
global-norm clip, the int8 and top-k codecs, error feedback, and
``compressed_psum`` over a gloo world of host ranks against ``shard_map``
over a forced multi-device CPU.

Both packages get the same numpy inputs.  The schedule is held to
``1e-7``; AdamW (parameters, moments, ``grad_norm``) to ``1e-6`` relative;
the int8 codec bit for bit; top-k by the set of kept values (the order of
equal magnitudes may differ between ``lax.top_k`` and ``torch.topk``);
``compressed_psum`` to the reference's output bit for bit and to the exact
sum within the reference test's ``2e-2``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_cases as cases
import repro.optim as ref_optim
import repro.optim.adamw as ref_adamw
import repro.optim.grad_compress as ref_gc
from repro.configs.base import TrainCfg as RefTrainCfg

import repro_torch.optim as port_optim
import repro_torch.optim.adamw as port_adamw
import repro_torch.optim.grad_compress as port_gc
from repro_torch.configs.base import TrainCfg as PortTrainCfg


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ schedule

SCHEDULES = [dict(lr=1.0, warmup=10, total=100),
             dict(lr=3e-4, warmup=0, total=50, min_ratio=0.0),
             dict(lr=1e-2, warmup=3, total=60),
             dict(lr=2.0, warmup=100, total=100, min_ratio=0.5)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(map(str, kw.values())))
@pytest.mark.parametrize("kind", ["tensor", "int"])
def test_cosine_warmup_matches_reference(kw, kind):
    """Steps 0-99: a 0-d int32 tensor gives a float32 0-d tensor, an int a
    Python float, both the reference's value within 1e-7."""
    want = np.array([float(ref_optim.cosine_warmup(jnp.int32(s), **kw))
                     for s in range(100)])
    if kind == "tensor":
        got = [port_optim.cosine_warmup(torch.tensor(s, dtype=torch.int32), **kw)
               for s in range(100)]
        assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
        got = np.array([float(g) for g in got])
    else:
        got = [port_optim.cosine_warmup(s, **kw) for s in range(100)]
        assert all(isinstance(g, float) for g in got)
        got = np.array(got)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)


# ------------------------------------------------------------------ AdamW

def adam_tree(seed: int) -> dict:
    """A numpy parameter tree with bf16 and float32 leaves."""
    rng = np.random.default_rng(seed)
    return {"dense": {"w": rng.standard_normal((8, 16)).astype(jnp.bfloat16),
                      "b": (0.1 * rng.standard_normal(16)).astype(np.float32)},
            "scale": (1 + 0.1 * rng.standard_normal(16)).astype(np.float32),
            "stack": rng.standard_normal((3, 4, 4)).astype(jnp.bfloat16)}


def grad_trees(tree: dict, steps: int, size: float, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{k: (grad_trees(v, 1, size, int(rng.integers(1 << 30)))[0]
                 if isinstance(v, dict) else
                 (size * rng.standard_normal(v.shape)).astype(np.float32))
             for k, v in tree.items()} for _ in range(steps)]


def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def as_port(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == jnp.bfloat16:
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr.copy())


@pytest.mark.parametrize("size,clip", [(0.01, 1.0), (10.0, 1.0), (10.0, 0.5)],
                         ids=["unclipped", "clipped", "clipped-0.5"])
@pytest.mark.parametrize("lr", [1e-2, "tensor"])
def test_adamw_update_matches_reference(size, clip, lr):
    """Three updates of a bf16 + float32 tree, the norm clipped where the
    gradients are large: parameters, float32 moments, step and grad_norm
    within 1e-6 relative of the reference's."""
    tree = adam_tree(0)
    grads = grad_trees(tree, 3, size, 1)
    ref_cfg = RefTrainCfg(grad_clip=clip, weight_decay=0.1)
    port_cfg = PortTrainCfg(grad_clip=clip, weight_decay=0.1)
    rate = 1e-2 if lr == "tensor" else lr

    params = {k: jnp.asarray(v) for k, v in flat(tree).items()}
    ref_p = {"dense": {"w": params["dense/w"], "b": params["dense/b"]},
             "scale": params["scale"], "stack": params["stack"]}
    ref_opt = ref_adamw.adamw_init(ref_p)
    port_p = {k: as_port(v) for k, v in flat(tree).items()}
    port_opt = port_adamw.adamw_init(port_p)
    assert all(m.dtype == torch.float32 for m in port_opt.m.values())
    for g in grads:
        ref_p, ref_opt, ref_m = ref_adamw.adamw_update(
            jax_tree(g), ref_opt, ref_p, ref_cfg, jnp.float32(rate))
        port_lr = torch.tensor(rate, dtype=torch.float32) if lr == "tensor" else rate
        same, port_opt, port_m = port_adamw.adamw_update(
            {k: torch.from_numpy(v) for k, v in flat(g).items()}, port_opt,
            port_p, port_cfg, port_lr)
        assert same is port_p
        np.testing.assert_allclose(float(port_m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-6)
    assert int(port_opt.step) == int(ref_opt.step) == 3
    for name, want in (("params", ref_p), ("m", ref_opt.m), ("v", ref_opt.v)):
        got = {"params": port_p, "m": port_opt.m, "v": port_opt.v}[name]
        for k, w in flat(want).items():
            assert got[k].dtype == (port_p[k].dtype if name == "params" else torch.float32)
            np.testing.assert_allclose(f32(got[k]), f32(w), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} {k}")


def jax_tree(tree: dict) -> dict:
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def test_adamw_update_counts_a_missing_gradient_as_zeros():
    """``None`` (a parameter the loss did not reach) is the reference's zero
    gradient: it adds nothing to the norm, its moments decay, and weight
    decay still moves the parameter."""
    tree = adam_tree(2)
    grads = grad_trees(tree, 2, 0.1, 3)
    for g in grads:
        g["scale"] = np.zeros_like(g["scale"])
    ref_cfg, port_cfg = RefTrainCfg(), PortTrainCfg()
    ref_p = jax_tree(tree)
    ref_opt = ref_adamw.adamw_init(ref_p)
    port_p = {k: as_port(v) for k, v in flat(tree).items()}
    port_opt = port_adamw.adamw_init(port_p)
    before = port_p["scale"].clone()
    for g in grads:
        ref_p, ref_opt, ref_m = ref_adamw.adamw_update(jax_tree(g), ref_opt, ref_p,
                                                       ref_cfg, jnp.float32(0.1))
        pg = {k: torch.from_numpy(v) for k, v in flat(g).items()}
        pg["scale"] = None
        _, port_opt, port_m = port_adamw.adamw_update(pg, port_opt, port_p,
                                                      port_cfg, 0.1)
        np.testing.assert_allclose(float(port_m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-6)
    assert not torch.equal(port_p["scale"], before)     # decayed
    for k, w in flat(ref_p).items():
        np.testing.assert_allclose(f32(port_p[k]), f32(w), rtol=1e-6, atol=1e-7)
    assert not port_opt.m["scale"].any() and not port_opt.v["scale"].any()


def test_global_norm_matches_reference():
    g = grad_trees(adam_tree(4), 1, 3.0, 5)[0]
    want = float(ref_adamw.global_norm(jax_tree(g)))
    got = port_adamw.global_norm({k: torch.from_numpy(v) for k, v in flat(g).items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    with_none = {**{k: torch.from_numpy(v) for k, v in flat(g).items()}, "x": None}
    assert float(port_adamw.global_norm(with_none)) == float(got)
    assert float(port_adamw.global_norm(list(with_none.values()))) == float(got)


# ------------------------------------------------------------------ codecs

def codec_input(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "normal":
        return rng.standard_normal(1000).astype(np.float32)
    if kind == "tiny":
        return (1e-6 * rng.standard_normal((17, 9))).astype(np.float32)
    if kind == "halves":      # g / scale lands on x.5: round half to even
        return np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 0],
                        np.float32)
    if kind == "zeros":
        return np.zeros(33, np.float32)
    if kind == "matrix":
        return rng.standard_normal((64, 48)).astype(np.float32) * 40
    raise ValueError(kind)


CODEC_INPUTS = ["normal", "tiny", "halves", "zeros", "matrix"]


@pytest.mark.parametrize("kind", CODEC_INPUTS)
def test_int8_codec_is_bit_equal(kind):
    g = codec_input(kind)
    q_ref, s_ref = ref_gc.int8_compress(jnp.asarray(g))
    q, s = port_gc.int8_compress(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    assert float(s) == float(s_ref)
    np.testing.assert_array_equal(port_gc.int8_decompress(q, s).numpy(),
                                  np.asarray(ref_gc.int8_decompress(q_ref, s_ref)))
    if kind == "halves":
        assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 0]


@pytest.mark.parametrize("kind", ["normal", "matrix", "tiny"])
@pytest.mark.parametrize("k_frac", [0.05, 0.1, 1e-9])
def test_topk_codec_keeps_the_reference_values(kind, k_frac):
    g = codec_input(kind)
    v_ref, i_ref, shape_ref = ref_gc.topk_compress(jnp.asarray(g), k_frac=k_frac)
    v, i, shape = port_gc.topk_compress(torch.from_numpy(g), k_frac=k_frac)
    assert tuple(shape) == tuple(shape_ref) and len(v) == len(v_ref)
    np.testing.assert_array_equal(np.sort(v.numpy()), np.sort(np.asarray(v_ref)))
    np.testing.assert_array_equal(
        port_gc.topk_decompress(v, i, shape).numpy(),
        np.asarray(ref_gc.topk_decompress(v_ref, i_ref, shape_ref)))


def test_topk_codec_on_ties_keeps_the_same_magnitudes():
    """Equal magnitudes may be taken in another order: the kept values'
    magnitudes are the reference's."""
    g = np.array([1, -1, 1, -1, 0.5, 2, -2, 0.25] * 4, np.float32)
    v_ref, _, _ = ref_gc.topk_compress(jnp.asarray(g), k_frac=0.25)
    v, _, _ = port_gc.topk_compress(torch.from_numpy(g), k_frac=0.25)
    np.testing.assert_array_equal(np.sort(np.abs(v.numpy())),
                                  np.sort(np.abs(np.asarray(v_ref))))


@pytest.mark.parametrize("codec", ["int8", "topk"])
@pytest.mark.parametrize("kind", ["normal", "matrix"])
def test_error_feedback_update_matches_reference(codec, kind):
    """Two rounds with the carried residual: decompressed values and
    residuals equal to the reference's, and dec + residual == g + residual
    before (the residual is exact)."""
    g = codec_input(kind)
    r_ref, r = jnp.zeros(g.shape, jnp.float32), torch.zeros(g.shape)
    for scale in (1.0, 0.3):
        dec_ref, r_ref = ref_gc.error_feedback_update(jnp.asarray(g * scale),
                                                      r_ref, codec=codec)
        total = torch.from_numpy(g * scale) + r
        dec, r = port_gc.error_feedback_update(torch.from_numpy(g * scale), r,
                                               codec=codec)
        np.testing.assert_array_equal(dec.numpy(), np.asarray(dec_ref))
        np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
        np.testing.assert_allclose((dec + r).numpy(), total.numpy(), atol=1e-5)
    with pytest.raises(ValueError):
        port_gc.error_feedback_update(torch.from_numpy(g), r, codec="fp4")


def test_compressed_psum_without_a_group_is_the_identity_up_to_quantisation():
    g = np.linspace(-1, 1, 128, dtype=np.float32)
    out = port_gc.compressed_psum(torch.from_numpy(g))
    np.testing.assert_allclose(out.numpy(), g, atol=2e-2)
    tree = port_gc.compressed_psum({"a": torch.from_numpy(g),
                                    "b": [torch.from_numpy(-g)]})
    np.testing.assert_array_equal(tree["a"].numpy(), out.numpy())
    np.testing.assert_array_equal(tree["b"][0].numpy(), -out.numpy())


@pytest.fixture(scope="module")
def psum_worlds(tmp_path_factory):
    """One gloo world of 2 host ranks and the reference on a forced
    2-device CPU, both summing ``cases.psum_grads(2)``."""
    port, ref = cases.run_job("psum", str(tmp_path_factory.mktemp("psum")),
                              worlds=(2,))
    return port[2], ref[2]


@pytest.mark.parametrize("leaf", ["w", "b", "s"])
def test_compressed_psum_over_two_ranks_matches_reference(psum_worlds, leaf):
    port, ref = psum_worlds
    exact = sum(g[leaf] for g in cases.psum_grads(2))
    np.testing.assert_array_equal(port[leaf], ref[leaf])
    scale = max(np.abs(g[leaf]).max() for g in cases.psum_grads(2))
    np.testing.assert_allclose(port[leaf], exact, atol=2e-2 * scale)


def test_optim_exports_the_reference_names():
    assert port_optim.__all__ == ref_optim.__all__
    for name in port_optim.__all__:
        assert hasattr(port_optim, name), name
    assert port_gc.__all__ == ref_gc.__all__
    assert set(ref_adamw.__all__) <= set(port_adamw.__all__)
