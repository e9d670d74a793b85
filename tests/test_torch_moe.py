"""The MoE and MLA serving path of the PyTorch port against the JAX package:
``moe_capacity``, ``moe_apply`` (capacity drops included), ``mla_apply`` with
and without its latent cache, and the whole ``dbrx_132b`` and
``deepseek_v2_lite_16b`` SMOKE models through ``forward``, ``prefill``,
``decode_step`` and ``serve_batch``, plus ``convert`` and ``make_batch``.

Both packages get the same numpy inputs and weights (``test_torch_lm``'s
seeded parameter tree, handed to the port through
``convert.lm_params_from_arrays``).  float32 is held to ``rtol=1e-4,
atol=1e-5`` with every routing decision equal; bfloat16 to ``atol=0.15,
rtol=0.05``.  Top-k routing is discontinuous: through a whole bfloat16
model the two packages' one-ulp differences can flip a near-tie, and the
flipped token then takes other experts.  So a whole-model bfloat16 check
compares the routing of every layer first (``gate_idx`` and the kept
slots), holds the rows whose routing agreed in every layer to the
tolerance, and bounds the share of routing decisions that differ."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.pipeline as ref_data
import repro.launch.serve as ref_serve
import repro.models.attention as ref_attn
import repro.models.moe as ref_moe
import repro.models.registry as ref_registry
import repro.models.transformer as ref_T
from repro.configs.base import MoECfg as RefMoECfg

import repro_torch.data.pipeline as port_data
import repro_torch.launch.serve as port_serve
import repro_torch.models.attention as port_attn
import repro_torch.models.moe as port_moe
import repro_torch.models.registry as port_registry
import repro_torch.models.transformer as port_T
from repro_torch import convert
from repro_torch.configs.base import MoECfg
from repro_torch.train import make_serve_step

from test_torch_lm import (BATCH_KEYS, FP32, _jitted, as_dtype, both_batches,
                           close, f32, np_x, random_tree, tol)

MOE_ARCHS = ["dbrx_132b", "deepseek_v2_lite_16b"]
# The share of (token, choice) routing decisions of a whole bfloat16 SMOKE
# model allowed to differ from the reference's (near-ties flipped by one-ulp
# differences, and the slots shifted behind them).
BF16_FLIP_SHARE = 0.05


def configs(arch: str, dtype: str, **changes):
    """(reference config, port config) of ``arch``'s SMOKE in ``dtype``."""
    return tuple(dataclasses.replace(reg.get_smoke_config(arch), dtype=dtype,
                                     **changes)
                 for reg in (ref_registry, port_registry))


def both_params(arch: str, dtype: str, seed: int = 0, **changes):
    ref_cfg, port_cfg = configs(arch, dtype, **changes)
    tree = random_tree(ref_cfg, seed)
    return (ref_cfg, jax.tree.map(jnp.asarray, tree), port_cfg,
            convert.lm_params_from_arrays(tree, port_cfg, device="cpu"))


def ample(cfg):
    """``cfg`` with capacity_factor 8: no drops, so that prefill and decode
    route alike (drops legitimately depend on T)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            capacity_factor=8.0))


# ------------------------------------------------------------------ capacity

@pytest.mark.parametrize("T", [1, 7, 64, 333, 4096])
@pytest.mark.parametrize("E,k", [(4, 1), (8, 2), (16, 4), (64, 6)])
@pytest.mark.parametrize("cf", [0.01, 1.0, 1.25, 8.0])
def test_moe_capacity_matches_reference(T, E, k, cf):
    got = port_moe.moe_capacity(T, MoECfg(E, k, 16, capacity_factor=cf))
    want = ref_moe.moe_capacity(T, RefMoECfg(E, k, 16, capacity_factor=cf))
    assert got == want and got % 8 == 0 and got >= 8
    assert type(got) is int


# ------------------------------------------------------------------ MoE block

G, T_TOK, D, E4, K2, F_EXP = 2, 64, 32, 4, 2, 48


def moe_pair(dtype: str, kind: str, n_shared: int, cf: float, seed: int = 0):
    """(reference params, port MoE, reference cfg, port cfg) from one numpy
    tree (router float32, experts and shared MLP in ``dtype``)."""
    ref_cfg = RefMoECfg(E4, K2, F_EXP, n_shared=n_shared, capacity_factor=cf)
    port_cfg = MoECfg(E4, K2, F_EXP, n_shared=n_shared, capacity_factor=cf)
    shapes = jax.eval_shape(lambda: ref_moe.moe_init(
        jax.random.PRNGKey(0), D, ref_cfg, mlp_kind=kind, dtype=getattr(jnp, dtype)))
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        z = rng.standard_normal(node.shape).astype(np.float32) / np.sqrt(node.shape[-2])
        return z.astype(node.dtype)

    tree = fill(shapes)
    port = port_moe.moe_init(None, D, port_cfg, mlp_kind=kind,
                             dtype=getattr(torch, dtype), device="cpu")
    named = dict(port.named_parameters())
    flat = {"/".join(str(p.key) for p in path): leaf for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert sorted(named) == sorted(k.replace("/", ".") for k in flat)
    with torch.no_grad():
        for key, leaf in flat.items():
            named[key.replace("/", ".")].copy_(convert._leaf_tensor(leaf))
    return jax.tree.map(jnp.asarray, tree), port, ref_cfg, port_cfg


def ref_route(p, x, cfg):
    """The reference's routing of x, as ``repro.models.moe.moe_apply`` makes
    it: (gate_idx, keep), each (G, T, k)."""
    G_, T_, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"]["w"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    oh = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    ohf = jnp.moveaxis(oh, 2, 1).reshape(G_, k * T_, E)
    pos = jnp.moveaxis((jnp.cumsum(ohf, axis=1) - ohf).reshape(G_, k, T_, E), 1, 2)
    pos = (pos * oh).sum(-1)
    return np.asarray(gate_idx), np.asarray(pos < ref_moe.moe_capacity(T_, cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("cf", [0.01, 1.25, 8.0])
def test_moe_apply_matches_reference(dtype, kind, n_shared, cf):
    """y and aux, with the same routing and drops (cf 0.01: capacity 8 of a
    load of 32 a expert; 1.25: a few drops; 8.0: none); the rows whose every
    choice was dropped are exactly zero in both, or the shared MLP alone."""
    ref_p, port_p, ref_cfg, port_cfg = moe_pair(dtype, kind, n_shared, cf)
    xj, xt = as_dtype(np_x(11, G, T_TOK, D), dtype)
    want, want_aux = ref_moe.moe_apply(ref_p, xj, ref_cfg, mlp_kind=kind)
    with torch.no_grad():
        got, aux = port_moe.moe_apply(port_p, xt, port_cfg, mlp_kind=kind)
        _, _, gate_idx, _, keep = port_moe._route(port_p, xt, port_cfg)
    want_idx, want_keep = ref_route(ref_p, xj, ref_cfg)
    np.testing.assert_array_equal(gate_idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert got.dtype == xt.dtype and aux.dtype == torch.float32
    close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(want_aux), **FP32)
    dropped = ~keep.numpy().any(-1)                       # (G, T): all dropped
    if cf == 0.01:
        assert dropped.sum() >= 16
    if cf == 8.0:
        assert keep.all()
    if n_shared:
        with torch.no_grad():
            shared = port_p.shared(xt)
        assert torch.equal(got[torch.from_numpy(dropped)],
                           shared[torch.from_numpy(dropped)])
    else:
        zero = ~np.asarray(want, np.float32).any(-1)
        np.testing.assert_array_equal(~got.float().numpy().any(-1), zero)
        np.testing.assert_array_equal(zero, dropped)


def test_choice_major_order_decides_which_token_is_dropped():
    """Ten tokens, two experts, both chosen by every token, capacity 8.
    Tokens 0-7 choose expert 0 first, tokens 8-9 expert 1.  Choice-major
    order fills expert 1 with the first choices of tokens 8-9, then the
    second choices of tokens 0-7, so tokens 6 and 7 lose their second
    choice (and 8, 9 theirs, past expert 0's eighth slot); token-major
    order would drop the first choices of tokens 8 and 9 instead."""
    cfg = MoECfg(2, 2, 8, capacity_factor=0.01)
    ref_cfg = RefMoECfg(2, 2, 8, capacity_factor=0.01)
    d = 4
    rng = np.random.default_rng(0)
    x = np.zeros((1, 10, d), np.float32)
    x[0, :8, 0] = 1.0
    x[0, 8:, 1] = 1.0
    router = np.array([[2.0, 1.0], [1.0, 2.0], [0, 0], [0, 0]], np.float32)
    wg, wu = (rng.standard_normal((2, d, 8)).astype(np.float32) for _ in range(2))
    wd = rng.standard_normal((2, 8, d)).astype(np.float32)
    ref_p = {"router": {"w": jnp.asarray(router)}, "wg": jnp.asarray(wg),
             "wu": jnp.asarray(wu), "wd": jnp.asarray(wd)}
    port_p = port_moe.moe_init(None, d, cfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, value in (("router.w", router), ("wg", wg), ("wu", wu), ("wd", wd)):
            dict(port_p.named_parameters())[name].copy_(torch.from_numpy(value))
        xt = torch.from_numpy(x)
        _, gate_vals, gate_idx, pos, keep = port_moe._route(port_p, xt, cfg)
        got, _ = port_moe.moe_apply(port_p, xt, cfg)
    want_keep = np.ones((10, 2), bool)
    want_keep[6:, 1] = False
    np.testing.assert_array_equal(gate_idx[0, :, 0].numpy(), [0] * 8 + [1] * 2)
    np.testing.assert_array_equal(keep[0].numpy(), want_keep)
    np.testing.assert_array_equal(pos[0, 8:, 0].numpy(), [0, 1])
    # token-major order would keep (6, 1), (7, 1) and drop (8, 0), (9, 0)
    token_major = np.cumsum(np.eye(2, dtype=int)[gate_idx[0].reshape(-1).numpy()],
                            axis=0)[np.arange(20), gate_idx[0].reshape(-1).numpy()] - 1
    assert not np.array_equal(token_major.reshape(10, 2) < 8, want_keep)
    # y_t = sum over the kept choices of gate * FFN_e(x_t), token by token
    want = np.zeros((10, d), np.float32)
    for t in range(10):
        for j in range(2):
            if want_keep[t, j]:
                e = int(gate_idx[0, t, j])
                h = x[0, t] @ wg[e]
                h = h / (1 + np.exp(-h)) * (x[0, t] @ wu[e])
                want[t] += float(gate_vals[0, t, j]) * (h @ wd[e])
    np.testing.assert_allclose(got[0].numpy(), want, **FP32)
    ref_y, _ = ref_moe.moe_apply(ref_p, jnp.asarray(x), ref_cfg)
    close(got, ref_y)


def test_moe_init_draws_the_reference_scales_and_layout():
    """router float32 normal/sqrt(d), wg/wu normal/sqrt(d), wd
    normal/sqrt(f), the shared MLP of width n_shared·f; wg kept under gelu."""
    cfg = MoECfg(8, 2, 256, n_shared=2)
    gen = torch.Generator().manual_seed(0)
    p = port_moe.moe_init(gen, 128, cfg, mlp_kind="gelu", device="cpu")
    ref = jax.eval_shape(lambda: ref_moe.moe_init(
        jax.random.PRNGKey(0), 128, RefMoECfg(8, 2, 256, n_shared=2), mlp_kind="gelu"))
    assert p.router.w.dtype == torch.float32 and p.wg.dtype == torch.bfloat16
    for name, want_std in (("router.w", 128 ** -0.5), ("wg", 128 ** -0.5),
                           ("wu", 128 ** -0.5), ("wd", 256 ** -0.5)):
        w = dict(p.named_parameters())[name]
        leaf = ref["router"]["w"] if name == "router.w" else ref[name]
        assert tuple(w.shape) == leaf.shape and str(w.dtype)[6:] == str(leaf.dtype)
        assert abs(float(w.detach().float().std()) / want_std - 1) < 0.05, name
    assert tuple(p.shared.wu.w.shape) == ref["shared"]["wu"]["w"].shape == (128, 512)
    assert not hasattr(p.shared, "wg")


# ------------------------------------------------------------------ MLA

def mla_kwargs(cfg) -> dict:
    m = cfg.mla
    return {"n_heads": cfg.n_heads, "kv_lora": m.kv_lora_rank, "nope": m.qk_nope_dim,
            "rope": m.qk_rope_dim, "v_dim": m.v_head_dim, "rope_theta": cfg.rope_theta}


def mla_pair(dtype: str, **changes):
    ref_cfg, ref_p, port_cfg, port_p = both_params("deepseek_v2_lite_16b", dtype,
                                                   seed=3, **changes)
    return (ref_cfg, jax.tree.map(lambda a: a[0], ref_p["layers"])["attn"],
            port_cfg, port_p.layers[0].attn)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_chunk", [None, 4])
def test_mla_apply_without_cache_matches_reference(dtype, q_chunk):
    ref_cfg, ref_p, port_cfg, port_p = mla_pair(dtype)
    xj, xt = as_dtype(np_x(9, 2, 12, ref_cfg.d_model), dtype)
    want, _ = ref_attn.mla_apply(ref_p, xj, q_chunk=q_chunk, **mla_kwargs(ref_cfg))
    with torch.no_grad():
        got, cache = port_attn.mla_apply(port_p, xt, q_chunk=q_chunk,
                                         **mla_kwargs(port_cfg))
    assert cache is None and got.dtype == xt.dtype
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_with_cache_matches_reference(dtype):
    """A prefill of 6, then two one-token steps, into a latent cache of 10:
    outputs and both cache tensors after each write."""
    ref_cfg, ref_p, port_cfg, port_p = mla_pair(dtype)
    m, dt = ref_cfg.mla, getattr(jnp, dtype)
    ref_c = ref_attn.mla_init_cache(2, 10, m.kv_lora_rank, m.qk_rope_dim, dt)
    port_c = port_attn.mla_init_cache(2, 10, m.kv_lora_rank, m.qk_rope_dim,
                                      getattr(torch, dtype), "cpu")
    assert {k: tuple(v.shape) for k, v in port_c.items()} == \
        {k: v.shape for k, v in ref_c.items()}
    x = np_x(10, 2, 8, ref_cfg.d_model)
    for pos0, t in ((0, 6), (6, 1), (7, 1)):
        xj, xt = as_dtype(x[:, pos0:pos0 + t], dtype)
        want, ref_c = ref_attn.mla_apply(ref_p, xj, cache=ref_c, pos0=pos0,
                                         **mla_kwargs(ref_cfg))
        with torch.no_grad():
            got, port_c = port_attn.mla_apply(port_p, xt, cache=port_c, pos0=pos0,
                                              **mla_kwargs(port_cfg))
        close(got, want, dtype)
        for name in ("ckv", "krope"):
            close(port_c[name], ref_c[name], dtype)
    with torch.no_grad(), pytest.raises(ValueError, match="KV cache overflow"):
        port_attn.mla_apply(port_p, xt.expand(2, 3, -1), cache=port_c, pos0=8,
                            **mla_kwargs(port_cfg))


def test_mla_kv_norm_and_rope_ignore_the_model_norm_and_rope_mode():
    """Under ``norm="layernorm"`` and ``rope_mode="half"`` the layer norms
    are layernorms, but ``kv_norm`` stays a bias-free RMSNorm and the rope
    parts rotate in full: the reference's tree converts, and the whole model
    agrees with the reference."""
    ref_cfg, ref_p, port_cfg, port_p = both_params(
        "deepseek_v2_lite_16b", "float32", seed=4, norm="layernorm", rope_mode="half")
    layer = port_p.layers[0]
    assert layer.ln1.bias is not None and layer.attn.kv_norm.bias is None
    assert "bias" not in ref_p["layers"]["attn"]["kv_norm"]
    bj, bt = both_batches(ref_cfg, 2, 12, seed=5)
    want, _ = ref_T.forward(ref_p, bj, ref_cfg)
    with torch.no_grad():
        got, _ = port_T.forward(port_p, bt, port_cfg)
    close(got, want)


# ------------------------------------------------------------------ whole model

@contextlib.contextmanager
def routing_log(monkeypatch):
    """Records the routing of every MoE call of both packages, in call order:
    ``{"ref": [(gate_idx, keep), ...], "port": [...]}``.  The reference must
    run eagerly (``scan_layers=False``, not jitted) for its values to be
    concrete."""
    log = {"ref": [], "port": []}
    ref_apply, port_apply = ref_moe.moe_apply, port_moe.moe_apply

    def ref_rec(p, x, cfg, **kw):
        log["ref"].append(ref_route(p, x, cfg))
        return ref_apply(p, x, cfg, **kw)

    def port_rec(p, x, cfg, **kw):
        _, _, gate_idx, _, keep = port_moe._route(p, x, cfg)
        log["port"].append((gate_idx.numpy(), keep.numpy()))
        return port_apply(p, x, cfg, **kw)

    monkeypatch.setattr(ref_moe, "moe_apply", ref_rec)
    monkeypatch.setattr(port_moe, "moe_apply", port_rec)
    yield log
    monkeypatch.setattr(ref_moe, "moe_apply", ref_apply)
    monkeypatch.setattr(port_moe, "moe_apply", port_apply)


def routing_agreement(log, start: int = 0):
    """(rows (B, T) whose routing agreed in every layer of the calls from
    ``start`` on, the share of (token, choice) decisions that differ)."""
    ref, port = log["ref"][start:], log["port"][start:]
    assert len(ref) == len(port) > 0
    same = np.ones(ref[0][0].shape[:2], bool)
    differ = total = 0
    for (ri, rk), (pi, pk) in zip(ref, port):
        d = (ri != pi) | (rk != pk)
        same &= ~d.any(-1)
        differ += int(d.sum())
        total += d.size
    return same, differ / total


def check_rows(got, want, dtype: str, rows) -> None:
    """``got`` against ``want`` on the (B, T) rows selected by ``rows``."""
    g, w = f32(got), f32(want)
    np.testing.assert_allclose(g[rows], w[rows], **tol(dtype))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(arch, dtype, monkeypatch):
    """Hidden states and the aux loss (summed over layers) of the whole
    SMOKE model, with the routing of every layer compared first."""
    ref_cfg, ref_p, port_cfg, port_p = both_params(arch, dtype)
    bj, bt = both_batches(ref_cfg, 2, 24, seed=1)
    with routing_log(monkeypatch) as log:
        want, want_aux = ref_T.forward(ref_p, bj, ref_cfg, scan_layers=False)
        with torch.no_grad():
            got, aux = port_T.forward(port_p, bt, port_cfg)
    assert len(log["port"]) == ref_cfg.n_layers
    same, flipped = routing_agreement(log)
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    assert aux.dtype == torch.float32 and float(aux) > 0
    if dtype == "float32":
        assert flipped == 0
        close(got, want)
        np.testing.assert_allclose(float(aux), float(want_aux), **FP32)
    else:
        assert flipped <= BF16_FLIP_SHARE and same.mean() >= 0.5
        check_rows(got, want, dtype, same)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=0.05)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(arch, dtype, monkeypatch):
    """A prefill, then 4 decode steps of the reference's greedy tokens:
    logits and (float32) the whole stacked cache after each step.  In
    bfloat16 a batch row is held while its routing has agreed so far."""
    ref_cfg, ref_p, port_cfg, port_p = both_params(arch, dtype, seed=2)
    seq, steps = 12, 4
    bj, bt = both_batches(ref_cfg, 2, seq, seed=4)
    ref_c = ref_T.init_cache(ref_cfg, 2, seq + steps + 2)
    port_c = port_T.init_cache(port_cfg, 2, seq + steps + 2, device="cpu")
    assert {k: tuple(v.shape) for k, v in port_c.items()} == \
        {k: v.shape for k, v in ref_c.items()}
    step = make_serve_step(port_cfg)
    # float32 runs the reference jitted (no routing to record: every value
    # is held to the tolerance), bfloat16 eagerly with its routing recorded
    eager = dtype == "bfloat16"
    fns = ({"prefill": lambda p, b, c: ref_T.prefill(p, b, ref_cfg, c,
                                                     scan_layers=False),
            "decode": lambda p, c, t, pos: ref_T.decode_step(
                p, c, t, pos, ref_cfg, scan_layers=False)}
           if eager else _jitted(ref_cfg))
    with routing_log(monkeypatch) if eager else contextlib.nullcontext() as log:
        want, ref_c = fns["prefill"](ref_p, bj, ref_c)
        with torch.no_grad():
            got, port_c = port_T.prefill(port_p, bt, port_cfg, port_c)
        rows, flips, start = np.ones(2, bool), [], 0
        for i in range(steps + 1):
            tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
            if not eager:
                close(got, want)
                for name in port_c:
                    close(port_c[name], ref_c[name])
                np.testing.assert_array_equal(torch.argmax(got, -1).numpy(), tok)
            else:
                same, share = routing_agreement(log, start)
                start = len(log["port"])
                rows &= same.all(-1)
                flips.append(share)
                check_rows(got, want, dtype, rows)
            if i == steps:
                break
            want, ref_c = fns["decode"](ref_p, ref_c, jnp.asarray(tok),
                                        jnp.int32(seq + i))
            with torch.no_grad():
                got, port_c = step(port_p, port_c, torch.from_numpy(tok), seq + i)
    if eager:
        assert max(flips) <= BF16_FLIP_SHARE and rows.any()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_then_decode_equals_forward_in_the_port(arch):
    """The port's own modes agree at capacity_factor 8 (the reference's own
    test's setting): forward == prefill == prefill(S-1) + decode_step."""
    _, _, cfg, params = both_params(arch, "float32", seed=5)
    cfg = ample(cfg)
    _, b = both_batches(cfg, 2, 10, seed=6)
    S = 10
    with torch.no_grad():
        hidden, _ = port_T.forward(params, b, cfg)
        full = port_T.logits_fn(params, hidden[:, -1:], cfg)[:, 0]
        pf, _ = port_T.prefill(params, b, cfg,
                               port_T.init_cache(cfg, 2, S + 2, device="cpu"))
        cache = port_T.init_cache(cfg, 2, S + 2, device="cpu")
        _, cache = port_T.prefill(params, {"tokens": b["tokens"][:, :-1]}, cfg, cache)
        dec, _ = port_T.decode_step(params, cache, b["tokens"][:, -1], S - 1, cfg)
    close(pf, full)
    close(dec, full)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_batch_matches_reference(arch, monkeypatch):
    """``serve_batch`` of both packages on the reference's own weights
    (float32 SMOKE configs): equal greedy tokens."""
    def fp32(registry):
        return lambda a: dataclasses.replace(registry.get_smoke_config(a),
                                             dtype="float32")

    monkeypatch.setattr(ref_serve, "get_smoke_config", fp32(ref_registry))
    monkeypatch.setattr(port_serve, "get_smoke_config", fp32(port_registry))

    def reference_weights(gen, cfg, device=None):
        tree = jax.tree.map(np.asarray, ref_T.init_params(jax.random.PRNGKey(0), cfg))
        return convert.lm_params_from_arrays(tree, cfg, device=device)

    monkeypatch.setattr(port_T, "init_params", reference_weights)
    kw = {"batch": 2, "prompt_len": 16, "gen": 6, "seed": 0}
    want, want_stats = ref_serve.serve_batch(arch, **kw)
    got, stats = port_serve.serve_batch(arch, device="cpu", **kw)
    assert got.shape == want.shape == (2, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert sorted(stats) == sorted(want_stats)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_entry_points_default_to_the_card(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_registry.get_smoke_config(arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_T.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_T.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.serve_batch(arch, batch=1, prompt_len=4, gen=1)


# ------------------------------------------------------------------ weights, data

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_params_from_arrays_is_bit_exact_in_bf16(arch):
    """Every leaf fills one parameter bit for bit: stacked experts, the
    float32 router, the shared MLP, MLA's leaves."""
    ref_cfg, port_cfg = configs(arch, "bfloat16")
    tree = random_tree(ref_cfg, seed=7)
    model = convert.lm_params_from_arrays(tree, port_cfg, device="cpu")
    got = dict(model.named_parameters())
    flat = {"/".join(str(p.key) for p in path): leaf for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert len(got) == sum(v.shape[0] if k.startswith("layers/") else 1
                           for k, v in flat.items())
    for key, leaf in flat.items():
        parts = key.split("/")
        for i in (range(ref_cfg.n_layers) if parts[0] == "layers" else [None]):
            name = ".".join(parts if i is None else ["layers", str(i)] + parts[1:])
            want = leaf if i is None else leaf[i]
            param = got[name]
            if want.dtype == np.float32:
                assert param.dtype == torch.float32, name
                np.testing.assert_array_equal(param.detach().numpy(), want)
            else:
                np.testing.assert_array_equal(param.view(torch.int16).numpy(),
                                              want.view(np.int16))
    assert got["layers.0.moe.router.w"].dtype == torch.float32
    assert got["layers.0.moe.wg"].shape == (port_cfg.moe.n_experts, port_cfg.d_model,
                                            port_cfg.moe.d_expert)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("seed,step,shard,hosts", BATCH_KEYS)
def test_make_batch_is_bit_equal(arch, seed, step, shard, hosts):
    cfg = ref_registry.get_smoke_config(arch)
    want = ref_data.make_batch(cfg, 4, 24, seed=seed, step=step,
                               host_shard=shard, n_hosts=hosts)
    got = port_data.make_batch(port_registry.get_smoke_config(arch), 4, 24,
                               seed=seed, step=step, host_shard=shard,
                               n_hosts=hosts, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
