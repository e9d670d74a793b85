"""xLSTM and Zamba2 serving in the PyTorch port against the JAX package: the
mLSTM, sLSTM and Mamba2 blocks in every mode (no cache, a prefill into a
cache, a T = 1 decode step, each from a carried state that is not zero), the
chunked SSD and mLSTM at several chunk lengths, the whole xLSTM and Zamba2
``SMOKE`` models (forward, prefill, decode, caches), ``serve_batch`` token for
token, and the converter's list and (n_groups, g) paths.

Both packages get the same seeded numpy weights (``test_torch_lm.fill_tree``,
at scales that keep gates and decays unsaturated) and inputs; a carried state
is the reference's own state after a random prefix.  float32 is held to
``rtol=1e-4, atol=1e-5``, bfloat16 to the reference's ``atol=0.15,
rtol=0.05``.  The reference's model entry points are jitted once per
config."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as ref_serve
import repro.models.registry as ref_registry
import repro.models.ssm as ref_ssm
import repro.models.transformer as ref_T
import repro.models.xlstm as ref_xlstm

import repro_torch.launch.serve as port_serve
import repro_torch.models.registry as port_registry
import repro_torch.models.ssm as port_ssm
import repro_torch.models.transformer as port_T
import repro_torch.models.xlstm as port_xlstm
from repro_torch import convert
from repro_torch.train import make_serve_step

from test_torch_lm import (BF16, _fp32_smoke, both_batches, close, configs,
                           f32, fill_tree, random_tree)

ARCHS = ["xlstm_125m", "zamba2_7b"]
DTYPES = ["float32", "bfloat16"]
MODES = ["none", "prefill", "decode"]
D, H, HD = 64, 2, 32          # one block: d_model, heads, head dim
B, T, PREFIX = 2, 16, 8


def np_x(seed: int, shape, dtype: str) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        jnp.dtype(dtype))


def to_port(tree):
    """A numpy tree -> CPU tensors of the same structure."""
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_port(v) for v in tree]
    return convert._leaf_tensor(np.asarray(tree))


def load(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Fill ``module``'s parameters from the numpy ``tree`` by name."""
    with torch.no_grad():
        for name, param in module.named_parameters():
            leaf = functools.reduce(lambda node, k: node[k], name.split("."), tree)
            param.copy_(convert._leaf_tensor(np.asarray(leaf)))
    return module


def leaves(tree) -> list:
    """The leaves of a cache in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def close_caches(got, want, dtype: str = "float32") -> None:
    """Leaf by leaf: shapes, dtypes (recurrent states float32, KV rows in
    the model's dtype) and values, element by element — but for the float32
    states of a bfloat16 model, against the leaf's scale: max|got - want| <=
    0.05·max|want| + 0.15.  Those states sum bf16 products of a residual
    stream that grows over the blocks (Mamba2 has no pre-norm), so an
    element that cancels to near zero carries the rounding of its terms, as
    far from the reference's bf16 state as that is from its float32 one."""
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        if dtype == "bfloat16" and a.dtype == torch.float32:
            err, scale = np.abs(f32(a) - f32(b)).max(), np.abs(f32(b)).max()
            assert err <= BF16["rtol"] * scale + BF16["atol"], (err, scale)
        else:
            close(a, b, dtype)


# ------------------------------------------------------------------ blocks

def ssm_cfg(chunk: int = 8):
    return dataclasses.replace(ref_registry.get_smoke_config("zamba2_7b").ssm,
                               chunk=chunk)


def block(kind: str, dtype: str):
    """(reference apply, port apply, reference cache init, port cache
    init), each apply taking (x, cache) — over the same numpy weights."""
    dt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    key = jax.random.PRNGKey(0)
    if kind == "mlstm":
        shapes = jax.eval_shape(lambda: ref_xlstm.mlstm_init(key, D, H, HD, dt))
        kw = {"n_heads": H, "hd": HD, "chunk": 8}
        port = port_xlstm.MLSTM(D, H, HD, tdt, "cpu")
        ref_fn, port_fn = ref_xlstm.mlstm_apply, port_xlstm.mlstm_apply
        ref_c = lambda: ref_xlstm.mlstm_init_cache(B, H, HD)
        port_c = lambda: port_xlstm.mlstm_init_cache(B, H, HD, "cpu")
    elif kind == "slstm":
        shapes = jax.eval_shape(lambda: ref_xlstm.slstm_init(key, D, H, HD, dt))
        kw = {"n_heads": H, "hd": HD}
        port = port_xlstm.SLSTM(D, H, HD, tdt, "cpu")
        ref_fn, port_fn = ref_xlstm.slstm_apply, port_xlstm.slstm_apply
        ref_c = lambda: ref_xlstm.slstm_init_cache(B, H, HD)
        port_c = lambda: port_xlstm.slstm_init_cache(B, H, HD, "cpu")
    else:
        cfg = ssm_cfg()
        shapes = jax.eval_shape(lambda: ref_ssm.mamba2_init(key, D, cfg, dt))
        port = port_ssm.Mamba2(D, cfg, tdt, "cpu")
        ref_fn = lambda p, x, cache=None: ref_ssm.mamba2_apply(p, x, cfg, cache=cache)
        port_fn = lambda p, x, cache=None: port_ssm.mamba2_apply(p, x, cfg,
                                                                 cache=cache)
        kw = {}
        ref_c = lambda: ref_ssm.mamba2_init_cache(B, D, cfg)
        port_c = lambda: port_ssm.mamba2_init_cache(B, D, cfg, device="cpu")
    tree = fill_tree(shapes, np.random.default_rng(3))
    ref_p = jax.tree.map(jnp.asarray, tree)
    load(port, tree)
    return (lambda x, cache: ref_fn(ref_p, x, cache=cache, **kw),
            lambda x, cache: port_fn(port, x, cache=cache, **kw), ref_c, port_c)


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "mamba2"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_block_matches_reference(kind, dtype, mode):
    """One block's output and new state, leaf by leaf: without a cache (T =
    16, two chunks), a prefill of T = 16 into a cache and a T = 1 decode step,
    both from the reference's state after an 8-token prefix."""
    ref_fn, port_fn, ref_c, port_c = block(kind, dtype)
    n = {"none": T, "prefill": T, "decode": 1}[mode]
    x = np_x(1, (B, n, D), dtype)
    if mode == "none":
        want, no_cache = ref_fn(jnp.asarray(x), None)
        with torch.no_grad():
            got, port_cache = port_fn(to_port(x), None)
        assert no_cache is None and port_cache is None
    else:
        _, state = ref_fn(jnp.asarray(np_x(2, (B, PREFIX, D), dtype)), ref_c())
        state = jax.tree.map(np.asarray, state)
        assert all(np.abs(a).max() > 0 for a in leaves(state))
        close_caches(port_c(), ref_c())          # mLSTM's m at -1e30, the rest 0
        port_cache = to_port(state)
        want, want_cache = ref_fn(jnp.asarray(x), jax.tree.map(jnp.asarray, state))
        with torch.no_grad():
            got, got_cache = port_fn(to_port(x), port_cache)
        assert got_cache is port_cache          # updated in place
        close_caches(got_cache, want_cache, dtype)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    close(got, want, dtype)


@pytest.mark.parametrize("chunk", [1, 2, 4, 8])
def test_ssd_chunked_at_any_chunk_equals_one_chunk(chunk):
    """``_ssd_chunked`` at chunk lengths dividing T against one chunk of the
    whole T, and against the reference's at the same chunk; from a state that
    is not zero."""
    rng = np.random.default_rng(chunk)
    Hh, P, N = 3, 4, 5
    xh = rng.standard_normal((B, T, Hh, P)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, T, N)).astype(np.float32) for _ in range(2))
    dt = rng.uniform(0.05, 0.6, (B, T, Hh)).astype(np.float32)
    A = rng.uniform(0.2, 2.0, Hh).astype(np.float32)
    h0 = rng.standard_normal((B, Hh, P, N)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (xh, Bm, Cm, dt, A)]
    y, h = port_ssm._ssd_chunked(*args, chunk, torch.from_numpy(h0))
    y1, h1 = port_ssm._ssd_chunked(*args, T, torch.from_numpy(h0))
    close(y, y1)
    close(h, h1)
    want_y, want_h = ref_ssm._ssd_chunked(xh, Bm, Cm, dt, A, chunk, h0)
    close(y, want_y)
    close(h, want_h)


@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_mlstm_at_any_chunk_equals_one_chunk(chunk):
    """The chunkwise mLSTM at chunk lengths dividing T against one chunk of
    the whole T, from a carried state."""
    shapes = jax.eval_shape(lambda: ref_xlstm.mlstm_init(
        jax.random.PRNGKey(0), D, H, HD, jnp.float32))
    p = load(port_xlstm.MLSTM(D, H, HD, torch.float32, "cpu"),
             fill_tree(shapes, np.random.default_rng(3)))
    x = torch.from_numpy(np_x(4, (B, T, D), "float32"))
    state = port_xlstm.mlstm_init_cache(B, H, HD, "cpu")
    with torch.no_grad():
        port_xlstm.mlstm_apply(p, torch.from_numpy(np_x(5, (B, PREFIX, D), "float32")),
                               n_heads=H, hd=HD, chunk=8, cache=state)
        outs = [port_xlstm.mlstm_apply(p, x, n_heads=H, hd=HD, chunk=c,
                                       cache={k: v.clone() for k, v in state.items()})
                for c in (chunk, T)]
    close(outs[0][0], outs[1][0])
    for name in state:
        close(outs[0][1][name], outs[1][1][name])


@pytest.mark.parametrize("kind", ["mlstm", "mamba2"])
def test_chunked_blocks_refuse_a_sequence_their_chunk_does_not_divide(kind):
    """T = 12 at chunk 8: the reference asserts, the port raises."""
    ref_fn, port_fn, _, _ = block(kind, "float32")
    x = np_x(6, (B, 12, D), "float32")
    with pytest.raises(AssertionError, match="must divide"):
        ref_fn(jnp.asarray(x), None)
    with torch.no_grad(), pytest.raises(ValueError, match="must divide"):
        port_fn(to_port(x), None)


# ------------------------------------------------------------------ whole model

@functools.lru_cache(maxsize=None)
def jitted(cfg):
    """The reference's entry points for ``cfg``, jitted once (cfg static)."""
    return {
        "forward": jax.jit(lambda p, b: ref_T.forward(p, b, cfg)),
        "prefill": jax.jit(lambda p, b, c: ref_T.prefill(p, b, cfg, c)),
        "decode": jax.jit(lambda p, c, t, pos: ref_T.decode_step(p, c, t, pos, cfg)),
    }


@functools.lru_cache(maxsize=None)
def both_params(arch: str, dtype: str, seed: int = 0, norm: str = "rmsnorm"):
    ref_cfg, port_cfg = (dataclasses.replace(c, norm=norm)
                         for c in configs(arch, dtype))
    tree = random_tree(ref_cfg, seed)
    return (ref_cfg, jax.tree.map(jnp.asarray, tree), port_cfg,
            convert.lm_params_from_arrays(tree, port_cfg, device="cpu"))


def _forward_both(arch: str, dtype: str, norm: str = "rmsnorm"):
    ref_cfg, ref_p, port_cfg, port_p = both_params(arch, dtype, norm=norm)
    bj, bt = both_batches(ref_cfg, B, 32, seed=1)
    want, want_aux = jitted(ref_cfg)["forward"](ref_p, bj)
    with torch.no_grad():
        got, aux = port_T.forward(port_p, bt, port_cfg)
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    assert float(aux) == float(want_aux) == 0.0
    close(got, want, dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_reference(arch, dtype):
    """Hidden states of the whole SMOKE model, two chunks of 16."""
    _forward_both(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_out_norms_stay_rmsnorm_under_a_layernorm_config(arch):
    """With ``norm="layernorm"`` the pre-norms and the final norm are
    LayerNorms, and every mLSTM / sLSTM / Mamba2 ``out_norm`` an RMSNorm, as
    in the reference (float32)."""
    _forward_both(arch, "float32", norm="layernorm")
    _, _, _, port_p = both_params(arch, "float32", norm="layernorm")
    kinds = {name: m.kind for name, m in port_p.named_modules()
             if isinstance(m, port_T.Norm)}
    assert {k for n, k in kinds.items() if n.endswith("out_norm")} == {"rmsnorm"}
    assert {k for n, k in kinds.items() if not n.endswith("out_norm")} == {"layernorm"}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_reference(arch, dtype):
    """A prefill of 16, then 6 decode steps of the reference's greedy tokens:
    logits and every leaf of the cache after each step (Zamba2's padded block
    keeps its zero state); in float32 the port's greedy tokens are the
    reference's."""
    ref_cfg, ref_p, port_cfg, port_p = both_params(arch, dtype, seed=2)
    fns = jitted(ref_cfg)
    seq, steps = 16, 6
    bj, bt = both_batches(ref_cfg, B, seq, seed=4)
    ref_c = ref_T.init_cache(ref_cfg, B, seq + steps + 2)
    port_c = port_T.init_cache(port_cfg, B, seq + steps + 2, device="cpu")
    close_caches(port_c, ref_c)
    want, ref_c = fns["prefill"](ref_p, bj, ref_c)
    with torch.no_grad():
        got, port_c = port_T.prefill(port_p, bt, port_cfg, port_c)
    step = make_serve_step(port_cfg)
    for i in range(steps + 1):
        close(got, want, dtype)
        close_caches(port_c, ref_c, dtype)
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        if dtype == "float32":
            np.testing.assert_array_equal(torch.argmax(got, -1).numpy(), tok)
        if i == steps:
            break
        want, ref_c = fns["decode"](ref_p, ref_c, jnp.asarray(tok),
                                    jnp.int32(seq + i))
        with torch.no_grad():
            got, port_c = step(port_p, port_c, torch.from_numpy(tok), seq + i)
    if arch == "zamba2_7b":
        assert not port_c["mamba"]["ssm"][-1, -1].any()     # the padded block


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_forward_in_the_port(arch):
    """The port's own modes agree: forward == prefill == prefill(S-1) +
    decode_step at the last position (float32)."""
    _, _, cfg, params = both_params(arch, "float32", seed=5)
    S = 16
    _, b = both_batches(cfg, B, S, seed=6)
    with torch.no_grad():
        hidden, _ = port_T.forward(params, b, cfg)
        full = port_T.logits_fn(params, hidden[:, -1:], cfg)[:, 0]
        pf, _ = port_T.prefill(params, b, cfg,
                               port_T.init_cache(cfg, B, S, device="cpu"))
        cache = port_T.init_cache(cfg, B, S, device="cpu")
        _, cache = port_T.prefill(params, {"tokens": b["tokens"][:, :-1]}, cfg, cache)
        dec, _ = port_T.decode_step(params, cache, b["tokens"][:, -1], S - 1, cfg)
    close(pf, full)
    close(dec, full)


def test_padded_blocks_are_skipped():
    """Zamba2's last group pads 5 blocks to 6: NaN weights in the padded
    block change nothing, in the port as in the reference."""
    ref_cfg, _, port_cfg, _ = both_params("zamba2_7b", "float32")
    tree = random_tree(ref_cfg, seed=0)
    for name, leaf in tree["mamba"].items():
        for arr in (leaf,) if not isinstance(leaf, dict) else leaf.values():
            arr[-1, -1] = np.nan
    bj, bt = both_batches(ref_cfg, B, 16, seed=1)
    want, _ = jitted(ref_cfg)["forward"](jax.tree.map(jnp.asarray, tree), bj)
    with torch.no_grad():
        got, _ = port_T.forward(convert.lm_params_from_arrays(tree, port_cfg,
                                                              device="cpu"),
                                bt, port_cfg)
    assert np.isfinite(f32(got)).all()
    close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_refuses_a_prompt_the_chunk_does_not_divide(arch):
    """T = 24 at SMOKE (chunk 16): the reference asserts, the port raises."""
    ref_cfg, ref_p, port_cfg, port_p = both_params(arch, "float32")
    bj, bt = both_batches(ref_cfg, 1, 24, seed=1)
    with pytest.raises(AssertionError, match="must divide"):
        ref_T.forward(ref_p, bj, ref_cfg)
    with torch.no_grad(), pytest.raises(ValueError, match="must divide"):
        port_T.forward(port_p, bt, port_cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_matches_reference(arch, monkeypatch):
    """``serve_batch`` of both packages on the reference's own weights
    (float32 SMOKE configs): equal greedy tokens, the same stats keys."""
    monkeypatch.setattr(ref_serve, "get_smoke_config", _fp32_smoke(ref_registry))
    monkeypatch.setattr(port_serve, "get_smoke_config", _fp32_smoke(port_registry))

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


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_default_to_the_card(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_registry.get_smoke_config(arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_T.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_T.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.serve_batch(arch, batch=1, prompt_len=4, gen=1)


# ------------------------------------------------------------------ weights

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_arrays_is_bit_exact_in_bf16(arch):
    """Every leaf fills one parameter bit for bit: xLSTM's list of blocks,
    the hybrid's (n_groups, g) Mamba2 leaves (padded block included) and its
    shared block."""
    ref_cfg, port_cfg = configs(arch, "bfloat16")
    tree = random_tree(ref_cfg, seed=7)
    model = convert.lm_params_from_arrays(tree, port_cfg, device="cpu")
    got = dict(model.named_parameters())

    def bits(t):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()

    if arch == "xlstm_125m":
        pairs = [("blocks.1.core.r", tree["blocks"][1]["core"]["r"]),
                 ("blocks.0.core.wi.w", tree["blocks"][0]["core"]["wi"]["w"]),
                 ("blocks.1.ln.scale", tree["blocks"][1]["ln"]["scale"])]
    else:
        m = tree["mamba"]
        pairs = [("mamba.2.1.in_proj.w", m["in_proj"]["w"][2, 1]),
                 ("mamba.1.0.conv_w", m["conv_w"][1, 0]),
                 ("mamba.0.1.A_log", m["A_log"][0, 1]),
                 ("shared.attn.wq.w", tree["shared"]["attn"]["wq"]["w"]),
                 ("shared.mlp.wd.w", tree["shared"]["mlp"]["wd"]["w"])]
    for name, want in pairs:
        assert got[name].dtype == (torch.bfloat16 if want.dtype.name == "bfloat16"
                                   else torch.float32), name
        np.testing.assert_array_equal(
            bits(got[name].detach()),
            want.view(np.int16) if want.dtype.name == "bfloat16" else want)
    n_ref = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_ref


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_arrays_refuses_a_tree_of_another_shape(arch):
    """A missing leaf (in a list or in the shared block), an extra one, and a
    stack of the wrong group count are refused."""
    ref_cfg, port_cfg = configs(arch, "float32")
    tree = random_tree(ref_cfg)

    def edited(fn):
        copy = jax.tree.map(lambda a: a, tree)
        fn(copy)
        return copy

    if arch == "xlstm_125m":
        missing = edited(lambda t: t["blocks"][1]["core"].pop("r"))
        extra = edited(lambda t: t["blocks"][0]["core"].update(extra=np.zeros(3)))
        short = edited(lambda t: t["blocks"].pop())
        where, short_error = "blocks/1/core/r", (KeyError, "blocks/1")
    else:
        missing = edited(lambda t: t["shared"].pop("mlp"))
        extra = edited(lambda t: t["mamba"].update(extra=np.zeros((3, 2))))
        short = edited(lambda t: t["mamba"].update(
            D=t["mamba"]["D"][:-1]))
        where, short_error = "shared/mlp", (ValueError, "stacked layers")
    with pytest.raises(KeyError, match=where):
        convert.lm_params_from_arrays(missing, port_cfg, device="cpu")
    with pytest.raises(KeyError, match="no parameter"):
        convert.lm_params_from_arrays(extra, port_cfg, device="cpu")
    with pytest.raises(short_error[0], match=short_error[1]):
        convert.lm_params_from_arrays(short, port_cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_the_reference_structure_and_scales(arch):
    """The reference's tree, shapes and dtypes; denses normal / sqrt(d_in),
    ``conv_w`` normal * 0.2, sLSTM's ``r`` normal / sqrt(hd); ``A_log``,
    ``D``, ``dt_bias``, ``conv_b`` and norm scales the reference's constants;
    the same seed the same weights."""
    cfg = port_registry.get_smoke_config(arch)
    model = port_T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref_p = ref_T.init_params(jax.random.PRNGKey(0), cfg)
    ref_tree = jax.tree.map(np.asarray, ref_p)
    port_tree = convert.lm_params_from_arrays(ref_tree, cfg, device="cpu")
    names = [n for n, _ in port_tree.named_parameters()]
    assert names == [n for n, _ in model.named_parameters()]
    reference = dict(port_tree.named_parameters())
    for name, p in model.named_parameters():
        want = reference[name]
        assert p.shape == want.shape and p.dtype == want.dtype, name
        leaf = name.split(".")[-1]
        v = p.detach().float()
        if leaf in ("A_log", "D", "dt_bias", "conv_b", "scale"):
            close(p.detach(), want.detach())
        elif leaf in ("w", "conv_w", "r"):
            std = {"w": 1 / np.sqrt(p.shape[0]), "conv_w": 0.2,
                   "r": 1 / np.sqrt(cfg.hd)}[leaf]
            assert abs(float(v.std()) / std - 1) < 0.25, name
    same = port_T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(same.lm_head.w, model.lm_head.w)
