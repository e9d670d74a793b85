"""The LM serving path of the PyTorch port against the JAX package: configs,
registry, the synthetic stream, every layer, the whole model of each dense,
vlm and audio ``SMOKE`` config and ``serve_batch``.

Both packages get the same numpy inputs and the same weights: a seeded
numpy parameter tree in the reference's layout (layers stacked on a leading
axis, norm scales and biases drawn too, so that none of them is a no-op),
handed to the reference as ``jnp`` arrays and to the port through
``convert.lm_params_from_arrays``.  float32 is held to ``rtol=1e-4,
atol=1e-5``; bfloat16 to the reference's own ``atol=0.15, rtol=0.05``
(``tests/test_models.py``).  The reference's model functions are jitted
once per config, as ``repro.launch.serve`` runs them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.configs as ref_configs
import repro.configs.paper_fft as ref_paper_fft
import repro.data.pipeline as ref_data
import repro.launch.serve as ref_serve
import repro.models.attention as ref_attn
import repro.models.layers as ref_layers
import repro.models.registry as ref_registry
import repro.models.transformer as ref_T

import repro_torch.configs as port_configs
import repro_torch.configs.paper_fft as port_paper_fft
import repro_torch.data.pipeline as port_data
import repro_torch.launch.serve as port_serve
import repro_torch.models.attention as port_attn
import repro_torch.models.layers as port_layers
import repro_torch.models.registry as port_registry
import repro_torch.models.transformer as port_T
from repro_torch import convert
from repro_torch.train import make_serve_step

DECODERS = ["internlm2_1_8b", "qwen2_5_3b", "chatglm3_6b", "stablelm_3b",
            "llava_next_mistral_7b"]
TF_ARCHS = DECODERS + ["hubert_xlarge"]
FP32 = {"rtol": 1e-4, "atol": 1e-5}
BF16 = {"rtol": 0.05, "atol": 0.15}


def tol(dtype: str) -> dict:
    return FP32 if dtype == "float32" else BF16


def configs(arch: str, dtype: str):
    """(reference config, port config) of ``arch``'s SMOKE in ``dtype``."""
    return (dataclasses.replace(ref_registry.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(port_registry.get_smoke_config(arch), dtype=dtype))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, dtype: str = "float32") -> None:
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


# ------------------------------------------------------------------ weights

def _leaf(rng, name: str, shape, dtype) -> np.ndarray:
    """A leaf named ``name`` at a scale that leaves none of its gates, decays
    or norms a no-op or saturated: a dense's ``w`` (and an MoE's experts)
    normal / sqrt(d_in); the sLSTM's recurrent ``r`` normal / sqrt(hd), as
    drawn by the reference; norm ``scale`` 1 + 0.1·normal; biases
    (``b``, ``bias``, Mamba2's ``conv_b``) 0.1·normal; Mamba2's ``conv_w``
    0.2·normal; ``A_log`` the log of uniform(0.05, 0.5), ``dt_bias`` -1 +
    0.5·normal and ``D`` 1 + 0.3·normal, so that a step decays the state by
    exp(-dt·A) ≈ 0.9 (the reference's A of 1 ... 16 forgets it in a step or
    two); anything else (embeddings) normal."""
    z = rng.standard_normal(shape).astype(np.float32)
    if name in ("w", "wg", "wu", "wd", "r"):   # a dense's, an MoE's experts, sLSTM's
        z = z / np.sqrt(shape[-2])
    elif name == "scale":
        z = 1.0 + 0.1 * z
    elif name in ("b", "bias", "conv_b"):
        z = 0.1 * z
    elif name == "conv_w":
        z = 0.2 * z
    elif name == "A_log":
        z = np.log(rng.uniform(0.05, 0.5, shape)).astype(np.float32)
    elif name == "dt_bias":
        z = -1.0 + 0.5 * z
    elif name == "D":
        z = 1.0 + 0.3 * z
    return z.astype(dtype)


def fill_tree(shapes, rng, name: str = ""):
    """Numpy leaves (``_leaf``) for a tree of shapes — nested dicts and
    lists, as ``jax.eval_shape`` gives them — drawn from ``rng`` in order."""
    if isinstance(shapes, dict):
        return {k: fill_tree(v, rng, k) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [fill_tree(v, rng, name) for v in shapes]
    return _leaf(rng, name, shapes.shape, shapes.dtype)


def random_tree(cfg, seed: int = 0) -> dict:
    """A numpy parameter tree of the reference's structure (dicts, and the
    xLSTM's list of blocks), shapes and dtypes."""
    shapes = jax.eval_shape(lambda: ref_T.init_params(jax.random.PRNGKey(0), cfg))
    return fill_tree(shapes, np.random.default_rng(seed))


def both_params(arch: str, dtype: str, seed: int = 0):
    ref_cfg, port_cfg = configs(arch, dtype)
    tree = random_tree(ref_cfg, seed)
    return (ref_cfg, jax.tree.map(jnp.asarray, tree), port_cfg,
            convert.lm_params_from_arrays(tree, port_cfg, device="cpu"))


def both_batches(cfg, batch: int, seq: int, seed: int):
    """The same numpy prompt (tokens; patches in front for vision; features
    and a mask for audio) as ``jnp`` and as CPU tensors."""
    rng = np.random.default_rng(seed)
    host = {}
    if cfg.modality == "audio":
        host["features"] = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
        host["mask"] = rng.random((batch, seq)) < 0.2
    else:
        text = seq - (cfg.n_prefix_embeds if cfg.modality == "vision" else 0)
        host["tokens"] = rng.integers(0, cfg.vocab, (batch, text)).astype(np.int32)
        if cfg.modality == "vision":
            host["patches"] = rng.standard_normal(
                (batch, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v) for k, v in host.items()})


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_configs_equal_field_for_field(arch):
    for getter in ("get_config", "get_smoke_config"):
        ref = getattr(ref_registry, getter)(arch)
        port = getattr(port_registry, getter)(arch)
        assert type(port).__name__ == type(ref).__name__
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (port.hd, port.supports_decode(), port.subquadratic()) == \
            (ref.hd, ref.supports_decode(), ref.subquadratic())


def test_shapes_train_config_and_paper_workload_equal():
    assert port_configs.__all__ == ref_configs.__all__
    assert {k: dataclasses.asdict(v) for k, v in port_configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert dataclasses.asdict(port_configs.TrainCfg()) == \
        dataclasses.asdict(ref_configs.TrainCfg())
    for name in ("MLACfg", "SSMCfg", "XLSTMCfg", "HybridCfg"):
        assert dataclasses.asdict(getattr(port_configs, name)()) == \
            dataclasses.asdict(getattr(ref_configs, name)())
    assert dataclasses.asdict(port_configs.MoECfg(8, 2, 64)) == \
        dataclasses.asdict(ref_configs.MoECfg(8, 2, 64))
    public = [n for n in vars(ref_paper_fft) if n.isupper()]
    assert public and all(getattr(port_paper_fft, n) == getattr(ref_paper_fft, n)
                          for n in public)


def test_registry_and_aliases_match():
    assert port_registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert port_registry._ALIASES == ref_registry._ALIASES
    for alias, arch in ref_registry._ALIASES.items():
        assert dataclasses.asdict(port_registry.get_config(alias)) == \
            dataclasses.asdict(ref_registry.get_config(arch))
    for reg in (ref_registry, port_registry):
        with pytest.raises(KeyError, match="unknown arch"):
            reg.get_config("gpt2")


# ------------------------------------------------------------------ data

BATCH_KEYS = [(0, 0, 0, 1), (3, 7, 0, 1), (5, 2, 1, 2)]


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "llava_next_mistral_7b",
                                  "hubert_xlarge"])
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
        w = np.asarray(want[k])
        assert got[k].device.type == "cpu"
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w)


def test_make_batch_refuses_a_ragged_host_split_and_needs_a_card(monkeypatch):
    cfg = port_registry.get_smoke_config("qwen2_5_3b")
    for mod, kw in ((ref_data, {}), (port_data, {"device": "cpu"})):
        with pytest.raises(ValueError, match="not divisible"):
            mod.make_batch(cfg, 3, 8, seed=0, step=0, n_hosts=2, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_data.make_batch(cfg, 2, 8, seed=0, step=0)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "llava_next_mistral_7b",
                                  "hubert_xlarge"])
def test_synthetic_pipeline_stream_is_bit_equal(arch):
    cfg = ref_registry.get_smoke_config(arch)
    ref = ref_data.SyntheticTokenPipeline(cfg, 4, 20, seed=11)
    port = port_data.SyntheticTokenPipeline(port_registry.get_smoke_config(arch),
                                            4, 20, seed=11, device="cpu")
    for _ in range(3):
        want, got = ref.next(), port.next()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert port.state_dict() == ref.state_dict() == {"step": 3, "seed": 11}
    ref.load_state_dict({"step": 1, "seed": 11})
    port.load_state_dict({"step": 1, "seed": 11})
    want, got = ref.next(), port.next()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------------ layers

def np_x(seed: int, *shape: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def as_dtype(x: np.ndarray, dtype: str):
    """(jnp, torch) copies of ``x`` in ``dtype``, bf16 rounded once."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(getattr(torch, dtype))
    return j, t


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm_matches_reference(kind, dtype):
    d = 48
    p = port_layers.norm_init(d, kind, device="cpu")
    with torch.no_grad():
        p.scale.copy_(torch.from_numpy(1 + 0.1 * np_x(1, d)))
        if kind == "layernorm":
            p.bias.copy_(torch.from_numpy(0.1 * np_x(2, d)))
    ref_p = {"scale": jnp.asarray(p.scale.detach().numpy())}
    if kind == "layernorm":
        ref_p["bias"] = jnp.asarray(p.bias.detach().numpy())
    xj, xt = as_dtype(3 + 2 * np_x(0, 2, 5, d), dtype)
    want = ref_layers.apply_norm(ref_p, xj, kind)
    with torch.no_grad():
        got = port_layers.apply_norm(p, xt, kind)
        assert torch.equal(p(xt), got)
    assert got.dtype == getattr(torch, dtype) and p.scale.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want),
                               **(FP32 if dtype == "float32" else
                                  {"rtol": 2 ** -7, "atol": 2 ** -7}))


@pytest.mark.parametrize("mode", ["full", "half", "partial25", "none"])
@pytest.mark.parametrize("hd", [16, 24, 128])
def test_rope_freqs_are_the_reference_float32_table(mode, hd):
    n_ref, inv_ref = ref_layers.rope_freqs(hd, mode, 10000.0)
    n_port, inv_port = port_layers.rope_freqs(hd, mode, 10000.0)
    assert n_port == n_ref and inv_port.dtype == inv_ref.dtype == np.float32
    np.testing.assert_array_equal(inv_port, inv_ref)


@pytest.mark.parametrize("mode", ["full", "half", "partial25", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos0", [0, 37])
def test_apply_rope_matches_reference(mode, dtype, pos0):
    """Interleaved pairs of the first n_rot dims; the rest passes through."""
    xj, xt = as_dtype(np_x(4, 2, 6, 3, 24), dtype)
    want = ref_layers.apply_rope(xj, pos0 + jnp.arange(6), mode, 500.0)
    got = port_layers.apply_rope(xt, pos0 + torch.arange(6), mode, 500.0)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(f32(got), f32(want),
                               **(FP32 if dtype == "float32" else
                                  {"rtol": 2 ** -7, "atol": 2 ** -7}))
    n_rot, _ = port_layers.rope_freqs(24, mode)
    assert torch.equal(got[..., n_rot:], xt[..., n_rot:])


def test_apply_rope_rotates_interleaved_pairs_not_halves():
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0                        # the pair (0, 1) rotates together
    got = port_layers.apply_rope(x, torch.tensor([1]), "full", 10000.0)
    np.testing.assert_allclose(got[0, 0, 0].numpy(),
                               [np.cos(1.0), np.sin(1.0), 0.0, 0.0], atol=1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mlp_matches_reference(kind, dtype):
    d, d_ff = 32, 96
    gen = torch.Generator().manual_seed(0)
    p = port_layers.mlp_init(gen, d, d_ff, kind, getattr(torch, dtype), "cpu")
    ref_p = {name: {"w": jnp.asarray(f32(getattr(p, name).w)).astype(dtype)}
             for name in (("wg", "wu", "wd") if kind == "swiglu" else ("wu", "wd"))}
    xj, xt = as_dtype(np_x(5, 2, 7, d), dtype)
    want = ref_layers.apply_mlp(ref_p, xj, kind)
    with torch.no_grad():
        got = port_layers.apply_mlp(p, xt, kind)
    close(got, want, dtype)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    exact = F.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tanh, want, rtol=1e-6, atol=1e-6)
    assert np.abs(exact - want).max() > 1e-4


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_len", [None, 9])
@pytest.mark.parametrize("q_chunk", [None, 4, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_matches_reference(causal, kv_len, q_chunk, dtype):
    """GQA grouping (H = 4 over KV = 2), the causal and kv_len masks, and the
    q_chunk split (5 does not divide Tq = 8: one block)."""
    qj, qt = as_dtype(np_x(6, 2, 8, 4, 16), dtype)
    kj, kt = as_dtype(np_x(7, 2, 12, 2, 16), dtype)
    vj, vt = as_dtype(np_x(8, 2, 12, 2, 16), dtype)
    want = ref_attn._sdpa(qj, kj, vj, 3 + jnp.arange(8), kv_len, causal=causal,
                          q_chunk=q_chunk)
    got = port_attn._sdpa(qt, kt, vt, 3 + torch.arange(8), kv_len,
                          causal=causal, q_chunk=q_chunk)
    assert got.dtype == vt.dtype
    close(got, want, dtype)


def test_sdpa_groups_query_head_h_with_kv_head_h_over_g():
    """Query heads 0 and 1 read KV head 0, heads 2 and 3 KV head 1."""
    q = torch.zeros(1, 1, 4, 2)
    k = torch.zeros(1, 3, 2, 2)
    v = torch.zeros(1, 3, 2, 2)
    v[:, :, 1] = 1.0
    out = port_attn._sdpa(q, k, v, torch.tensor([2]), None, causal=True,
                          q_chunk=None)
    np.testing.assert_array_equal(out[0, 0, :, 0].numpy(), [0, 0, 1, 1])


def gqa_pair(cfg_arch: str, dtype: str):
    ref_cfg, ref_p, port_cfg, port_p = both_params(cfg_arch, dtype, seed=3)
    ref_layer = jax.tree.map(lambda a: a[0], ref_p["layers"])["attn"]
    return ref_cfg, ref_layer, port_cfg, port_p.layers[0].attn


def gqa_kwargs(cfg) -> dict:
    return {"n_heads": cfg.n_heads, "n_kv": cfg.n_kv_heads, "hd": cfg.hd,
            "rope_mode": cfg.rope_mode, "rope_theta": cfg.rope_theta}


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "chatglm3_6b", "stablelm_3b",
                                  "hubert_xlarge"])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_apply_without_cache_matches_reference(arch, causal):
    """One arch per rope mode (full + QKV bias, half, partial25, none)."""
    ref_cfg, ref_p, port_cfg, port_p = gqa_pair(arch, "float32")
    xj, xt = as_dtype(np_x(9, 2, 10, ref_cfg.d_model), "float32")
    want, _ = ref_attn.gqa_apply(ref_p, xj, causal=causal, q_chunk=4,
                                 **gqa_kwargs(ref_cfg))
    with torch.no_grad():
        got, cache = port_attn.gqa_apply(port_p, xt, causal=causal, q_chunk=4,
                                         **gqa_kwargs(port_cfg))
    assert cache is None
    close(got, want)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "chatglm3_6b", "stablelm_3b",
                                  "internlm2_1_8b"])
def test_gqa_apply_with_cache_matches_reference(arch):
    """A prefill of 6 at pos0 = 0, then two one-token steps, into a cache of
    10: outputs and the whole cache after each write."""
    ref_cfg, ref_p, port_cfg, port_p = gqa_pair(arch, "float32")
    kw = gqa_kwargs(ref_cfg)
    ref_c = ref_attn.gqa_init_cache(2, 10, ref_cfg.n_kv_heads, ref_cfg.hd,
                                    jnp.float32)
    port_c = port_attn.gqa_init_cache(2, 10, port_cfg.n_kv_heads, port_cfg.hd,
                                      torch.float32, "cpu")
    x = np_x(10, 2, 8, ref_cfg.d_model)
    for pos0, t in ((0, 6), (6, 1), (7, 1)):
        xs = x[:, pos0:pos0 + t]
        want, ref_c = ref_attn.gqa_apply(ref_p, jnp.asarray(xs), cache=ref_c,
                                         pos0=pos0, **kw)
        with torch.no_grad():
            got, port_c = port_attn.gqa_apply(port_p, torch.from_numpy(xs),
                                              cache=port_c, pos0=pos0, **kw)
        close(got, want)
        for name in ("k", "v"):
            close(port_c[name], ref_c[name])


# ------------------------------------------------------------------ whole model

def _jitted(cfg):
    """The reference's entry points for ``cfg``, jitted once (cfg static)."""
    return {
        "forward": jax.jit(lambda p, b, q_chunk=ref_T.Q_CHUNK: ref_T.forward(
            p, b, cfg, q_chunk=q_chunk), static_argnames="q_chunk"),
        "prefill": jax.jit(lambda p, b, c: ref_T.prefill(p, b, cfg, c)),
        "decode": jax.jit(lambda p, c, t, pos: ref_T.decode_step(p, c, t, pos, cfg)),
    }


@pytest.mark.parametrize("arch", TF_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_chunk", [ref_T.Q_CHUNK, 8])
def test_forward_matches_reference(arch, dtype, q_chunk):
    """Hidden states of the whole model (causal, or not for the encoder with
    its ``mask_embed``), with and without query chunks."""
    ref_cfg, ref_p, port_cfg, port_p = both_params(arch, dtype)
    bj, bt = both_batches(ref_cfg, 2, 24, seed=1)
    want, want_aux = _jitted(ref_cfg)["forward"](ref_p, bj, q_chunk=q_chunk)
    with torch.no_grad():
        got, aux = port_T.forward(port_p, bt, port_cfg, q_chunk=q_chunk)
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    assert float(aux) == float(want_aux) == 0.0
    close(got, want, dtype)


@pytest.mark.parametrize("arch", DECODERS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(arch, dtype):
    """A prefill (patches in front for vision), then 8 decode steps of the
    reference's greedy tokens: logits and the whole stacked cache after each
    step; in float32 the port's greedy tokens are the reference's."""
    ref_cfg, ref_p, port_cfg, port_p = both_params(arch, dtype, seed=2)
    fns = _jitted(ref_cfg)
    seq, steps = 12 + ref_cfg.n_prefix_embeds, 8
    bj, bt = both_batches(ref_cfg, 2, seq, seed=4)
    ref_c = ref_T.init_cache(ref_cfg, 2, seq + steps + 2)
    port_c = port_T.init_cache(port_cfg, 2, seq + steps + 2, device="cpu")
    assert port_c["k"].shape == ref_c["k"].shape
    assert port_c["k"].dtype == getattr(torch, dtype)
    want, ref_c = fns["prefill"](ref_p, bj, ref_c)
    with torch.no_grad():
        got, port_c = port_T.prefill(port_p, bt, port_cfg, port_c)
    step = make_serve_step(port_cfg)
    for i in range(steps + 1):
        close(got, want, dtype)
        for name in ("k", "v"):
            close(port_c[name], ref_c[name], dtype)
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        if dtype == "float32":
            np.testing.assert_array_equal(torch.argmax(got, -1).numpy(), tok)
        if i == steps:
            break
        want, ref_c = fns["decode"](ref_p, ref_c, jnp.asarray(tok),
                                    jnp.int32(seq + i))
        with torch.no_grad():
            got, port_c = step(port_p, port_c, torch.from_numpy(tok), seq + i)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_decode_equals_forward_in_the_port(arch):
    """The port's own modes agree: forward == prefill == prefill(S-1) +
    decode_step at the last position (float32)."""
    _, _, cfg, params = both_params(arch, "float32", seed=5)
    _, b = both_batches(cfg, 2, 10 + cfg.n_prefix_embeds, seed=6)
    S = 10 + cfg.n_prefix_embeds
    with torch.no_grad():
        hidden, _ = port_T.forward(params, b, cfg)   # final norm applied
        full = port_T.logits_fn(params, hidden[:, -1:], cfg)[:, 0]
        pf, _ = port_T.prefill(params, b, cfg,
                               port_T.init_cache(cfg, 2, S + 2, device="cpu"))
        short = {k: (v[:, :-1] if k == "tokens" else v) for k, v in b.items()}
        cache = port_T.init_cache(cfg, 2, S + 2, device="cpu")
        _, cache = port_T.prefill(params, short, cfg, cache)
        dec, _ = port_T.decode_step(params, cache, b["tokens"][:, -1], S - 1, cfg)
    close(pf, full)
    close(dec, full)


# ------------------------------------------------------------------ the slice

def _fp32_smoke(registry):
    get = registry.get_smoke_config
    return lambda arch: dataclasses.replace(get(arch), dtype="float32")


@pytest.mark.parametrize("arch", DECODERS)
def test_serve_batch_matches_reference(arch, monkeypatch):
    """``serve_batch`` of both packages on the reference's own weights
    (float32 smoke configs): equal greedy tokens, the same stats keys."""
    monkeypatch.setattr(ref_serve, "get_smoke_config", _fp32_smoke(ref_registry))
    monkeypatch.setattr(port_serve, "get_smoke_config", _fp32_smoke(port_registry))

    def reference_weights(gen, cfg, device=None):
        tree = jax.tree.map(np.asarray, ref_T.init_params(jax.random.PRNGKey(0), cfg))
        return convert.lm_params_from_arrays(tree, cfg, device=device)

    monkeypatch.setattr(port_T, "init_params", reference_weights)
    kw = {"batch": 2, "prompt_len": 20, "gen": 6, "seed": 0}
    want, want_stats = ref_serve.serve_batch(arch, **kw)
    got, stats = port_serve.serve_batch(arch, device="cpu", **kw)
    assert got.shape == want.shape == (2, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert sorted(stats) == sorted(want_stats)


def test_serve_batch_samples_from_its_own_seeded_generator():
    kw = {"batch": 3, "prompt_len": 8, "gen": 5, "temperature": 0.8,
          "device": "cpu"}
    a, _ = port_serve.serve_batch("qwen2_5_3b", seed=1, **kw)
    b, _ = port_serve.serve_batch("qwen2_5_3b", seed=1, **kw)
    c, _ = port_serve.serve_batch("qwen2_5_3b", seed=2, **kw)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (3, 5) and a.min() >= 0 and a.max() < 256


def test_serve_batch_refuses_the_encoder_only_config():
    with pytest.raises(ValueError, match="encoder-only"):
        ref_serve.serve_batch("hubert_xlarge", batch=1, prompt_len=4, gen=1)
    with pytest.raises(ValueError, match="encoder-only"):
        port_serve.serve_batch("hubert_xlarge", batch=1, prompt_len=4, gen=1,
                               device="cpu")


def test_cache_overflow_raises():
    """Where ``dynamic_update_slice`` would clamp the write, the port raises."""
    _, _, cfg, params = both_params("qwen2_5_3b", "float32")
    cache = port_T.init_cache(cfg, 1, 6, device="cpu")
    toks = torch.zeros((1, 7), dtype=torch.int32)
    with torch.no_grad():
        with pytest.raises(ValueError, match="KV cache overflow"):
            port_T.prefill(params, {"tokens": toks}, cfg, cache)
        port_T.prefill(params, {"tokens": toks[:, :6]}, cfg, cache)
        with pytest.raises(ValueError, match="KV cache overflow"):
            port_T.decode_step(params, cache, toks[:, 0], 6, cfg)


# ------------------------------------------------------------------ weights

@pytest.mark.parametrize("arch", TF_ARCHS)
def test_lm_params_from_arrays_is_bit_exact_in_bf16(arch):
    ref_cfg, _ = configs(arch, "bfloat16")
    tree = random_tree(ref_cfg, seed=7)
    model = convert.lm_params_from_arrays(tree, port_registry.get_smoke_config(arch),
                                          device="cpu")
    got = dict(model.named_parameters())
    np.testing.assert_array_equal(
        got["embed.table"].view(torch.int16).numpy(),
        tree["embed"]["table"].view(np.int16))
    last = ref_cfg.n_layers - 1
    np.testing.assert_array_equal(
        got[f"layers.{last}.attn.wq.w"].view(torch.int16).numpy(),
        tree["layers"]["attn"]["wq"]["w"][last].view(np.int16))
    assert got["layers.0.ln1.scale"].dtype == torch.float32
    n_ref = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_ref


def test_lm_params_from_arrays_refuses_a_tree_of_another_shape():
    ref_cfg, port_cfg = configs("qwen2_5_3b", "float32")
    tree = random_tree(ref_cfg)
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(KeyError, match="lm_head"):
        convert.lm_params_from_arrays(missing, port_cfg, device="cpu")
    with pytest.raises(KeyError, match="no parameter"):
        convert.lm_params_from_arrays({**tree, "extra": np.zeros(3)}, port_cfg,
                                      device="cpu")
    short = jax.tree.map(lambda a: a, tree)
    short["layers"]["attn"]["wq"]["w"] = short["layers"]["attn"]["wq"]["w"][:1]
    with pytest.raises(ValueError, match="stacked layers"):
        convert.lm_params_from_arrays(short, port_cfg, device="cpu")
    with pytest.raises(ValueError, match="embed.table"):
        convert.lm_params_from_arrays(tree, configs("qwen2_5_3b", "bfloat16")[1],
                                      device="cpu")


@pytest.mark.parametrize("arch", TF_ARCHS)
def test_init_params_draws_the_reference_scales_from_the_generator(arch):
    """normal / sqrt(d_in) weights, 0.02 embeddings (and mask_embed), zero
    biases, unit norm scales — the reference's structure and dtypes; the same
    seed gives the same weights, another seed others."""
    cfg = dataclasses.replace(port_registry.get_smoke_config(arch), n_layers=3)
    model = port_T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref_shapes = jax.eval_shape(lambda: ref_T.init_params(jax.random.PRNGKey(0), cfg))
    flat = {"/".join(str(k.key) for k in path): leaf for path, leaf
            in jax.tree_util.tree_flatten_with_path(ref_shapes)[0]}
    for name, p in model.named_parameters():
        parts = name.split(".")
        key = "/".join(["layers"] + parts[2:] if parts[0] == "layers" else parts)
        want = flat[key]
        shape = want.shape[1:] if parts[0] == "layers" else want.shape
        assert tuple(p.shape) == tuple(shape), name
        assert str(p.dtype).removeprefix("torch.") == str(want.dtype), name
        v = p.detach().float()
        leaf = parts[-1]
        if leaf in ("b", "bias"):
            assert not v.any(), name
        elif leaf == "scale":
            assert bool((v == 1).all()), name
        else:
            std = 1 / np.sqrt(p.shape[0]) if leaf == "w" else 0.02
            assert abs(float(v.std()) / std - 1) < 0.2, name
    same = port_T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    other = port_T.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    assert torch.equal(same.lm_head.w, model.lm_head.w)
    assert not torch.equal(other.lm_head.w, model.lm_head.w)
