"""Training on one device in the PyTorch port against the JAX package:
``models.transformer.loss_fn`` and its gradients, ``forward(remat=)``,
``train.step`` (float32 accumulation over microbatches, AdamW, the cosine
schedule, error-feedback compression), ``train.fpm_schedule``, a
``TrainState`` through ``CheckpointManager``, ``launch.train.run_training``
and the ten cases of ``tests/test_train.py`` as parity cases.

Both packages start from one seeded numpy parameter tree
(``test_torch_lm.random_tree``; the port through
``convert.lm_params_from_arrays``) and read the same synthetic batches, and
the port's state is laid out as the reference's tree by
``convert.lm_arrays_from_params`` to be compared.  SMOKE configs in float32
unless a case says bf16.  Tolerances: losses ``1e-5`` relative; gradients
``1e-4·max|g|`` of each leaf; parameters and moments after 3 steps
``1e-5·max|leaf|``.  The compressed steps hold the codec's decisions first
(int8 codes, top-k supports): a one-ulp difference flips an int8 code at a
rounding boundary, which Adam's normalised step then shows at full size, so
parameters and moments are held where every step's decision agreed, at
``1e-4·max|leaf|``.  The reference's train steps are jitted once per
configuration (module-scoped fixtures); its top-k step does not trace under
``jax.jit`` (``topk_decompress`` takes ``int()`` of a traced product) and
runs eagerly, as do the two compressed runs that record decisions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm import configs, random_tree

import repro.configs.base as ref_base
import repro.core.fpm as ref_fpm
import repro.data.pipeline as ref_data
import repro.models.registry as ref_registry
import repro.models.transformer as ref_T
import repro.optim.adamw as ref_adamw
import repro.optim.grad_compress as ref_gc
import repro.optim.schedule as ref_sched
import repro.train.fpm_schedule as ref_fs
import repro.train.step as ref_step

import repro_torch.configs.base as port_base
import repro_torch.core.fpm as port_fpm
import repro_torch.data.pipeline as port_data
import repro_torch.launch.train as port_launch
import repro_torch.models.transformer as port_T
import repro_torch.optim.adamw as port_adamw
import repro_torch.optim.grad_compress as port_gc
import repro_torch.optim.schedule as port_sched
import repro_torch.train.fpm_schedule as port_fs
import repro_torch.train.step as port_step
from repro_torch import convert
from repro_torch.runtime import CheckpointManager

ARCHS = list(ref_registry.ARCH_IDS)
GRAD_ARCHS = ["internlm2_1_8b", "deepseek_v2_lite_16b", "zamba2_7b",
              "llava_next_mistral_7b", "hubert_xlarge"]
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's SMOKE ops are far too small to gain from threads, and
    under the parallel test run (one process a core) torch's thread pool,
    oversubscribed, made this module's training runs ~14x slower (110 s
    for one fixture instead of 8): one thread while the module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def leaves(tree, prefix: str = "") -> dict:
    """A nested dict / list tree's leaves by ``/``-joined path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def close_leaves(got: dict, want: dict, rel: float, mask: dict | None = None,
                 what: str = "", scales: dict | None = None) -> None:
    """Every leaf within ``rel·max|want leaf|`` (or ``rel·scales[leaf]``), at
    ``mask``'s entries."""
    assert sorted(got) == sorted(want), what
    for k in want:
        w, g = f32(want[k]), f32(got[k])
        assert g.shape == w.shape, (what, k)
        m = np.ones(w.shape, bool) if mask is None else mask[k]
        scale = float(np.abs(w).max()) if scales is None else scales[k]
        err = float(np.abs(g - w)[m].max(initial=0.0))
        assert err <= rel * scale, f"{what} {k}: {err} > {rel} x {scale}"


def host_batch(cfg, batch: int, seq: int, seed: int = 0, step: int = 0) -> dict:
    return {k: np.asarray(v) for k, v in
            ref_data.make_batch(cfg, batch, seq, seed=seed, step=step).items()}


def seq_of(cfg, text: int) -> int:
    return text + (cfg.n_prefix_embeds if cfg.modality == "vision" else 0)


def port_grads(model, loss) -> dict:
    names, params = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params, allow_unused=True)))


# ------------------------------------------------------------------ loss_fn

@pytest.fixture(scope="module")
def loss_cases():
    """arch -> both packages' loss, metrics and gradients of ``loss_fn`` on
    one batch of 2 x 32 text positions, vocab chunks of 24 (the last one
    short); computed on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rc, pc = configs(arch, "float32")
            tree = random_tree(rc, 0)
            batch = host_batch(rc, 2, seq_of(rc, 32))
            fn = jax.jit(jax.value_and_grad(
                lambda p, b: ref_T.loss_fn(p, b, rc, vocab_chunk=24),
                has_aux=True))
            (loss, metrics), grads = fn(jax.tree.map(jnp.asarray, tree),
                                        {k: jnp.asarray(v) for k, v in batch.items()})
            model = convert.lm_params_from_arrays(tree, pc, device="cpu")
            p_loss, p_metrics = port_T.loss_fn(
                model, {k: torch.from_numpy(v) for k, v in batch.items()}, pc,
                vocab_chunk=24)
            cache[arch] = {"ref": (loss, metrics, grads),
                           "port": (p_loss, p_metrics, port_grads(model, p_loss)),
                           "model": model, "cfg": pc}
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(loss_cases, arch):
    case = loss_cases(arch)
    loss, metrics, _ = case["ref"]
    p_loss, p_metrics, _ = case["port"]
    assert p_loss.dtype == torch.float32 and p_loss.dim() == 0
    np.testing.assert_allclose(float(p_loss), float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(p_metrics["ce"]), float(metrics["ce"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(p_metrics["aux"]), float(metrics["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    assert int(p_metrics["tokens"]) == int(metrics["tokens"])


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_fn_gradients_match_reference(loss_cases, arch):
    """Every parameter's gradient within ``1e-4·max|g|``; where the port
    gives none (a parameter the loss does not reach) the reference's is
    exactly zero."""
    case = loss_cases(arch)
    _, _, grads = case["ref"]
    _, _, p_grads = case["port"]
    want = leaves(jax.tree.map(np.asarray, grads))
    got = leaves(convert.lm_arrays_from_params(case["model"], case["cfg"], p_grads))
    close_leaves(got, want, 1e-4, what=arch)
    missing = [k for k, g in p_grads.items() if g is None]
    for name in missing:
        path, index, _ = port_T.stacked_leaf(name, case["cfg"])
        assert not np.asarray(want["/".join(path)])[index].any(), name
    if arch == "zamba2_7b":
        # the padded Mamba2 blocks of the last group get zeros in both
        g, n_groups = port_T._hybrid_layout(case["cfg"])
        padded = n_groups * g - case["cfg"].n_layers
        assert padded and len(missing) == padded * len(list(
            case["model"].mamba[-1][-1].parameters()))
    if arch == "hubert_xlarge":     # the pipeline masks frames: mask_embed learns
        assert p_grads["mask_embed"] is not None


@pytest.mark.parametrize("arch,vocab_chunk", [("internlm2_1_8b", None),
                                              ("internlm2_1_8b", 7),
                                              ("llava_next_mistral_7b", None),
                                              ("llava_next_mistral_7b", 40)])
def test_loss_fn_chunking_matches_reference(arch, vocab_chunk):
    """One chunk (``None``) and a chunk that does not divide B·T; for vision
    the patches' targets are -1 (64 text targets counted, not 96)."""
    rc, pc = configs(arch, "float32")
    tree = random_tree(rc, 1)
    batch = host_batch(rc, 2, seq_of(rc, 32), seed=3)
    loss, metrics = jax.jit(lambda p, b: ref_T.loss_fn(p, b, rc, vocab_chunk=vocab_chunk))(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.lm_params_from_arrays(tree, pc, device="cpu")
    with torch.no_grad():
        p_loss, p_metrics = port_T.loss_fn(
            model, {k: torch.from_numpy(v) for k, v in batch.items()}, pc,
            vocab_chunk=vocab_chunk)
    np.testing.assert_allclose(float(p_loss), float(loss), rtol=LOSS_RTOL)
    assert int(p_metrics["tokens"]) == int(metrics["tokens"]) == 64


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "deepseek_v2_lite_16b",
                                  "zamba2_7b"])
def test_remat_recomputes_and_changes_nothing(arch, monkeypatch):
    """``remat=True`` runs each layer (hybrid: group) and each vocabulary
    chunk again in the backward pass; the loss and the gradients are those
    of ``remat=False``."""
    _, pc = configs(arch, "float32")
    model = port_T.init_params(torch.Generator().manual_seed(0), pc, device="cpu")
    batch = port_data.make_batch(pc, 2, 32, seed=0, step=0, device="cpu")
    counted = "_hybrid_group" if pc.family == "hybrid" else "_apply_tf_layer"
    calls = {counted: 0, "_chunk_ce": 0}
    for name in calls:
        fn = getattr(port_T, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(port_T, name, wrapped)
    units = (len(model.mamba) if pc.family == "hybrid" else pc.n_layers)
    chunks = 64 // 16
    results = {}
    for remat in (False, True):
        for name in calls:
            calls[name] = 0
        loss, _ = port_T.loss_fn(model, batch, pc, remat=remat, vocab_chunk=16)
        grads = port_grads(model, loss)
        assert calls[counted] == units * (2 if remat else 1), (remat, calls)
        assert calls["_chunk_ce"] == 2 * chunks      # the CE is always remat'd
        results[remat] = (loss.detach(), grads)
    assert torch.equal(results[True][0], results[False][0])
    for k, g in results[False][1].items():
        if g is None:
            assert results[True][1][k] is None
        else:
            torch.testing.assert_close(results[True][1][k], g, rtol=1e-6, atol=1e-7)


def test_loss_fn_in_bf16_matches_reference():
    rc, pc = configs("internlm2_1_8b", "bfloat16")
    tree = random_tree(rc, 0)
    batch = host_batch(rc, 2, 32)
    loss, _ = jax.jit(lambda p, b: ref_T.loss_fn(p, b, rc))(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.lm_params_from_arrays(tree, pc, device="cpu")
    with torch.no_grad():
        p_loss, _ = port_T.loss_fn(model, {k: torch.from_numpy(v)
                                           for k, v in batch.items()}, pc)
    assert p_loss.dtype == torch.float32
    np.testing.assert_allclose(float(p_loss), float(loss), rtol=5e-2)


# ------------------------------------------------------------------ train step

def ref_state(tree, tcfg):
    params = jax.tree.map(jnp.asarray, tree)
    residual = (jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
                if tcfg.grad_compress != "none" else {})
    return ref_step.TrainState(params, ref_adamw.adamw_init(params), residual)


def port_state(tree, cfg, tcfg):
    model = convert.lm_params_from_arrays(tree, cfg, device="cpu")
    residual = ({k: torch.zeros(p.shape, dtype=torch.float32)
                 for k, p in model.named_parameters()}
                if tcfg.grad_compress != "none" else {})
    return port_step.TrainState(model, port_adamw.adamw_init(model), residual)


def state_trees(state, cfg=None) -> dict:
    """params, m, v (and residual) of either package's state as reference
    trees of numpy arrays (copies)."""
    if cfg is None:
        out = {"params": state.params, "m": state.opt.m, "v": state.opt.v}
        if state.residual:
            out["residual"] = state.residual
        return {k: leaves(jax.tree.map(np.array, v)) for k, v in out.items()}
    model = state.params
    out = {"params": convert.lm_arrays_from_params(model, cfg),
           "m": convert.lm_arrays_from_params(model, cfg, state.opt.m),
           "v": convert.lm_arrays_from_params(model, cfg, state.opt.v)}
    if state.residual:
        out["residual"] = convert.lm_arrays_from_params(model, cfg, state.residual)
    return {k: leaves(v) for k, v in out.items()}


TRAIN_KW = {"none": dict(microbatches=2),
            "int8": dict(microbatches=1, grad_compress="int8")}
RUN_STEPS = 60


@pytest.fixture(scope="module")
def training_runs():
    """kind -> both packages trained RUN_STEPS steps from the same tree on
    the same stream (internlm2 SMOKE, batch 16 x 32, lr 1e-2, warm-up 3:
    ``tests/test_train.py``'s runs), the reference jitted; the losses, and
    each state after 3 steps and at the end.  Computed on first use."""
    cache = {}

    def get(kind):
        if kind in cache:
            return cache[kind]
        rc, pc = configs("internlm2_1_8b", "float32")
        kw = TRAIN_KW[kind]
        rt = ref_base.TrainCfg(lr=1e-2, total_steps=RUN_STEPS, warmup=3, **kw)
        pt = port_base.TrainCfg(lr=1e-2, total_steps=RUN_STEPS, warmup=3, **kw)
        tree = random_tree(rc, 0)
        out = {"ref": [], "port": []}
        step = jax.jit(ref_step.make_train_step(rc, rt))
        state, pipe = ref_state(tree, rt), ref_data.SyntheticTokenPipeline(rc, 16, 32, seed=0)
        for i in range(RUN_STEPS):
            state, m = step(state, pipe.next())
            out["ref"].append(float(m["loss"]))
            if i == 2:
                out["ref_3"] = state_trees(state)
        out["ref_end"] = state_trees(state)
        step = port_step.make_train_step(pc, pt)
        state = port_state(tree, pc, pt)
        pipe = port_data.SyntheticTokenPipeline(pc, 16, 32, seed=0, device="cpu")
        for i in range(RUN_STEPS):
            state, m = step(state, pipe.next())
            out["port"].append(float(m["loss"]))
            if i == 2:
                out["port_3"] = state_trees(state, pc)
                out["metrics_3"] = m
        out["port_end"] = state_trees(state, pc)
        out["state"] = state
        cache[kind] = out
        return out
    return get


def test_train_step_three_steps_match_reference(training_runs):
    """microbatches=2: losses, parameters, m and v after 3 steps."""
    run = training_runs("none")
    np.testing.assert_allclose(run["port"][:3], run["ref"][:3], rtol=LOSS_RTOL)
    for part in ("params", "m", "v"):
        close_leaves(run["port_3"][part], run["ref_3"][part], 1e-5, what=part)
    m = run["metrics_3"]
    assert sorted(m) == ["grad_norm", "loss", "lr"]
    assert float(m["lr"]) == pytest.approx(float(ref_sched.cosine_warmup(
        jnp.int32(2), lr=1e-2, warmup=3, total=RUN_STEPS)), rel=1e-7)
    assert int(run["state"].opt.step) == RUN_STEPS     # once a step, not a microbatch


def test_train_loss_decreases_matches_reference(training_runs):
    """``tests/test_train.py::test_train_loss_decreases`` in both packages:
    60 steps, the loss falls by more than 0.5, every loss finite, the
    curves within 1e-5 and the end states within 1e-5 of each leaf."""
    run = training_runs("none")
    losses = np.array(run["port"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0] - 0.5, losses
    np.testing.assert_allclose(losses, run["ref"], rtol=LOSS_RTOL)
    for part in ("params", "m", "v"):
        close_leaves(run["port_end"][part], run["ref_end"][part], 1e-5, what=part)


def test_train_with_int8_compression_still_learns_matches_reference(training_runs):
    """``test_train_with_int8_compression_still_learns`` in both packages:
    the residuals are allocated, the loss falls by more than 0.4, and the
    curves agree within 2e-4 (int8 codes flip at rounding boundaries on
    one-ulp differences, and error feedback carries each flip on)."""
    run = training_runs("int8")
    losses = np.array(run["port"])
    assert run["port_3"]["residual"]
    assert losses[-1] < losses[0] - 0.4, losses
    np.testing.assert_allclose(losses, run["ref"], rtol=2e-4)


def record_decisions(monkeypatch, module, store: list, to_numpy) -> None:
    """Record the decompressed gradient of every ``error_feedback_update``
    call ``module`` makes."""
    fn = module.error_feedback_update

    def recorded(g, residual, codec="int8", **kw):
        dec, new_r = fn(g, residual, codec=codec, **kw)
        store.append(to_numpy(dec))
        return dec, new_r
    monkeypatch.setattr(module, "error_feedback_update", recorded)


def decision(codec: str, dec: np.ndarray) -> np.ndarray:
    """What the codec decided: int8 codes (the largest magnitude is code
    127), or the top-k support."""
    if codec == "topk":
        return dec != 0
    return np.round(dec * 127 / max(float(np.abs(dec).max()), 1e-30))


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_compressed_train_steps_match_reference(codec, monkeypatch):
    """3 steps with microbatches=2 and error feedback, both eager: the codec
    sees the reference's leaves (every layer of a stacked leaf under one
    int8 scale or one top-k); the decisions agree but for a share of
    1e-3; losses within 1e-5; parameters, m and v within 1e-4·max|leaf|
    where every step's decision agreed, and there the residuals within
    1e-3 of the last compressed gradient's largest magnitude, an eighth of
    one int8 step (a residual is a difference of two such values, and an
    earlier step's flip moves the next gradient everywhere by ~1e-4 of its
    scale: 1.3e-4 seen)."""
    rc, pc = configs("internlm2_1_8b", "float32")
    kw = dict(lr=1e-2, total_steps=RUN_STEPS, warmup=3, microbatches=2,
              grad_compress=codec)
    rt, pt = ref_base.TrainCfg(**kw), port_base.TrainCfg(**kw)
    tree = random_tree(rc, 0)
    ref_dec, port_dec = [], []
    record_decisions(monkeypatch, ref_step, ref_dec, np.asarray)
    record_decisions(monkeypatch, port_step, port_dec, lambda t: t.numpy().copy())
    state, pipe = ref_state(tree, rt), ref_data.SyntheticTokenPipeline(rc, 16, 32, seed=0)
    step = ref_step.make_train_step(rc, rt)
    ref_losses = []
    for _ in range(3):
        state, m = step(state, pipe.next())
        ref_losses.append(float(m["loss"]))
    want = state_trees(state)
    pstate = port_state(tree, pc, pt)
    pipe = port_data.SyntheticTokenPipeline(pc, 16, 32, seed=0, device="cpu")
    step = port_step.make_train_step(pc, pt)
    losses = []
    for _ in range(3):
        pstate, m = step(pstate, pipe.next())
        losses.append(float(m["loss"]))
    got = state_trees(pstate, pc)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)

    treedef = jax.tree.structure(state.params)
    n = treedef.num_leaves
    names = [k for k, _ in pstate.params.named_parameters()]
    groups = list(dict.fromkeys("/".join(port_T.stacked_leaf(k, pc)[0]) for k in names))
    assert len(ref_dec) == len(port_dec) == 3 * n == 3 * len(groups)
    agree, differ, total = None, 0, 0
    for i in range(3):
        a = leaves(jax.tree.unflatten(treedef, ref_dec[i * n:(i + 1) * n]))
        b = dict(zip(groups, port_dec[i * n:(i + 1) * n]))
        eq = {k: decision(codec, a[k]) == decision(codec, b[k].reshape(a[k].shape))
              for k in a}
        differ += sum(int((~e).sum()) for e in eq.values())
        total += sum(e.size for e in eq.values())
        agree = eq if agree is None else {k: agree[k] & eq[k] for k in a}
    assert differ <= 1e-3 * total, (differ, total)
    for part in ("params", "m", "v"):
        close_leaves(got[part], want[part], 1e-4, mask=agree, what=part)
    last = leaves(jax.tree.unflatten(treedef, ref_dec[2 * n:]))
    close_leaves(got["residual"], want["residual"], 1e-3, mask=agree,
                 what="residual", scales={k: float(np.abs(v).max())
                                          for k, v in last.items()})


def test_microbatching_matches_full_batch_grads_matches_reference():
    """``test_microbatching_matches_full_batch_grads`` in both packages:
    qwen2.5 SMOKE, the full batch's gradients against the reference's
    within 1e-4·max|g|, and the mean of the two halves' within the
    reference test's 2e-2 of the full batch's."""
    rc, pc = configs("qwen2_5_3b", "float32")
    tree = random_tree(rc, 1)
    batch = host_batch(rc, 4, 16)
    grad = jax.jit(jax.grad(lambda p, b: ref_T.loss_fn(p, b, rc, vocab_chunk=16)[0]))
    want = leaves(jax.tree.map(np.asarray, grad(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})))
    model = convert.lm_params_from_arrays(tree, pc, device="cpu")

    def grads(rows):
        b = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        return port_grads(model, port_T.loss_fn(model, b, pc, vocab_chunk=16)[0])
    full = grads(slice(None))
    close_leaves(leaves(convert.lm_arrays_from_params(model, pc, full)), want, 1e-4)
    halves = [grads(slice(0, 2)), grads(slice(2, 4))]
    for k, g in full.items():
        mean = (halves[0][k].float() + halves[1][k].float()) / 2
        np.testing.assert_allclose(f32(mean), f32(g), atol=2e-2)


def test_split_microbatches_takes_consecutive_rows():
    x = torch.arange(24).reshape(6, 4)
    mbs = port_step._split_microbatches({"x": x, "y": x[:, 0]}, 3)
    assert [mb["x"][:, 0].tolist() for mb in mbs] == [[0, 4], [8, 12], [16, 20]]
    want = ref_step._split_microbatches({"x": jnp.asarray(x.numpy())}, 3)["x"]
    np.testing.assert_array_equal(np.stack([mb["x"].numpy() for mb in mbs]),
                                  np.asarray(want))
    with pytest.raises(ValueError, match="not divisible"):
        port_step._split_microbatches({"x": x}, 4)


def test_train_step_keeps_bf16_parameters_and_float32_state():
    """A bf16 model: its parameters keep their dtypes through a step (bf16
    weights, float32 norm scales, as the reference draws them), the moments
    are float32, and the step's loss is ``loss_fn``'s on the same batch."""
    _, pc = configs("internlm2_1_8b", "bfloat16")
    tcfg = port_base.TrainCfg(microbatches=2, warmup=0, total_steps=10)
    state = port_step.init_train_state(torch.Generator().manual_seed(0), pc, tcfg,
                                       device="cpu")
    batch = port_data.make_batch(pc, 4, 16, seed=0, step=0, device="cpu")
    with torch.no_grad():
        halves = [port_T.loss_fn(state.params, {k: v[i:i + 2] for k, v in batch.items()},
                                 pc)[0] for i in (0, 2)]
    before = {k: p.clone() for k, p in state.params.named_parameters()}
    assert {p.dtype for p in before.values()} == {torch.bfloat16, torch.float32}
    state, m = port_step.make_train_step(pc, tcfg)(state, batch)
    assert float(m["loss"]) == pytest.approx(float(sum(halves) / 2), rel=1e-6)
    for k, p in state.params.named_parameters():
        assert p.dtype == before[k].dtype and state.opt.m[k].dtype == torch.float32
    assert any(not torch.equal(p, before[k]) for k, p in state.params.named_parameters())


# ------------------------------------------------------------- the ten cases

def test_int8_codec_bounded_error_matches_reference(rng):
    g = rng.standard_normal(1000).astype(np.float32)
    q, s = port_gc.int8_compress(torch.from_numpy(g))
    q_ref, s_ref = ref_gc.int8_compress(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    err = np.abs(port_gc.int8_decompress(q, s).numpy() - g)
    assert err.max() <= float(s) * 0.5 + 1e-6


def test_topk_codec_keeps_largest_matches_reference(rng):
    g = rng.standard_normal(256).astype(np.float32)
    v, i, shp = port_gc.topk_compress(torch.from_numpy(g), k_frac=0.1)
    dec = port_gc.topk_decompress(v, i, shp).numpy()
    kept = np.nonzero(dec)[0]
    thresh = np.sort(np.abs(g))[-len(kept)]
    assert np.all(np.abs(g[kept]) >= thresh - 1e-6)
    np.testing.assert_array_equal(dec, np.asarray(ref_gc.topk_decompress(
        *ref_gc.topk_compress(jnp.asarray(g), k_frac=0.1))))


def test_error_feedback_residual_is_exact_matches_reference(rng):
    g = rng.standard_normal(512).astype(np.float32)
    dec, r2 = port_gc.error_feedback_update(torch.from_numpy(g), torch.zeros(512),
                                            codec="int8")
    np.testing.assert_allclose((dec + r2).numpy(), g, atol=1e-5)
    dec_ref, r2_ref = ref_gc.error_feedback_update(jnp.asarray(g), jnp.zeros(512),
                                                   codec="int8")
    np.testing.assert_array_equal(r2.numpy(), np.asarray(r2_ref))


def test_compressed_psum_multidevice_equivalence_matches_reference():
    """One device (the reference's ``shard_map`` over a mesh of one; the
    port without a process group): the identity up to quantisation, the
    same values in both."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    g = np.linspace(-1, 1, 128, dtype=np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("pods",))
    want = shard_map(lambda x: ref_gc.compressed_psum(x, "pods"), mesh=mesh,
                     in_specs=P(), out_specs=P())(jnp.asarray(g))
    got = port_gc.compressed_psum(torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), g, atol=2e-2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cosine_warmup_shape_matches_reference():
    lr = [float(port_sched.cosine_warmup(torch.tensor(s, dtype=torch.int32), lr=1.0,
                                         warmup=10, total=100)) for s in range(100)]
    assert lr[0] < lr[9] <= 1.0
    assert lr[-1] < lr[50] < lr[11]
    want = [float(ref_sched.cosine_warmup(jnp.int32(s), lr=1.0, warmup=10, total=100))
            for s in range(100)]
    np.testing.assert_allclose(lr, want, rtol=1e-7, atol=1e-7)


def padded_timer(mb, seq):
    base = mb * seq * 1e-6
    return base * (4.0 if seq % 128 else 1.0)


def test_choose_schedule_prefers_fast_padded_size_matches_reference():
    picks = []
    for fs in (ref_fs, port_fs):
        fpm = fs.build_step_fpm(padded_timer, [1, 2, 4], [100, 128, 256])
        picks.append(fs.choose_schedule(fpm, tokens_per_device=512, seq_len=100,
                                        pad_candidates=[128, 256]))
    assert picks[1] == picks[0] and picks[1][1] == 128


def test_fpm_batch_partition_heterogeneous_matches_reference():
    xs = np.array([1, 8, 16, 32])
    ys = np.array([64, 128])
    v = np.outer(xs, [1.0, 1.1]) + 1
    res = []
    for fpm in (ref_fpm, port_fpm):
        fpms = fpm.FPMSet([fpm.SpeedFunction(xs, ys, v), fpm.SpeedFunction(xs, ys, 3 * v)])
        res.append((ref_fs if fpm is ref_fpm else port_fs).fpm_batch_partition(
            fpms, 32, 128))
    assert res[1].d.sum() == 32 and res[1].d[1] > res[1].d[0]
    np.testing.assert_array_equal(res[1].d, res[0].d)


# ------------------------------------------------------------- fpm_schedule

def nonmonotone_timer(mb, seq):
    """A step-time surface with a valley at seq 512 and a memory cap at 8 x
    1024 (NaN: unmeasured)."""
    if mb * seq > 4096:
        return float("nan")
    slow = 1.0 + 0.5 * (seq % 512 != 0) + 0.1 * np.log2(seq)
    return mb * seq * 1e-6 * slow / (1 + 0.2 * mb)


@pytest.mark.parametrize("timer", [padded_timer, nonmonotone_timer])
@pytest.mark.parametrize("grid", [([1, 2, 4], [100, 128, 256]),
                                  ([1, 2, 4, 8], [256, 480, 512, 1024])])
def test_fpm_schedule_equals_reference(timer, grid):
    """``build_step_fpm``'s speeds, then ``choose_schedule`` over several
    budgets, lengths and pads: exact equality."""
    mbs, seqs = grid
    ref = ref_fs.build_step_fpm(timer, mbs, seqs)
    port = port_fs.build_step_fpm(timer, mbs, seqs)
    np.testing.assert_array_equal(port.speed, ref.speed)
    np.testing.assert_array_equal(port.xs, ref.xs)
    for tokens, seq, pads in [(512, 100, [128, 256]), (4096, 480, [512, 1024]),
                              (64, 256, [512]), (8192, 90, [])]:
        assert port_fs.choose_schedule(port, tokens, seq, pads) == \
            ref_fs.choose_schedule(ref, tokens, seq, pads)


@pytest.mark.parametrize("batch", [7, 32, 100])
@pytest.mark.parametrize("groups", [2, 3])
def test_fpm_batch_partition_equals_reference(batch, groups):
    xs, ys = np.array([1, 4, 16, 64, 128]), np.array([64, 128, 256])
    rng = np.random.default_rng(batch * groups)
    speeds = [np.abs(rng.standard_normal((5, 3))) + 1 for _ in range(groups)]
    res = [fs.fpm_batch_partition(fpm.FPMSet([fpm.SpeedFunction(xs, ys, s) for s in speeds]),
                                  batch, 128)
           for fs, fpm in ((ref_fs, ref_fpm), (port_fs, port_fpm))]
    np.testing.assert_array_equal(res[1].d, res[0].d)
    assert (res[1].tau, res[1].method) == (res[0].tau, res[0].method)
    np.testing.assert_array_equal(res[1].predicted_times, res[0].predicted_times)


# ------------------------------------------------------ state and run_training

@pytest.mark.parametrize("dtype,codec", [("float32", "int8"), ("bfloat16", "none")])
def test_train_state_checkpoint_round_trip(tmp_path, dtype, codec):
    """A ``TrainState`` saves whole; restoring writes the module's
    parameters in place and gives back the step, moments and residuals."""
    _, pc = configs("internlm2_1_8b", dtype)
    tcfg = port_base.TrainCfg(microbatches=1, grad_compress=codec, warmup=0)
    step = port_step.make_train_step(pc, tcfg)
    state = port_step.init_train_state(torch.Generator().manual_seed(0), pc, tcfg,
                                       device="cpu")
    pipe = port_data.SyntheticTokenPipeline(pc, 4, 16, seed=0, device="cpu")
    for _ in range(2):
        state, _ = step(state, pipe.next())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state, extra={"pipeline": pipe.state_dict()})
    fresh = port_step.init_train_state(torch.Generator().manual_seed(1), pc, tcfg,
                                       device="cpu")
    module = fresh.params
    restored, extra = mgr.restore(2, fresh)
    assert isinstance(restored, port_step.TrainState)
    assert restored.params is module and extra["pipeline"]["step"] == 2
    for (k, p), (_, q) in zip(restored.params.named_parameters(),
                              state.params.named_parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), k
    assert int(restored.opt.step) == 2 and restored.opt.step.dtype == torch.int32
    for part in ("m", "v"):
        for k, t in getattr(state.opt, part).items():
            assert torch.equal(getattr(restored.opt, part)[k], t)
    assert sorted(restored.residual) == sorted(state.residual)
    for k, t in state.residual.items():
        assert torch.equal(restored.residual[k], t)
    # the restored state trains on exactly as the saved one
    batch = pipe.next()
    _, saved = step(state, batch)
    _, again = step(restored, batch)
    assert float(again["loss"]) == float(saved["loss"])


class Killed(Exception):
    pass


def test_kill_restart_continues_loss_curve(tmp_path, monkeypatch):
    """``tests/test_runtime.py::test_kill_restart_continues_loss_curve``
    through ``run_training(device="cpu", ckpt_dir=)``: 10 steps unbroken;
    then a run killed after its checkpoint at step 5, and a second run from
    that checkpoint for steps 5 ... 9, the pipeline cursor restored: the
    same losses within 1e-4."""
    kw = dict(smoke=True, steps=10, lr=1e-3, batch=4, seq=16, ckpt_every=5,
              microbatches=1, async_ckpt=False, device="cpu", log_every=100)
    unbroken = port_launch.run_training("internlm2_1_8b",
                                        ckpt_dir=str(tmp_path / "a"), **kw)
    assert len(unbroken) == 10
    nxt = port_data.SyntheticTokenPipeline.next

    def killed_at_5(self):
        if self.step == 5:
            raise Killed
        return nxt(self)
    monkeypatch.setattr(port_data.SyntheticTokenPipeline, "next", killed_at_5)
    with pytest.raises(Killed):
        port_launch.run_training("internlm2_1_8b", ckpt_dir=str(tmp_path / "b"), **kw)
    monkeypatch.setattr(port_data.SyntheticTokenPipeline, "next", nxt)
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 5
    resumed = port_launch.run_training("internlm2_1_8b",
                                       ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(resumed) == 5
    np.testing.assert_allclose(resumed, unbroken[5:], rtol=1e-4)
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 10


def test_run_training_learns_on_the_host():
    losses = port_launch.run_training("internlm2_1_8b", steps=30, lr=1e-2,
                                      batch=8, seq=32, device="cpu", log_every=100)
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < losses[0] - 0.3


def test_one_device_refuses_what_needs_a_mesh():
    """One process: a 2 x 1 or 1 x 4 mesh needs 2 or 4 ranks, and a world of
    one refuses it (``make_local_mesh``: the mesh spans the world); the same
    calls at 1 x 1 train on the mesh of that world, the state DTensors, the
    losses those of the run without a process group; ``make_train_step(
    grad_shardings={})`` (every accumulator laid out as its parameter)
    steps such a state."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import init_multihost, make_local_mesh

    kw = dict(steps=3, batch=4, seq=16, device="cpu", log_every=100)
    assert not dist.is_initialized()
    alone = port_launch.run_training("internlm2_1_8b", **kw)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_multihost(f"127.0.0.1:{port}", 1, 0, device_type="cpu")
    try:
        for axes in ({"data_axis": 2}, {"model_axis": 4}):
            with pytest.raises(ValueError, match="spans the whole world"):
                port_launch.run_training("internlm2_1_8b", **kw, **axes)
        on_mesh = port_launch.run_training("internlm2_1_8b", data_axis=1,
                                           model_axis=1, **kw)
        np.testing.assert_allclose(on_mesh, alone, rtol=1e-6)
        _, pc = configs("internlm2_1_8b", "float32")
        tcfg = port_base.TrainCfg(microbatches=2)
        mesh = make_local_mesh(device_type="cpu")
        state = port_step.init_train_state(torch.Generator().manual_seed(0), pc,
                                           tcfg, device="cpu")
        state = port_launch.reshard(state, mesh, port_launch.state_pspecs(state, mesh),
                                    dtensor=True)
        step = port_step.make_train_step(pc, tcfg, grad_shardings={})
        state, m = step(state, port_data.make_batch(pc, 4, 16, seed=0, step=0,
                                                    device="cpu"))
        assert np.isfinite(float(m["loss"])) and int(state.opt.step) == 1
        assert all(isinstance(p, DTensor) for p in state.params.parameters())
        assert all(isinstance(t, DTensor) for t in state.opt.m.values())
    finally:
        dist.destroy_process_group()


def test_training_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pc = configs("internlm2_1_8b", "float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_step.init_train_state(torch.Generator(), pc, port_base.TrainCfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        port_launch.run_training("internlm2_1_8b", steps=1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_arrays_from_params_inverts_lm_params_from_arrays(arch, dtype):
    rc, pc = configs(arch, dtype)
    tree = random_tree(rc, 5)
    model = convert.lm_params_from_arrays(tree, pc, device="cpu")
    back = leaves(convert.lm_arrays_from_params(model, pc))
    want = leaves(tree)
    assert sorted(back) == sorted(want)
    for k, w in want.items():
        assert back[k].shape == w.shape and back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], w.astype(np.float32), err_msg=k)
    assert type(convert.lm_arrays_from_params(model, pc).get("blocks", [])) is list
    zeros = convert.lm_arrays_from_params(
        model, pc, {k: None for k, _ in model.named_parameters()})
    assert not any(v.any() for v in leaves(zeros).values())


def test_train_exports_the_reference_names():
    import repro.launch.train as ref_launch
    import repro.train as ref_train
    import repro_torch.train as port_train
    assert port_train.__all__ == ref_train.__all__
    assert port_launch.__all__ == ref_launch.__all__
    assert port_fs.__all__ == ref_fs.__all__
    assert port_step.__all__ == ref_step.__all__
    for mod in (port_train, port_launch, port_fs, port_step):
        for name in mod.__all__:
            assert hasattr(mod, name), name
    assert port_step.TrainState._fields == ref_step.TrainState._fields
