"""The trainer on a ("data", "model") mesh in the PyTorch port, against the
one-rank port and the JAX package's sharded train step.

``_torch_train_mesh_cases.run`` trains internlm2_1_8b and dbrx_132b SMOKE
(float32; dbrx's expert banks over ``"model"``) for 3 steps on gloo worlds
of 4 host ranks laid out 2x2, 4x1 and 1x4, from the same numpy tree and
batches as the one-rank port here and the reference's
``jax.jit(make_train_step(grad_shardings=))`` on 4 forced CPU devices under
``make_local_mesh(2, 2)``; then a checkpoint across layouts and
``launch.train.main``'s restarts.  Tolerances: losses ``1e-5`` relative;
parameters and moments ``1e-4·max|leaf|``.  The int8 codec on 2x2 holds
its decisions (int8 codes) against the one-rank port's first, then the
state where every step's decision agreed."""

import dataclasses
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import _torch_train_mesh_cases as cases
from test_torch_lm import random_tree
from test_torch_train import close_leaves, decision, host_batch, leaves

import repro.models.registry as ref_registry
import repro_torch.configs.base as port_base
import repro_torch.models.registry as port_registry
import repro_torch.models.transformer as port_T
from repro_torch import convert
from repro_torch.runtime import CheckpointManager

LOSS_RTOL = 1e-5
PARAM_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread for the one-rank runs here, as the world's ranks run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_cfg(arch: str):
    return dataclasses.replace(port_registry.get_smoke_config(arch), dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, the world's and the reference's results, and the one-rank
    port's runs of the same cases (computed while the world runs)."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    inputs = {}
    for arch in cases.ARCHS:
        rc = dataclasses.replace(ref_registry.get_smoke_config(arch), dtype="float32")
        inputs[arch] = (random_tree(rc, 0),
                        [host_batch(rc, cases.BATCH, cases.SEQ, seed=0, step=i)
                         for i in range(cases.STEPS)])
    with open(cases.inputs_path(tmp), "wb") as fh:
        pickle.dump(inputs, fh)
    port, ref = cases.run(tmp)
    one = {}
    for arch in cases.ARCHS:
        tree, batches = inputs[arch]
        losses, state = cases.train_steps(tree, port_cfg(arch),
                                          port_base.TrainCfg(**cases.TRAIN),
                                          batches, None)
        one[arch] = {"losses": losses, "state": cases._whole_state(state)}
    tree, batches = inputs[cases.ARCHS[0]]
    decisions: list = []
    with cases._recording(decisions):
        losses, state = cases.train_steps(
            tree, port_cfg(cases.ARCHS[0]),
            port_base.TrainCfg(grad_compress="int8", **cases.TRAIN), batches, None)
    one["int8"] = {"losses": losses, "state": cases._whole_state(state),
                   "decisions": decisions}
    return {"tmp": tmp, "inputs": inputs, "port": port, "ref": ref, "one": one}


def as_reference_tree(arch: str, tree: dict, by_name: dict) -> dict:
    """Arrays by port parameter name laid out as the reference's tree (of
    which ``tree`` is one)."""
    cfg = port_cfg(arch)
    template = convert.lm_params_from_arrays(tree, cfg, device="cpu")
    return leaves(convert.lm_arrays_from_params(
        template, cfg, {k: torch.from_numpy(v) for k, v in by_name.items()}))


@pytest.mark.parametrize("arch", cases.ARCHS)
@pytest.mark.parametrize("layout", ["2x2", "4x1", "1x4"])
def test_mesh_training_matches_one_rank(runs, arch, layout):
    """3 steps on the mesh: the losses within 1e-5 of the one-rank port's,
    every parameter, m and v within 1e-4·max|leaf|, and every parameter,
    moment and residual a DTensor with its sanitized reference placements."""
    got = runs["port"]["layouts"][f"{arch}/{layout}"]
    want = runs["one"][arch]
    assert got["laid_out"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    for part in ("params", "m", "v"):
        close_leaves(got["state"][part], want["state"][part], PARAM_REL,
                     what=f"{arch} {layout} {part}")


@pytest.mark.parametrize("arch", cases.ARCHS)
def test_mesh_training_matches_the_reference_sharded_step(runs, arch):
    """The 2x2 run against ``jax.jit(make_train_step(grad_shardings=))`` on
    the reference's 2x2 mesh: losses within 1e-5, the parameters and
    moments within 1e-4·max|leaf| of the reference's tree."""
    got = runs["port"]["layouts"][f"{arch}/2x2"]
    want = runs["ref"][arch]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    for part in ("params", "m", "v"):
        close_leaves(as_reference_tree(arch, runs["inputs"][arch][0],
                                       got["state"][part]),
                     leaves(jax.tree.map(np.asarray, want[part])), PARAM_REL,
                     what=f"{arch} {part}")


def test_int8_codec_on_the_mesh_matches_one_rank(runs):
    """int8 error feedback on 2x2: the codec takes the whole stacked leaf
    (one scale over every layer, not a block's): its codes equal the
    one-rank port's but for a share of 1e-3 (a one-ulp difference flips a
    code at a rounding boundary); losses within 1e-5; where every step's
    decision agreed, parameters, m and v within 1e-4·max|leaf|, and the
    residuals within 1e-3 of the last compressed gradient's largest
    magnitude (as ``test_torch_train.py`` holds them)."""
    got, want = runs["port"]["layouts"]["int8/2x2"], runs["one"]["int8"]
    assert got["laid_out"]
    cfg = port_cfg(cases.ARCHS[0])
    names = list(want["state"]["params"])
    groups: dict = {}
    for name in names:
        groups.setdefault(port_T.stacked_leaf(name, cfg)[0], []).append(name)
    n = len(groups)
    assert len(got["decisions"]) == len(want["decisions"]) == cases.STEPS * n
    agree, differ, total = {}, 0, 0
    for i, (a, b) in enumerate(zip(got["decisions"], want["decisions"])):
        eq = decision("int8", a) == decision("int8", b)
        differ += int((~eq).sum())
        total += eq.size
        for member, e in zip(list(groups.values())[i % n], eq):
            agree[member] = agree.get(member, True) & e
    assert differ <= 1e-3 * total, (differ, total)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    for part in ("params", "m", "v"):
        close_leaves(got["state"][part], want["state"][part], PARAM_REL,
                     what=f"int8 {part}", mask=agree)
    last = {member: float(np.abs(dec).max()) for members, dec in
            zip(groups.values(), want["decisions"][-n:]) for member in members}
    close_leaves(got["state"]["residual"], want["state"]["residual"], 1e-3,
                 mask=agree, what="int8 residual", scales=last)


def test_constrain_batch_splits_the_rows_over_data_on_the_mesh(runs):
    """Inside the 2x2 mesh a DTensor's batch dim goes over "data" (and with
    sequence sharding on, a (B, T, d) one's T over "model"), whole values
    unchanged; a batch of 3 rows, which 2 does not divide, and a 1-D tensor
    stay as they are: the reference's conditions."""
    got = runs["port"]["layouts"]["constrain"]
    assert got["batch"]["placements"] == ["Shard(dim=0)", "Replicate()"]
    assert got["seq"]["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
    assert got["odd"]["placements"] == got["flat"]["placements"] == \
        ["Replicate()", "Replicate()"]
    assert all(case["equal"] for case in got.values())


def test_mesh_checkpoint_restores_on_one_rank_and_on_another_layout(runs):
    """The 2x2 state's checkpoint holds whole tensors by parameter name, one
    directory written by the first rank: it restores bit for bit onto the
    4x1 mesh (DTensors of that layout) and onto one rank."""
    saved = runs["port"]["layouts"]["internlm2_1_8b/2x2"]["state"]
    onto = runs["port"]["layouts"]["restored/4x1"]
    assert onto["laid_out"] and onto["extra"] == {"step": cases.STEPS}
    assert onto["files"] == [f"step_{cases.STEPS:012d}"]
    for part in ("params", "m", "v"):
        for k, w in saved[part].items():
            np.testing.assert_array_equal(onto["state"][part][k], w, err_msg=k)
    tree, _ = runs["inputs"]["internlm2_1_8b"]
    like = cases._port_state(tree, port_cfg("internlm2_1_8b"),
                             port_base.TrainCfg(**cases.TRAIN), None)
    state, extra = CheckpointManager(os.path.join(runs["tmp"], "mesh_ckpt")).restore(
        cases.STEPS, like)
    assert extra == {"step": cases.STEPS}
    one = cases._whole_state(state)
    for part in ("params", "m", "v"):
        for k, w in saved[part].items():
            np.testing.assert_array_equal(one[part][k], w, err_msg=k)
    assert int(state.opt.step) == cases.STEPS


def test_main_resumes_after_a_runtime_error(runs):
    """``main`` on 2x2 with a ``RuntimeError`` raised on every rank at step
    5: the grid rebuilt from all 4 ranks (2x2 again), the run resumed from
    the checkpoint at step 4, the losses of steps 4 ... 7 within 1e-4 of
    the unbroken run's."""
    main = runs["port"]["main"]
    unbroken = main["unbroken"]["runs"]
    assert main["unbroken"]["rc"] == 0 and len(unbroken) == 1
    error = main["error"]
    assert error["rc"] == 0 and error["in_world"]
    assert "rebuilt grid uses 4 ranks; 0 survivor(s)" in error["printed"]
    (resumed,) = error["runs"]
    assert (resumed["data_axis"], resumed["model_axis"]) == (2, 2)
    np.testing.assert_allclose(resumed["losses"], unbroken[0]["losses"][4:],
                               rtol=1e-4)


def test_main_rebuilds_a_smaller_grid_after_a_rank_loss(runs):
    """``main`` on 2x2 with rank 3 lost at step 5 (a ``DeviceLostError`` on
    every rank): 3 survivors make a 1x2 grid (the model axis kept), rank 2
    is dropped and leaves the world with rank 3; ranks 0 and 1 resume from
    the 2x2 checkpoint at step 4 on the 1x2 mesh, the rebuilt grid's shape
    passed on, and continue the loss curve: the first resumed loss (the
    checkpoint's weights) within 1e-5 of the unbroken run's, the later ones
    within 1e-3 — the SMOKE config is bf16, and a bf16 gradient summed over
    2 data ranks rounds apart from the one rank's (2e-4 seen)."""
    main = runs["port"]["main"]
    lost = main["lost"]
    assert lost["rc"] == 0 and lost["in_world"]
    assert "rebuilt grid uses 2 ranks; 1 survivor(s)" in lost["printed"]
    (resumed,) = lost["runs"]
    assert (resumed["data_axis"], resumed["model_axis"]) == (1, 2)
    unbroken = main["unbroken"]["runs"][0]["losses"][4:]
    np.testing.assert_allclose(resumed["losses"][0], unbroken[0], rtol=1e-5)
    np.testing.assert_allclose(resumed["losses"], unbroken, rtol=1e-3)
    for rank in (2, 3):
        with open(os.path.join(runs["tmp"], f"left_{rank}.json")) as fh:
            left = json.load(fh)
        assert left["rc"] == 0 and not left["in_world"] and not left["runs"]
        assert "outside the rebuilt grid" in left["printed"]
