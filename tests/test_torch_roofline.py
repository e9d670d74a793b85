"""The port's roofline (``repro_torch.launch.roofline``) and input specs
(``repro_torch.data.specs``) against the JAX package's: the HLO collective
parser on the reference's sample and more strings, ``model_flops`` and
``active_param_count`` for every arch x shape, ``param_count`` of every
FULL model (the port's made on fake tensors, the reference's from
``jax.eval_shape``), ``input_specs`` shape for shape and dtype for dtype,
all exact; ``roofline_terms`` under the H100's ``HW``; and ``StepCounter``
on small ops whose counts are worked out by hand."""

import dataclasses

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.data.specs as ref_specs
import repro.launch.roofline as ref_roof
import repro.models.registry as ref_registry
import repro.models.transformer as ref_T
import repro_torch.data.specs as port_specs
import repro_torch.launch.roofline as port_roof
import repro_torch.models.registry as port_registry
import repro_torch.models.transformer as port_T
from repro.configs.base import SHAPES as REF_SHAPES
from repro_torch.configs.base import SHAPES as PORT_SHAPES
from test_roofline import HLO_SAMPLE

ARCHS = list(ref_registry.ARCH_IDS)

MORE_HLO = [
    "",
    "%x = f32[4]{0} add(%a, %b)",
    # an async pair: the start's tuple counted, the done skipped
    "%s = (f32[16,8]{1,0}, f32[16,8]{1,0}) all-reduce-start(%p)\n"
    "%d = f32[16,8]{1,0} all-reduce-done(%s)",
    # scalar, pred and an unknown dtype (token) inside a tuple
    "%ar = (f32[], pred[3]{0}, token[]) all-reduce(%a, %b, %c)",
    "%cp = s32[2,3]{1,0} collective-permute-start(%q), source_target_pairs={{0,1}}",
    "%ag = bf16[128,1024]{1,0} ALL-GATHER(%p0)\n%rs = c64[2]{0} reduce-scatter(%z)",
    "%a2a = (s8[4]{0}, u16[2,2]{1,0}) all-to-all(%p, %q), dimensions={0}",
    HLO_SAMPLE + "\n%ag2 = f64[10]{0} all-gather(%p9)",
]


@pytest.mark.parametrize("text", [HLO_SAMPLE] + MORE_HLO)
def test_collective_bytes_equals_the_reference(text):
    assert port_roof.collective_bytes(text) == ref_roof.collective_bytes(text)


def test_hw_holds_the_h100_datasheet_figures():
    hw = port_roof.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw) == (989e12, 3.35e12, 50e9)
    assert [f.name for f in dataclasses.fields(hw)] == \
        [f.name for f in dataclasses.fields(ref_roof.HW())]


def test_roofline_terms_math_on_the_h100():
    cost = {"flops": 989e12, "bytes accessed": 3.35e12}
    terms = port_roof.roofline_terms(cost, HLO_SAMPLE, chips=4, mflops=100e12)
    assert terms.compute_s == 1.0 and terms.memory_s == 1.0
    coll = ref_roof.collective_bytes(HLO_SAMPLE)
    assert terms.coll_bytes == coll
    assert terms.collective_s == sum(coll.values()) / 50e9
    assert terms.flops == 4 * 989e12 and terms.bytes_accessed == 4 * 3.35e12
    assert terms.dominant == "compute" and terms.bound_s == 1.0
    assert terms.useful_ratio == 100e12 / (4 * 989e12)
    assert terms.roofline_fraction == 100e12 / (1.0 * 4 * 989e12)
    d = terms.to_dict()
    ref = ref_roof.roofline_terms(cost, HLO_SAMPLE, chips=4, mflops=100e12)
    assert list(d) == list(ref.to_dict())
    assert d["dominant"] == "compute"
    # the same terms' arithmetic as the reference's, constants aside
    ref_h100 = ref_roof.roofline_terms(cost, HLO_SAMPLE, chips=4, mflops=100e12,
                                       hw=ref_roof.HW(989e12, 3.35e12, 50e9))
    for k in ("compute_s", "memory_s", "collective_s", "flops",
              "bytes_accessed", "coll_bytes", "model_flops", "chips",
              "dominant", "useful_ratio"):
        assert d[k] == ref_h100.to_dict()[k], k
    empty = port_roof.roofline_terms({}, "", chips=1, mflops=0.0)
    assert empty.dominant == "compute" and empty.bound_s == 0.0


def test_roofline_terms_take_counted_collectives():
    """The port's collective bytes (a ``StepCounter``'s, by kind) give the
    collective term as the same bytes parsed off HLO text would."""
    cost = {"flops": 989e12, "bytes accessed": 3.35e12}
    coll = ref_roof.collective_bytes(HLO_SAMPLE)
    parsed = port_roof.roofline_terms(cost, HLO_SAMPLE, chips=4, mflops=100e12)
    counted = port_roof.roofline_terms(cost, "", chips=4, mflops=100e12,
                                       coll_bytes=coll)
    assert counted.to_dict() == parsed.to_dict()
    assert counted.coll_bytes is not coll
    # counted bytes replace the text's
    only = port_roof.roofline_terms(cost, HLO_SAMPLE, chips=4, mflops=100e12,
                                    coll_bytes={"all-reduce": 50e9})
    assert only.coll_bytes == {"all-reduce": 50e9} and only.collective_s == 1.0


@pytest.fixture(scope="module")
def ref_param_counts():
    return {arch: ref_roof.param_count(jax.eval_shape(
        lambda a=arch: ref_T.init_params(jax.random.PRNGKey(0),
                                         ref_registry.get_config(a))))
        for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_of_the_full_model_on_fake_tensors(arch, ref_param_counts):
    """The FULL model made on fake tensors (nothing allocated) holds the
    reference's parameter count, zamba2's padded Mamba2 blocks included."""
    cfg = port_registry.get_config(arch)
    with FakeTensorMode():
        gen = torch.Generator()
        model = port_T.init_params(gen, cfg, device="cpu")
        n = port_roof.param_count(model)
        assert n == port_roof.param_count(list(model.parameters()))
    assert n == ref_param_counts[arch]
    if arch == "zamba2_7b":
        assert sum(len(group) for group in model.mamba) == 84 > cfg.n_layers == 81


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_active_params_equal_the_reference(arch, ref_param_counts):
    n = ref_param_counts[arch]
    ref_cfg, port_cfg = ref_registry.get_config(arch), port_registry.get_config(arch)
    n_active = port_roof.active_param_count(port_cfg, n)
    assert n_active == ref_roof.active_param_count(ref_cfg, n)
    for name in REF_SHAPES:
        for active in (None, n_active):
            assert port_roof.model_flops(port_cfg, PORT_SHAPES[name], n, active) == \
                ref_roof.model_flops(ref_cfg, REF_SHAPES[name], n, active), name


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    ref_cfg, port_cfg = ref_registry.get_config(arch), port_registry.get_config(arch)
    for name in REF_SHAPES:
        ref = ref_specs.input_specs(ref_cfg, REF_SHAPES[name])
        port = port_specs.input_specs(port_cfg, PORT_SHAPES[name])
        assert list(port) == list(ref), name
        for k, spec in ref.items():
            assert tuple(port[k].shape) == tuple(spec.shape), (name, k)
            assert str(port[k].dtype) == f"torch.{spec.dtype}", (name, k)
            assert port[k].device.type == "meta"


def test_step_counter_counts_by_hand():
    """A matmul, an add, a view, an in-place op and a freed temporary: the
    FLOPs, the bytes of inputs and outputs, the peak of new storages."""
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    with port_roof.StepCounter() as c:
        x = a @ b                  # 2·64·32·16 FLOPs; 8 KiB + 2 KiB in, 4 KiB out
        y = x + 1                  # 4 KiB in, 4 KiB out
        del x
        y.view(-1)                 # a view: nothing
        y.mul_(2)                  # 4 KiB in, 4 KiB out, no new storage
        z = y.sum()                # 4 KiB in, 4 B out
    assert c.flops == 2 * 64 * 32 * 16
    assert c.bytes_accessed == (8192 + 2048 + 4096) + 2 * 4096 + 2 * 4096 + 4096 + 4
    assert c.peak_bytes == 2 * 4096           # x and y live together
    assert c.live == 4096 + 4                 # y and z remain
    assert c.cost() == {"flops": float(c.flops),
                        "bytes accessed": float(c.bytes_accessed)}
    assert c.coll_bytes == {} and z.shape == ()


def test_tensor_bytes_counts_each_storage_once():
    m = torch.nn.Linear(4, 3)
    t = torch.zeros(10)
    tree = {"m": m, "pair": (t, t[:5]), "list": [torch.zeros(2, dtype=torch.int8)]}
    assert port_roof.tensor_bytes(tree) == (12 + 3) * 4 + 40 + 2
