"""The distributed 2-D slice of the port against the reference.

``repro_torch.core.pfft_dist`` runs on gloo worlds of 2 and 4 ranks on the
host (``device_type="cpu"``, the kernels' plain versions), each rank on its
own row block; ``repro.core.pfft_dist`` runs the same cases on a forced
2- and 4-device CPU.  Both read the same seeded numpy signal
(``_torch_dist_cases``), and every case agrees within ``2e-4·N``.  The
4-rank world is 2 emulated hosts x 2, so its hierarchical cases exchange in
two grouped stages.  Pipelined panels against the monolithic phase, and the
hierarchical exchange against the flat one, agree element for element.
"""

import numpy as np
import pytest

import _torch_dist_cases as cases

N = cases.N
TOL = 2e-4 * N
# Cases whose value is the plain 2-D DFT (the crop cases interpolate).
EXACT = [name for name in cases.COMPLEX_CASES
         if name not in ("crop", "crop_panels2", "grouped_pad")]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """({p: port result}, {p: reference result}) of every case."""
    return cases.run_job("pfft", str(tmp_path_factory.mktemp("pfft_dist")))


@pytest.mark.parametrize("p", cases.WORLDS)
@pytest.mark.parametrize("name", list(cases.COMPLEX_CASES))
def test_complex_case_matches_reference(worlds, p, name):
    port, ref = worlds
    assert port[p][name].shape == ref[p][name].shape == (N, N)
    np.testing.assert_allclose(port[p][name], ref[p][name], rtol=0, atol=TOL)


@pytest.mark.parametrize("p", cases.WORLDS)
@pytest.mark.parametrize("name", EXACT)
def test_complex_case_is_the_2d_dft(worlds, p, name):
    np.testing.assert_allclose(worlds[0][p][name], np.fft.fft2(cases.signal()),
                               rtol=0, atol=TOL)


def _crop_oracle(m: np.ndarray, length: int) -> np.ndarray:
    """The padded-signal DFT cropped to N bins, both phases."""
    def phase(mat):
        padded = np.pad(mat, ((0, 0), (0, length - mat.shape[1])))
        return np.fft.fft(padded, axis=-1)[:, :mat.shape[1]]
    return phase(phase(m).T).T


@pytest.mark.parametrize("p", cases.WORLDS)
@pytest.mark.parametrize("name,length", [("crop", cases.PAD_LEN),
                                         ("crop_panels2", cases.PAD_LEN),
                                         ("grouped_pad", 2 * N)])
def test_crop_case_is_the_padded_signal_dft(worlds, p, name, length):
    np.testing.assert_allclose(worlds[0][p][name],
                               _crop_oracle(cases.signal(), length),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("name", list(cases.HIER_CASES))
def test_hier_case_matches_reference(worlds, name):
    port, ref = worlds
    np.testing.assert_allclose(port[4][name], ref[4][name], rtol=0, atol=TOL)


@pytest.mark.parametrize("p", cases.WORLDS)
@pytest.mark.parametrize("name", [*cases.REAL_CASES,
                                  *("i" + n for n in cases.REAL_CASES)])
def test_real_case_matches_reference(worlds, p, name):
    port, ref = worlds
    assert port[p][name].shape == ref[p][name].shape
    np.testing.assert_allclose(port[p][name], ref[p][name], rtol=0, atol=TOL)


@pytest.mark.parametrize("p", cases.WORLDS)
@pytest.mark.parametrize("name", ["rfft", "rfft_radix4"])
def test_real_case_is_the_half_spectrum_and_inverts(worlds, p, name):
    x = cases.real_signal()
    port = worlds[0][p]
    assert port[name].shape == (N, N // 2 + 1)
    np.testing.assert_allclose(port[name], np.fft.rfft2(x), rtol=0, atol=TOL)
    np.testing.assert_allclose(port["i" + name], x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("p", cases.WORLDS)
@pytest.mark.parametrize("pipelined,monolithic", cases.EQUAL_PAIRS)
def test_pipelined_phase_equals_the_monolithic_one(worlds, p, pipelined,
                                                   monolithic):
    port = worlds[0][p]
    assert np.array_equal(port[pipelined], port[monolithic])


@pytest.mark.parametrize("hier,flat", cases.HIER_EQUAL_PAIRS)
def test_hier_exchange_equals_the_flat_one(worlds, hier, flat):
    port = worlds[0][4]
    assert np.array_equal(port[hier], port[flat])


def test_hier_pick_on_a_flat_mesh_runs_the_flat_exchange(worlds):
    port = worlds[0][2]
    assert np.array_equal(port["hier_on_flat"], port["plain"])


def test_hier_all_to_all_is_the_tiled_all_to_all(worlds):
    """Each rank's result of ``hier_all_to_all`` is what
    ``jax.lax.all_to_all(tiled=True)`` gives, written out in numpy."""
    m, p = cases.signal(), 4
    blocks = np.split(m, p)                                  # (N/p, N) each
    w, c = N // p, N // p // p
    # split columns, concatenate rows: rank r holds column panel r.
    want0 = np.concatenate([m[:, r * w:(r + 1) * w] for r in range(p)])
    # split rows, concatenate columns: rank r holds row chunk r of each block.
    want1 = np.concatenate([np.concatenate([b[r * c:(r + 1) * c]
                                            for b in blocks], axis=1)
                            for r in range(p)])
    port = worlds[0][4]
    assert np.array_equal(port["hier_all_to_all1"], want0)
    assert np.array_equal(port["hier_all_to_all0"], want1)


@pytest.mark.parametrize("p", cases.WORLDS)
@pytest.mark.parametrize("call,error", [
    ("panels_not_dividing", "ValueError"), ("not_a_row_block", "ValueError"),
    ("unknown_axis", "KeyError"), ("not_a_mesh", "TypeError"),
    ("real_fused", "ValueError"), ("real_panels", "ValueError"),
    ("real_hier", "ValueError"), ("real_complex_input", "ValueError"),
    ("config_and_legacy", "ValueError"), ("pad_conflict", "ValueError")])
def test_refusals_come_before_any_exchange(worlds, p, call, error):
    assert worlds[0][p]["errors"][call] == error
