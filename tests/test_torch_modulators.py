"""The port's digital modulators and the OFDM one-tap equalizer against
the JAX package on the same numpy inputs.

Constellations, Gray mappings and theoretical curves are host numpy in
both packages and must agree to float64 rounding. ``modulate`` and the
hard decisions run on tensors: the same integers give the same points
(1e-6, float32), and noisy points give the same decisions (exact: the
test points keep a margin of 1e-3 from every decision boundary). The
equalizer agrees to 1e-5 relative to the equalized values' scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu.channels import fading as J_fading  # noqa: E402
from pyphysim_tpu.modulators import fundamental as J_mod  # noqa: E402
from pyphysim_tpu.modulators import OFDM as J_OFDM  # noqa: E402
from pyphysim_tpu.modulators.ofdm import \
    OfdmOneTapEqualizer as J_Equalizer  # noqa: E402
from pyphysim_tpu.ops.cplx import CArray  # noqa: E402
from pyphysim_tpu_torch.channels import TdlImpulseResponse, fading  # noqa: E402
from pyphysim_tpu_torch.modulators import (BPSK, OFDM, PSK,  # noqa: E402
                                           QAM, QPSK, OfdmOneTapEqualizer)

MODULATORS = {
    "QAM4": (lambda: QAM(4, device="cpu"), lambda: J_mod.QAM(4)),
    "QAM16": (lambda: QAM(16, device="cpu"), lambda: J_mod.QAM(16)),
    "QAM64": (lambda: QAM(64, device="cpu"), lambda: J_mod.QAM(64)),
    "PSK8": (lambda: PSK(8, device="cpu"), lambda: J_mod.PSK(8)),
    "QPSK": (lambda: QPSK(device="cpu"), lambda: J_mod.QPSK()),
    "BPSK": (lambda: BPSK(device="cpu"), lambda: J_mod.BPSK()),
}


def _carray(a):
    return CArray(jnp.asarray(a.real, jnp.float32),
                  jnp.asarray(a.imag, jnp.float32))


def _away_from_boundaries(mine, rx):
    """Keep the received points whose nearest and second-nearest
    constellation points differ in distance by more than 1e-3."""
    d = np.sort(np.abs(rx[:, None] - mine.symbols[None, :]), axis=1)
    return rx[d[:, 1] - d[:, 0] > 1e-3]


@pytest.mark.parametrize("name", list(MODULATORS))
def test_modulator_matches_jax(name):
    make, make_j = MODULATORS[name]
    mine, j = make(), make_j()
    assert (mine.M, mine.K, mine.name) == (j.M, j.K, j.name)
    np.testing.assert_allclose(mine.symbols, j.symbols, atol=1e-12)
    rng = np.random.default_rng(mine.M)
    data = rng.integers(0, mine.M, (3, 200))

    # host numpy in, numpy out
    np.testing.assert_allclose(mine.modulate(data), j.modulate(data),
                               atol=1e-12)
    # tensors: the same points as the JAX device path
    tx = mine.modulate(torch.from_numpy(data))
    assert tx.dtype == torch.complex64 and tx.shape == (3, 200)
    j_tx = j.modulate(jnp.asarray(data, jnp.int32)).to_numpy()
    np.testing.assert_allclose(tx.numpy(), j_tx, atol=1e-6, rtol=0)

    # nearest-neighbour decisions on noisy points
    rx = (j.symbols[data.ravel()] + 0.4 * (
        rng.standard_normal(data.size) + 1j * rng.standard_normal(
            data.size))).astype(np.complex64)
    rx = _away_from_boundaries(mine, rx)
    got = mine.demodulate(torch.from_numpy(rx))
    want = np.asarray(j.demodulate(_carray(rx)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(mine.demodulate(rx), j.demodulate(rx))
    if isinstance(mine, QAM):
        hard = mine.demodulate_hard(torch.from_numpy(rx))
        np.testing.assert_array_equal(
            hard.numpy(), np.asarray(j.demodulate_hard(_carray(rx))))
        np.testing.assert_array_equal(hard.numpy(), got.numpy())

    snr = np.array([0.0, 5.0, 10.0, 20.0])
    for curve in ("calcTheoreticalSER", "calcTheoreticalBER"):
        np.testing.assert_allclose(getattr(mine, curve)(snr),
                                   np.asarray(getattr(j, curve)(snr)),
                                   rtol=1e-6)


@pytest.mark.parametrize("name", list(MODULATORS))
def test_packet_error_rate_and_spectral_efficiency_match_jax(name):
    make, make_j = MODULATORS[name]
    mine, j = make(), make_j()
    snr = np.array([-5.0, 0.0, 5.0, 10.0, 20.0])
    for length in (1, 20, 1500):
        np.testing.assert_allclose(
            mine.calcTheoreticalPER(snr, length),
            np.asarray(j.calcTheoreticalPER(snr, length)), rtol=1e-6)
        np.testing.assert_allclose(
            mine.calcTheoreticalSpectralEfficiency(snr, length),
            np.asarray(j.calcTheoreticalSpectralEfficiency(snr, length)),
            rtol=1e-6)
    np.testing.assert_allclose(
        mine.calcTheoreticalSpectralEfficiency(snr),
        np.asarray(j.calcTheoreticalSpectralEfficiency(snr)), rtol=1e-6)
    assert mine.calcTheoreticalSpectralEfficiency(40.0) == \
        pytest.approx(mine.K)


@pytest.mark.parametrize("M, offset", [(8, 0.3), (16, -1.1), (4, np.pi)])
def test_psk_set_phase_offset_matches_jax(M, offset):
    mine, j = PSK(M, device="cpu"), J_mod.PSK(M)
    mine.setPhaseOffset(offset)
    j.setPhaseOffset(offset)
    np.testing.assert_allclose(mine.symbols, j.symbols, atol=1e-12)
    np.testing.assert_allclose(mine.symbols, PSK(M, offset,
                                                 device="cpu").symbols,
                               atol=0)
    data = np.arange(M).repeat(3)
    tx = mine.modulate(torch.from_numpy(data))    # the device table
    np.testing.assert_allclose(
        tx.numpy(), j.modulate(jnp.asarray(data, jnp.int32)).to_numpy(),
        atol=1e-6, rtol=0)
    assert np.array_equal(mine.demodulate(tx).numpy(), data)


def test_plot_constellation():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt
    PSK(8, device="cpu").plotConstellation()
    ax = plt.gcf().axes[0]
    assert len(ax.texts) == 8 and ax.texts[5].get_text() == "101 (5)"
    plt.close("all")


def test_modulator_rejects_bad_input():
    with pytest.raises(ValueError):
        QAM(8, device="cpu")
    with pytest.raises(ValueError):
        PSK(6, device="cpu")
    with pytest.raises(ValueError, match="between"):
        QAM(16, device="cpu").modulate(np.array([16]))


@pytest.mark.parametrize("per_sample", [True, False])
def test_one_tap_equalizer_matches_jax(per_sample):
    """Per-sample taps (num_samples = n_sym * samples_per_symbol) and
    block-static taps (one sample per OFDM symbol), with a batch of 2 on
    the port's side."""
    rng = np.random.default_rng(7)
    fft, cp, used, n_sym = 128, 44, 96, 3
    ofdm, j_ofdm = OFDM(fft, cp, used, device="cpu"), J_OFDM(fft, cp, used)
    profile = fading.COST259_TUx.get_discretize_profile(1 / 20e6)
    j_profile = J_fading.COST259_TUx.get_discretize_profile(1 / 20e6)
    ns = n_sym * ofdm.samples_per_symbol if per_sample else n_sym
    taps = ((rng.standard_normal((2, 16, ns)) + 1j * rng.standard_normal(
        (2, 16, ns))) * 0.25).astype(np.complex64)
    data = ((rng.standard_normal((2, n_sym * used)) + 1j *
             rng.standard_normal((2, n_sym * used)))).astype(np.complex64)
    ir = TdlImpulseResponse.from_numpy(taps, profile, device="cpu")
    got = OfdmOneTapEqualizer(ofdm).equalize_data(torch.from_numpy(data), ir)
    assert got.shape == (2, n_sym * used)
    for b in range(2):
        j_ir = J_fading.TdlImpulseResponse(_carray(taps[b]), j_profile)
        want = J_Equalizer(j_ofdm).equalize_data(_carray(data[b]),
                                                 j_ir).to_numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[b].numpy() / scale, want / scale,
                                   atol=1e-5, rtol=0)


def test_one_tap_equalizer_takes_any_freq_response():
    """An object with only ``get_freq_response`` is averaged in the
    frequency domain; for an impulse response that is the same result
    as the tap-domain average (the DFT is linear)."""
    rng = np.random.default_rng(8)
    ofdm = OFDM(64, 16, 48, device="cpu")
    profile = fading.TdlChannelProfile(np.zeros(3), np.array([0, 2, 5]))
    profile = profile.get_discretize_profile(1.0)
    taps = torch.from_numpy((rng.standard_normal((3, 2 * 80)) + 1j *
                             rng.standard_normal((3, 2 * 80))
                             ).astype(np.complex64))
    ir = TdlImpulseResponse(taps, profile)

    class FreqOnly:
        def get_freq_response(self, n):
            return ir.get_freq_response(n)

    data = torch.from_numpy((rng.standard_normal(2 * 48) + 1j *
                             rng.standard_normal(2 * 48)).astype(np.complex64))
    eq = OfdmOneTapEqualizer(ofdm)
    a = eq.equalize_data(data, ir)
    b = eq.equalize_data(data, FreqOnly())
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


# -- the symbol map (ops/qam.py) and the decision with its bit count ---------
#
# On CPU tensors ``qam_map`` and ``sc_decide`` with a unit gain (the chain
# step's decision and count) run their plain versions, which must be the
# arithmetic the port ran op by op before the kernels (``_op_by_op_*``
# below, bit for bit). The kernels' arithmetic, emulated in numpy float32
# with the scalars rounded to float32 as torch passes them to its kernels,
# must equal the plain versions too; the ``cuda``-marked cases hold each
# kernel to its plain version on the card.

QAM_ORDERS = [4, 16, 64, 256]


def _op_by_op_modulate(data, M):
    """``QAM.modulate``'s tensor route as the port ran it op by op."""
    L = int(round(np.sqrt(M)))
    half = int(round(np.log2(M))) // 2
    col, row = data & (L - 1), data >> half
    jj, ii = col ^ (col >> 1), row ^ (row >> 1)
    inv_scale = 1.0 / np.sqrt((M - 1) * 2.0 / 3.0)
    return torch.complex((2 * jj - (L - 1)).to(torch.float32) * inv_scale,
                         ((L - 1) - 2 * ii).to(torch.float32) * inv_scale)


def _op_by_op_bit_errors(received, data, M):
    """``count_bit_errors(data, QAM.demodulate_hard(received), axis=-1)``
    as the port ran it op by op."""
    from pyphysim_tpu_torch.utils.misc import count_bit_errors
    L = int(round(np.sqrt(M)))
    half = int(round(np.log2(M))) // 2
    scale = float(np.sqrt((M - 1) * 2.0 / 3.0))

    def inv_gray(p):
        for sh in (1, 2, 4):
            p = p ^ (p >> sh)
        return p
    col = torch.clamp(torch.round((received.real * scale + (L - 1)) / 2.0),
                      0, L - 1).to(torch.int64)
    row = torch.clamp(torch.round(((L - 1) - received.imag * scale) / 2.0),
                      0, L - 1).to(torch.int64)
    decided = (inv_gray(row) << half) | inv_gray(col)
    return count_bit_errors(data, decided, axis=-1)


def _axis_values(M, seed):
    """float32 values of one axis: noisy levels, the exact half-level ties
    and their float32 neighbours, values far outside the grid (clamped),
    both signed zeros and infinities."""
    L = int(round(np.sqrt(M)))
    scale = np.float32(np.sqrt((M - 1) * 2.0 / 3.0))
    rng = np.random.default_rng(seed)
    levels = (2 * rng.integers(0, L, 3000) - (L - 1)) / scale
    noisy = levels + 0.6 * rng.standard_normal(3000) / scale
    ties = (np.arange(-L - 2, L + 3) / scale).astype(np.float32)
    near = np.concatenate([np.nextafter(ties, np.float32(-np.inf)), ties,
                           np.nextafter(ties, np.float32(np.inf))])
    far = np.array([0.0, -0.0, 40.0, -40.0, 3e38, -3e38, np.inf, -np.inf])
    return np.concatenate([noisy, near, far]).astype(np.float32)


def _received(M, seed, rows):
    """(rows, S) complex64 points over every pair of the axis values'
    real parts with a shuffle of them as imaginary parts."""
    re = _axis_values(M, seed)
    im = np.random.default_rng(seed + 1).permutation(re)
    S = re.size - re.size % rows
    return torch.complex(torch.from_numpy(re[:S].copy()),
                         torch.from_numpy(im[:S].copy())).reshape(rows, -1)


def _bits(t):
    return torch.view_as_real(t).contiguous().view(torch.int32)


def _unit_gain_decide(received, sent, M, plain=False):
    """(rows,) bit errors of the decisions on ``received`` (rows, S)
    against ``sent``: ``sc_decide`` (or its plain version) with a unit
    gain, as ``ChainStep`` counts."""
    from pyphysim_tpu_torch.ops.mimo_detect import (sc_decide,
                                                    sc_decide_reference)
    unit = torch.ones(received.shape[0], 1, device=received.device)
    fn = sc_decide_reference if plain else sc_decide
    return fn(received[:, None], unit, sent[:, None], M)


def _emulated_map(data, M, gain=None):
    """The kernel's map in numpy: int64 Gray codes, the levels cast to
    float32, multiplied by float32 ``1 / scale`` (then by float32
    ``gain``), each product rounded on its own."""
    L = int(round(np.sqrt(M)))
    half = int(round(np.log2(M))) // 2
    col, row = data & (L - 1), data >> half
    jj, ii = col ^ (col >> 1), row ^ (row >> 1)
    inv = np.float32(1.0 / np.sqrt((M - 1) * 2.0 / 3.0))
    re = (2 * jj - (L - 1)).astype(np.float32) * inv
    im = ((L - 1) - 2 * ii).astype(np.float32) * inv
    if gain is not None:
        re, im = re * np.float32(gain), im * np.float32(gain)
    return re, im


def _emulated_decisions(received, M):
    """The kernel's slicer in numpy (``mmse.cuh`` ``level`` on the real
    part and on minus the imaginary part, ``inv_gray``)."""
    L = int(round(np.sqrt(M)))
    half = int(round(np.log2(M))) // 2
    scale = np.float32(np.sqrt((M - 1) * 2.0 / 3.0))

    def level(v):
        t = (v * scale + np.float32(L - 1)) * np.float32(0.5)
        return np.minimum(np.maximum(np.rint(t), 0), L - 1).astype(np.int64)

    def inv_gray(p):
        return p ^ (p >> 1) ^ (p >> 2) ^ (p >> 3) ^ (p >> 4) ^ (p >> 5) ^ \
            (p >> 6) ^ (p >> 7)
    with np.errstate(invalid="ignore", over="ignore"):
        return (inv_gray(level(-received.imag)) << half) | \
            inv_gray(level(received.real))


@pytest.mark.parametrize("M", QAM_ORDERS)
def test_qam_map_plain_route_is_the_op_by_op_arithmetic(M):
    from pyphysim_tpu_torch.ops.qam import qam_map, qam_map_reference
    qam = QAM(M, device="cpu")
    every = torch.arange(M)
    draws = torch.from_numpy(np.random.default_rng(M).integers(
        0, M, (32, 9600)))
    for data in (every, draws, draws.to(torch.int32)):
        want = _op_by_op_modulate(data, M)
        for got in (qam.modulate(data), qam_map(data, M),
                    qam_map_reference(data, M)):
            assert got.dtype == torch.complex64 and got.shape == data.shape
            assert torch.equal(_bits(got), _bits(want))
        for gain in (0.5, 1 / np.sqrt(2), 1 / np.sqrt(3)):
            assert torch.equal(_bits(qam_map(data, M, gain)),
                               _bits(want * gain))
    np.testing.assert_allclose(qam.modulate(every).numpy(), qam.symbols,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("M", QAM_ORDERS)
def test_qam_map_kernel_arithmetic_is_the_plain_version(M):
    """Indices past the grid and negative ones too: the kernel's int64
    arithmetic is the plain version's for any index."""
    from pyphysim_tpu_torch.ops.qam import qam_map_reference
    data = np.concatenate([np.arange(-3, M + 40),
                           np.random.default_rng(M).integers(0, M, 5000)])
    for gain in (None, 0.5, 1 / np.sqrt(2)):
        re, im = _emulated_map(data, M, gain)
        got = qam_map_reference(torch.from_numpy(data), M, gain)
        np.testing.assert_array_equal(got.real.numpy().view(np.uint32),
                                      re.view(np.uint32))
        np.testing.assert_array_equal(got.imag.numpy().view(np.uint32),
                                      im.view(np.uint32))


@pytest.mark.parametrize("M", QAM_ORDERS)
def test_unit_gain_decision_plain_route_is_the_op_by_op_arithmetic(M):
    from pyphysim_tpu_torch.ops.qam import qam_slice
    received = _received(M, 11 * M, rows=8)
    data = torch.from_numpy(np.random.default_rng(M).integers(
        0, M, tuple(received.shape)))
    want = _op_by_op_bit_errors(received, data, M)
    assert want.shape == (8,) and want.dtype == torch.int64
    assert int(want.sum()) > 0
    for got in (_unit_gain_decide(received, data, M),
                _unit_gain_decide(received, data, M, plain=True),
                _unit_gain_decide(received, data.to(torch.int32), M)):
        assert got.dtype == torch.int64 and torch.equal(got, want)
    decided = qam_slice(received, M)
    assert torch.equal(QAM(M, device="cpu").demodulate_hard(received),
                       decided)
    # the kernel's slicer, emulated
    np.testing.assert_array_equal(decided.numpy(),
                                  _emulated_decisions(received.numpy(), M))
    # a decision on the sent points is the sent index
    sent = torch.arange(M).repeat(3).reshape(3, M)
    pts = _op_by_op_modulate(sent, M)
    assert torch.equal(_unit_gain_decide(pts, sent, M), torch.zeros(
        3, dtype=torch.int64))


def test_qam_wrappers_reject_what_they_cannot_take():
    from pyphysim_tpu_torch.ops.qam import qam_map, qam_slice
    data = torch.arange(16)
    with pytest.raises(ValueError, match="square QAM"):
        qam_map(data, 8)
    with pytest.raises(ValueError, match="square QAM"):
        qam_slice(torch.zeros(4, dtype=torch.complex64), 32)
    with pytest.raises(ValueError, match="square QAM"):
        _unit_gain_decide(torch.zeros(1, 4, dtype=torch.complex64),
                          data[None, :4], 1024)
    with pytest.raises(TypeError, match="integer"):
        qam_map(data.float(), 16)
    with pytest.raises(RuntimeError, match="no route"):
        qam_map(data.to("meta"), 16)


def test_qam_plain_routes_count_their_calls():
    from pyphysim_tpu_torch.ops.mimo_detect import sc_decide
    from pyphysim_tpu_torch.ops.qam import qam_map
    before = (qam_map.launch_count, qam_map.reference_count,
              sc_decide.launch_count, sc_decide.reference_count)
    pts = qam_map(torch.arange(16), 16)
    _unit_gain_decide(pts[None], torch.arange(16)[None], 16)
    after = (qam_map.launch_count, qam_map.reference_count,
             sc_decide.launch_count, sc_decide.reference_count)
    assert [a - b for a, b in zip(after, before)] == [0, 1, 0, 1]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("M", QAM_ORDERS)
def test_qam_map_kernel_is_its_plain_version_on_the_card(M):
    _needs_card()
    from pyphysim_tpu_torch.ops.qam import qam_map, qam_map_reference
    data = torch.from_numpy(np.concatenate([
        np.arange(-3, M + 40), np.random.default_rng(M).integers(
            0, M, 32 * 9600)])).cuda()
    for d in (data, data[:32 * 9600].reshape(32, 9600), data.to(torch.int32),
              data[::3]):
        for gain in (None, 0.5, 1 / np.sqrt(2)):
            before = qam_map.launch_count
            got = qam_map(d, M, gain)
            assert qam_map.launch_count == before + 1
            want = qam_map_reference(d, M, gain)
            assert got.shape == d.shape
            assert torch.equal(_bits(got), _bits(want)), (M, gain)
    assert qam_map(data[:0], M).shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("M", QAM_ORDERS)
def test_unit_gain_decision_kernel_is_its_plain_version_on_the_card(M):
    _needs_card()
    from pyphysim_tpu_torch.ops.mimo_detect import sc_decide
    for rows in (1, 8, 37):
        received = _received(M, 5 * M + rows, rows).cuda()
        data = torch.from_numpy(np.random.default_rng(rows).integers(
            0, M, tuple(received.shape))).cuda()
        before = sc_decide.launch_count
        got = _unit_gain_decide(received, data, M)
        assert sc_decide.launch_count == before + 1
        want = _unit_gain_decide(received, data, M, plain=True)
        assert torch.equal(got, want), (M, rows)
        assert torch.equal(got.cpu(), _op_by_op_bit_errors(
            received.cpu(), data.cpu(), M))
    # a long row: several blocks add to one count
    received = _received(M, 3, 1).repeat(1, 40).cuda()
    data = torch.zeros(received.shape, dtype=torch.int64, device="cuda")
    assert torch.equal(_unit_gain_decide(received, data, M),
                       _unit_gain_decide(received, data, M, plain=True))
