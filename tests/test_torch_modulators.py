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
