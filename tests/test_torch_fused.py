"""The port's fused OFDM-over-TDL path (``ops/fused_ofdm_tdl.py``).

* diag mode against spectrum mode on the same state (``atol`` 1e-5);
* fused against the port's own block-static time-domain chain, noiseless:
  demodulated symbols within 2e-4 and equalized within 5e-4, the bounds of
  the JAX package's ``tests/test_fused_ofdm_tdl.py``;
* fused against the JAX package's fused path on one carried-across state;
* ``noise_gain``: white CN(0, 1) time-domain noise, demodulated, has that
  standard deviation per bin;
* a cyclic prefix shorter than the channel span, and an unknown mode, are
  rejected.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu.channels import fading as J_fading  # noqa: E402
from pyphysim_tpu.channels.fading_generators import \
    JakesSampleGenerator as J_Jakes  # noqa: E402
from pyphysim_tpu.channels.fading_generators import \
    JakesState as J_JakesState  # noqa: E402
from pyphysim_tpu.modulators import OFDM as J_OFDM  # noqa: E402
from pyphysim_tpu.ops.cplx import CArray  # noqa: E402
from pyphysim_tpu.ops.fused_ofdm_tdl import \
    FusedOfdmTdl as J_Fused  # noqa: E402
from pyphysim_tpu_torch.channels import (COST259_TUx,  # noqa: E402
                                         JakesSampleGenerator, JakesState,
                                         TdlChannel)
from pyphysim_tpu_torch.modulators import (OFDM, QAM,  # noqa: E402
                                           OfdmOneTapEqualizer)
from pyphysim_tpu_torch.ops.fused_ofdm_tdl import FusedOfdmTdl  # noqa: E402

TS = 1.0 / 20e6
FFT, CP, USED, NSYM = 256, 48, 192, 6


def _setup(batch=2, seed=0):
    ofdm = OFDM(FFT, CP, USED, device="cpu")
    channel = TdlChannel(JakesSampleGenerator(Fd=30.0, Ts=TS, L=8,
                                              device="cpu"), COST259_TUx)
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, (batch, 8, 16, 1)).astype(np.float32)
    psi = rng.uniform(0, 2 * np.pi, (batch, 8, 16, 1)).astype(np.float32)
    t0 = rng.uniform(0, 1e-2, batch).astype(np.float32)
    qam = QAM(16, device="cpu")
    data = torch.from_numpy(rng.integers(0, 16, (batch, NSYM * USED)))
    return ofdm, channel, (phi, psi, t0), qam.modulate(data)


def _state(arrays):
    return JakesState.from_numpy(*arrays, device="cpu")


def test_diag_matches_spectrum():
    ofdm, channel, arrays, tx = _setup()
    r_diag, ir_d, s_d = FusedOfdmTdl(ofdm, channel, "diag") \
        .corrupt_and_demodulate(_state(arrays), tx)
    fop = FusedOfdmTdl(ofdm, channel, "spectrum")
    assert fop.mode == "spectrum"
    r_spec, ir_s, s_s = fop.corrupt_and_demodulate(_state(arrays), tx)
    assert r_diag.shape == tx.shape
    np.testing.assert_allclose(r_diag.numpy(), r_spec.numpy(), atol=1e-5,
                               rtol=0)
    assert torch.equal(ir_d.tap_values_sparse, ir_s.tap_values_sparse)
    assert torch.equal(s_d.t0, s_s.t0)


def test_fused_matches_time_domain_chain():
    ofdm, channel, arrays, tx = _setup()
    sig = ofdm.modulate(tx)
    rx_sig, ir_t, _ = channel.corrupt_data(
        _state(arrays), sig, block_size=ofdm.samples_per_symbol)
    demod_t = ofdm.demodulate(rx_sig[..., :sig.shape[-1]])
    rx_f, ir_f, _ = FusedOfdmTdl(ofdm, channel).corrupt_and_demodulate(
        _state(arrays), tx)
    np.testing.assert_allclose(rx_f.numpy(), demod_t.numpy(), atol=2e-4,
                               rtol=0)
    np.testing.assert_allclose(ir_f.tap_values_sparse.numpy(),
                               ir_t.tap_values_sparse.numpy(), atol=1e-5,
                               rtol=0)
    eq = OfdmOneTapEqualizer(ofdm)
    np.testing.assert_allclose(eq.equalize_data(rx_f, ir_f).numpy(),
                               eq.equalize_data(demod_t, ir_t).numpy(),
                               atol=5e-4, rtol=0)


@pytest.mark.parametrize("mode", ["diag", "spectrum"])
def test_fused_matches_jax(mode):
    ofdm, channel, (phi, psi, t0), tx = _setup(batch=1, seed=3)
    rx, _, _ = FusedOfdmTdl(ofdm, channel, mode).corrupt_and_demodulate(
        _state((phi, psi, t0)), tx)
    j_ofdm = J_OFDM(FFT, CP, USED)
    j_channel = J_fading.TdlChannel(J_Jakes(Fd=30.0, Ts=TS, L=8),
                                    J_fading.COST259_TUx)
    j_state = J_JakesState(jnp.asarray(phi[0]), jnp.asarray(psi[0]),
                           jnp.asarray(t0[0]))
    x = tx[0].numpy()
    j_rx, _, _ = J_Fused(j_ofdm, j_channel, mode).corrupt_and_demodulate(
        j_state, CArray(jnp.asarray(x.real), jnp.asarray(x.imag)))
    np.testing.assert_allclose(rx[0].numpy(), j_rx.to_numpy(), atol=2e-4,
                               rtol=0)
    assert FusedOfdmTdl(ofdm, channel).noise_gain == pytest.approx(
        J_Fused(j_ofdm, j_channel).noise_gain, rel=1e-12)


def test_noise_gain_is_the_demodulated_noise_std():
    ofdm, channel, _, _ = _setup()
    fop = FusedOfdmTdl(ofdm, channel)
    rng = np.random.default_rng(9)
    n = 400 * ofdm.samples_per_symbol
    noise = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) *
             np.sqrt(0.5)).astype(np.complex64)
    demod = ofdm.demodulate(torch.from_numpy(noise))
    std = float(demod.abs().pow(2).mean().sqrt())
    # 400 * 192 samples: the std estimate is within 1 % (> 5 sigma)
    assert std == pytest.approx(fop.noise_gain, rel=1e-2)
    assert fop.noise_gain == pytest.approx(
        np.sqrt(FFT / ofdm._calculate_power_scale()), rel=1e-12)


def test_rejects_short_cp_and_unknown_mode():
    _, channel, _, _ = _setup()
    with pytest.raises(ValueError, match="cp_size"):
        FusedOfdmTdl(OFDM(256, 16, 192, device="cpu"), channel)
    with pytest.raises(ValueError, match="mode"):
        FusedOfdmTdl(OFDM(FFT, CP, USED, device="cpu"), channel, "bogus")
