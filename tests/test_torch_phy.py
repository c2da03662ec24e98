"""The port's PHY modules against the JAX package on the same numpy inputs.

OFDM modulate/demodulate (torch.fft vs the JAX matmul-DFT), the Jakes
generator from the same explicit state, the discretized COST259 profiles,
and the conversion and bit-counting helpers. Float outputs agree to 1e-5
(float32 rounding of two different transform algorithms).
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
from pyphysim_tpu.utils import conversion as J_conv  # noqa: E402
from pyphysim_tpu.utils import misc as J_misc  # noqa: E402
from pyphysim_tpu_torch.channels import fading  # noqa: E402
from pyphysim_tpu_torch.channels import (JakesSampleGenerator,  # noqa: E402
                                         JakesState, TdlChannel)
from pyphysim_tpu_torch.modulators import OFDM  # noqa: E402
from pyphysim_tpu_torch.utils import conversion, misc  # noqa: E402

TS = 1.0 / 20e6


def _symbols(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("fft,cp,used,n", [
    (512, 52, 300, 3 * 300),
    (512, 52, 300, 2 * 300 + 17),   # zero-padded tail
    (64, 8, 32, 5 * 32),
    (64, 0, 64, 2 * 64),            # degenerate: bin 32 mapped twice
    (64, 0, 48, 3 * 48),
])
def test_ofdm_matches_jax(fft, cp, used, n):
    rng = np.random.default_rng(fft + cp + n)
    x = _symbols(rng, 2, n)
    j = J_OFDM(fft, cp, used)
    mine = OFDM(fft, cp, used, device="cpu")
    np.testing.assert_array_equal(mine.get_used_subcarrier_indexes(),
                                  j.get_used_subcarrier_indexes())
    assert mine.samples_per_symbol == j.samples_per_symbol
    assert mine._calculate_power_scale() == j._calculate_power_scale()

    tx_j = j.modulate(x)
    tx = mine.modulate(torch.from_numpy(x))
    assert tx.dtype == torch.complex64 and tx.shape == tx_j.shape
    np.testing.assert_allclose(tx.numpy(), tx_j, atol=1e-5, rtol=0)

    y = _symbols(rng, 2, tx_j.shape[-1])
    rx_j = j.demodulate(y)
    rx = mine.demodulate(torch.from_numpy(y))
    np.testing.assert_allclose(rx.numpy(), rx_j, atol=1e-5, rtol=0)
    if used < fft:  # with used == fft one bin carries two symbols
        back = mine.demodulate(tx).numpy()
        np.testing.assert_allclose(back[:, :n], x, atol=1e-5, rtol=0)


def test_ofdm_rejects_bad_geometry():
    with pytest.raises(ValueError):
        OFDM(64, 8, 65, device="cpu")
    with pytest.raises(ValueError):
        OFDM(64, 8, 31, device="cpu")
    with pytest.raises(ValueError):
        OFDM(64, 65, 32, device="cpu")


@pytest.mark.parametrize("shape,num_samples,t0", [
    ((16,), 64, 0.0),
    ((3, 2, 2), 10, 1e-3),
])
def test_jakes_matches_jax(shape, num_samples, t0):
    rng = np.random.default_rng(len(shape))
    L = 16
    phi = rng.uniform(0, 2 * np.pi, (L,) + shape + (1,)).astype(np.float32)
    psi = rng.uniform(0, 2 * np.pi, (L,) + shape + (1,)).astype(np.float32)
    j = J_Jakes(Fd=30.0, Ts=TS, L=L, shape=shape)
    jstate = J_JakesState(phi_l=jnp.asarray(phi), psi_l=jnp.asarray(psi),
                          t0=jnp.asarray(np.float32(t0)))
    mine = JakesSampleGenerator(Fd=30.0, Ts=TS, L=L, shape=shape,
                                device="cpu")
    state = JakesState.from_numpy(phi, psi, t0, device="cpu")

    for _ in range(2):   # generate, then generate again from the new state
        samples_j, jstate = j.generate(jstate, num_samples)
        samples, state = mine.generate(state, num_samples)
        assert samples.dtype == torch.complex64
        np.testing.assert_allclose(samples.numpy(), samples_j.to_numpy(),
                                   atol=1e-5, rtol=0)
        assert float(state.t0) == pytest.approx(float(jstate.t0), rel=1e-6)
    state = mine.skip(state, 100)
    jstate = j.skip(jstate, 100)
    assert float(state.t0) == pytest.approx(float(jstate.t0), rel=1e-6)


def test_jakes_state_from_generator():
    gen = JakesSampleGenerator(Fd=30.0, Ts=TS, L=8, shape=(4,),
                               device="cpu")
    a = gen.init_state(torch.Generator().manual_seed(3))
    b = gen.init_state(torch.Generator().manual_seed(3))
    assert a.phi_l.shape == (8, 4, 1) and float(a.t0) == 0.0
    assert torch.equal(a.phi_l, b.phi_l) and torch.equal(a.psi_l, b.psi_l)
    assert float(a.phi_l.min()) >= 0.0
    assert float(a.phi_l.max()) < 2 * np.pi
    samples, _ = gen.generate(a, 1000)
    # unit average power per path (sum of L unit phasors / sqrt(L))
    assert 0.2 < float((samples.abs() ** 2).mean()) < 5.0


@pytest.mark.parametrize("name", ["COST259_TUx", "COST259_RAx",
                                  "COST259_HTx"])
def test_discretized_profiles_match_jax(name):
    mine = getattr(fading, name)
    theirs = getattr(J_fading, name)
    np.testing.assert_array_equal(mine.tap_delays, theirs.tap_delays)
    np.testing.assert_allclose(mine.tap_powers_dB, theirs.tap_powers_dB)
    assert mine.rms_delay_spread == pytest.approx(theirs.rms_delay_spread,
                                                  rel=1e-12)
    d_mine = mine.get_discretize_profile(50e-9)
    d_theirs = theirs.get_discretize_profile(50e-9)
    np.testing.assert_array_equal(d_mine.tap_delays, d_theirs.tap_delays)
    np.testing.assert_allclose(d_mine.tap_powers_linear,
                               d_theirs.tap_powers_linear, rtol=1e-12)
    assert d_mine.num_taps_with_padding == d_theirs.num_taps_with_padding


def test_tdl_channel_discretizes_cost259_tu():
    jakes = JakesSampleGenerator(Fd=30.0, Ts=TS, L=16, device="cpu")
    channel = TdlChannel(jakes, fading.COST259_TUx)
    j_channel = J_fading.TdlChannel(J_Jakes(Fd=30.0, Ts=TS, L=16),
                                    J_fading.COST259_TUx)
    assert channel.num_taps == j_channel.num_taps == 16
    assert channel.channel_profile.Ts == 50e-9
    np.testing.assert_array_equal(channel.channel_profile.tap_delays,
                                  j_channel.channel_profile.tap_delays)
    np.testing.assert_allclose(channel.channel_profile.tap_powers_linear,
                               j_channel.channel_profile.tap_powers_linear,
                               rtol=1e-12)
    assert channel._fading_generator.shape == (16,)
    with pytest.raises(RuntimeError, match="Ts"):
        TdlChannel(jakes, fading.COST259_TUx, Ts=1e-6)


def test_conversions_match_jax():
    x = np.array([-30.0, -3.0, 0.0, 7.5, 30.0])
    np.testing.assert_allclose(conversion.dB2Linear(x), J_conv.dB2Linear(x),
                               rtol=1e-12)
    lin = conversion.dB2Linear(x)
    np.testing.assert_allclose(conversion.linear2dB(lin),
                               J_conv.linear2dB(lin), rtol=1e-12)
    t = torch.tensor(x, dtype=torch.float32)
    np.testing.assert_allclose(conversion.dB2Linear(t).numpy(),
                               np.asarray(J_conv.dB2Linear(jnp.asarray(t))),
                               rtol=1e-5)
    np.testing.assert_allclose(
        conversion.linear2dB(conversion.dB2Linear(t)).numpy(), x, atol=1e-4)
    assert float(conversion.dB2Linear(30.0)) == 1000.0
    np.testing.assert_array_equal(conversion.binary2gray(np.arange(8)),
                                  J_conv.binary2gray(np.arange(8)))
    np.testing.assert_array_equal(
        conversion.gray2binary(conversion.binary2gray(np.arange(64))),
        np.arange(64))


def test_bit_counting_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 31, 1000)
    b = rng.integers(0, 2 ** 31, 1000)
    want = J_misc.count_bit_errors(a, b)
    assert misc.count_bit_errors(a, b) == want
    assert int(misc.count_bit_errors(torch.from_numpy(a),
                                     torch.from_numpy(b))) == want
    np.testing.assert_array_equal(
        misc.count_bits(torch.tensor([0, 1, 255, 2 ** 62 - 1])).numpy(),
        [0, 1, 8, 62])
    assert misc.count_bits(0b1011) == 3
    assert [misc.level2bits(m) for m in (2, 4, 16, 256)] == [1, 2, 4, 8]


def test_host_helpers_match_jax():
    x = np.linspace(-2, 4, 7)
    np.testing.assert_allclose(misc.qfunc(x), J_misc.qfunc(x), rtol=1e-12)
    np.testing.assert_allclose(misc.qfunc(torch.tensor(x)).numpy(),
                               J_misc.qfunc(x), rtol=1e-12)
    assert misc.calc_confidence_interval(0.5, 0.1, 100, 95.0) == \
        J_misc.calc_confidence_interval(0.5, 0.1, 100, 95.0)
    for s in (3.25, 65, 3723):
        assert misc.pretty_time(s) == J_misc.pretty_time(s)
    d = {"SNR": np.array([0, 5, 10]), "M": 16, "K": np.array([1, 4])}
    for mode in (False, True):
        assert misc.replace_dict_values("r_{SNR}_{M}_{K}", d, mode) == \
            J_misc.replace_dict_values("r_{SNR}_{M}_{K}", d, mode)
    assert misc.equal_dicts({"a": np.arange(3), "b": 1},
                            {"a": np.arange(3), "b": 2}, ignore_keys=("b",))
