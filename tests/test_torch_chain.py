"""The port's flagship chain (``pyphysim_tpu_torch/chain.py``) against the
JAX package's chain on the same data, Jakes state and noise.

The JAX side is ``__graft_entry__._make_chain_step``'s arithmetic written
out with the JAX package's modules, so that it takes injected inputs
instead of drawing them from a key. Three variants (per-sample,
block-static, fused), at a small width and once at the flagship geometry
with batch 2. Received and equalized symbols agree to float32 rounding of
two transform algorithms (2e-5 absolute on received symbols; 1e-3
relative on equalized ones, which divide by the channel); bit-error
counts agree within 1 per 10,000 bits, the decision-boundary slack, and
never by more than one flip when that is below 1.

The bf16 signal path (``signal_dtype=bfloat16``) is held to a tolerance
the test derives from the reference itself: on the same inputs, the JAX
bf16 step's per-attempt bit errors differ from its float32 step's by the
rounding noise that bf16 brings (its transforms are bf16 matmuls, the
port's float32 FFTs, so the counts cannot agree bit for bit). The port's
bf16 counts must lie within that noise, per attempt and summed, plus the
float32 slack above; and its received values must match the JAX chain in
float32 rounded to bf16 at the same points, but for the few that float32
noise pushes across a rounding boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu.channels.fading import COST259_TUx as J_TU  # noqa: E402
from pyphysim_tpu.channels.fading import TdlChannel as J_Tdl  # noqa: E402
from pyphysim_tpu.channels.fading_generators import \
    JakesSampleGenerator as J_Jakes  # noqa: E402
from pyphysim_tpu.channels.fading_generators import \
    JakesState as J_JakesState  # noqa: E402
from pyphysim_tpu.modulators import OFDM as J_OFDM  # noqa: E402
from pyphysim_tpu.modulators import QAM as J_QAM  # noqa: E402
from pyphysim_tpu.modulators.ofdm import \
    OfdmOneTapEqualizer as J_Equalizer  # noqa: E402
from pyphysim_tpu.ops.cplx import CArray  # noqa: E402
from pyphysim_tpu.ops.fused_ofdm_tdl import \
    FusedOfdmTdl as J_Fused  # noqa: E402
from pyphysim_tpu.utils.misc import \
    count_bit_errors as j_count_bit_errors  # noqa: E402
from pyphysim_tpu_torch.chain import ChainStep  # noqa: E402
from pyphysim_tpu_torch.channels import JakesState  # noqa: E402
from pyphysim_tpu_torch.ops.streams import AttemptStreams  # noqa: E402
from pyphysim_tpu_torch.utils.misc import randn_c, round_bf16  # noqa: E402

SNR = 10 ** 1.5
VARIANTS = {"per_sample": (False, False), "block_static": (True, False),
            "fused": (True, True)}


def _jax_chain(geometry, data, phi, psi, noise, block_static, fused,
               snr=SNR, signal_dtype=None, rounded=False):
    """One attempt of the JAX chain; returns (bit errors, equalized,
    received) as numpy. With ``signal_dtype`` the arithmetic of
    ``_make_chain_step``'s low-precision branches, the noise (``randn_c``'s
    output there) cast to that type. With ``rounded`` the float32
    arithmetic, rounded to bf16 by ``jnp`` casts at each point where that
    bf16 step's value is bf16: the port's bf16 semantics, written with the
    JAX package."""
    fft, cp, used = geometry
    qam, ofdm = J_QAM(16), J_OFDM(fft, cp, used)
    channel = J_Tdl(J_Jakes(Fd=30.0, Ts=1 / 20e6, L=16), J_TU)
    state = J_JakesState(jnp.asarray(phi), jnp.asarray(psi), jnp.zeros(()))
    tx = qam.modulate(jnp.asarray(data, jnp.int32))
    nz = CArray(jnp.asarray(noise.real), jnp.asarray(noise.imag))
    low = rounded or signal_dtype is not None
    if rounded:
        def cast(x):
            return x.astype(jnp.bfloat16).astype(jnp.float32)
        done = cast
    else:
        def cast(x):
            return x.astype(signal_dtype)

        def done(x):      # bf16 arithmetic rounds its own results
            return x
    if low:
        tx, nz = cast(tx), cast(nz)
    if fused:
        fop = J_Fused(ofdm, channel)
        rx, ir, _ = fop.corrupt_and_demodulate(state, tx)
        if not low:
            rx = rx + nz * (jnp.sqrt(1.0 / snr) * fop.noise_gain)
        else:
            amp = cast(jnp.sqrt(1.0 / jnp.float32(snr)) * fop.noise_gain)
            rx = done(cast(rx) + done(nz * amp))
    else:
        sig = done(ofdm.modulate(tx))
        block = ofdm.samples_per_symbol if block_static else None
        rx_sig, ir, _ = channel.corrupt_data(state, sig, block_size=block)
        if not low:
            rx_sig = rx_sig + nz * jnp.sqrt(1.0 / snr)
        else:
            amp = cast(jnp.sqrt(1.0 / jnp.float32(snr)))
            rx_sig = done(cast(rx_sig) + done(nz * amp))
        rx = done(ofdm.demodulate(rx_sig[..., :sig.shape[-1]]))
    eq = J_Equalizer(ofdm).equalize_data(rx, ir)
    errors = j_count_bit_errors(jnp.asarray(data, jnp.int32),
                                qam.demodulate_hard(eq))
    return int(errors), eq.to_numpy(), rx.to_numpy()


def _inputs(step, batch, seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 16, (batch, step.num_symbols))
    phi = rng.uniform(0, 2 * np.pi, (batch, 16, 16, 1)).astype(np.float32)
    psi = rng.uniform(0, 2 * np.pi, (batch, 16, 16, 1)).astype(np.float32)
    n = step.noise_length
    noise = ((rng.standard_normal((batch, n)) + 1j * rng.standard_normal(
        (batch, n))) * np.sqrt(0.5)).astype(np.complex64)
    return data, phi, psi, noise


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("geometry,n_ofdm,batch", [
    ((128, 44, 96), 4, 3),        # small width
    ((512, 52, 300), 4, 2),       # the flagship geometry
])
def test_forward_matches_jax(variant, geometry, n_ofdm, batch):
    block_static, fused = VARIANTS[variant]
    fft, cp, used = geometry
    step = ChainStep(used * n_ofdm, fft, cp, used, block_static=block_static,
                     fused=fused, device="cpu")
    data, phi, psi, noise = _inputs(step, batch, sum(geometry) + n_ofdm)
    out = step.forward(torch.from_numpy(data),
                       JakesState.from_numpy(phi, psi, np.zeros(batch),
                                             device="cpu"),
                       torch.from_numpy(noise), SNR)
    assert out.bit_errors.shape == (batch,)
    total, total_j = int(out.bit_errors.sum()), 0
    for b in range(batch):
        errors, eq, rx = _jax_chain(geometry, data[b], phi[b], psi[b],
                                    noise[b], block_static, fused)
        total_j += errors
        np.testing.assert_allclose(out.received[b].numpy(), rx, atol=2e-5,
                                   rtol=0)
        np.testing.assert_allclose(out.equalized[b].numpy(), eq, rtol=1e-3,
                                   atol=1e-4)
    bits = batch * step.bits_per_attempt
    assert total_j > 0
    assert abs(total - total_j) <= max(1, bits // 10_000)


def test_step_rows_depend_only_on_their_attempts():
    """``step`` draws every input of attempt ``a`` from ``a``'s streams:
    rows of one call equal the same attempts in another chunking."""
    step = ChainStep(96 * 2, 128, 44, 96, block_static=True, device="cpu")
    whole = step.step(AttemptStreams.from_range(5, 10, 6, "cpu"), SNR)
    head = step.step(AttemptStreams.from_range(5, 10, 2, "cpu"), SNR)
    tail = step.step(AttemptStreams.from_range(5, 12, 4, "cpu"), SNR)
    assert torch.equal(whole, torch.cat([head, tail]))
    other = step.step(AttemptStreams.from_range(6, 10, 6, "cpu"), SNR)
    assert not torch.equal(whole, other)


# The share of received values farther than 1e-6 of the largest from the
# rounded float32 JAX chain (measured: 1.6 / 2.5 % block-static and 0.01 /
# 0.03 % fused at 5 / 15 dB, where one rounding point in the port decides
# the other way after float32 noise; with any one rounding point left out,
# 38-100 % block-static and 15-91 % fused at 5 dB).
ROUNDED_MISMATCH = {"block_static": 0.05, "fused": 0.005}


@pytest.mark.parametrize("snr_db", [5.0, 15.0])
@pytest.mark.parametrize("variant", ["block_static", "fused"])
def test_bf16_forward_matches_jax_within_bf16_noise(variant, snr_db):
    """The flagship geometry, 8 attempts of 4 OFDM symbols (4,800 bits
    each). ``noise`` is the JAX bf16 step's per-attempt distance from its
    float32 step (largest: 13 / 5 at 5 / 15 dB block-static, 4 / 4 fused;
    summed: 32 / 24 and 11 / 20). Each attempt of the port lies within the
    largest of it plus the float32 slack (measured: at most 10 / 4 and
    5 / 4), and the total within the summed noise plus the slack.

    Those counts cannot tell a port that skips a rounding point. So the
    port is also held to the JAX chain in float32 rounded at the same
    points (``rounded``): its received values agree but for a few, see
    ``ROUNDED_MISMATCH``, and its bit errors by at most one per attempt
    (measured: at most 1)."""
    block_static, fused = VARIANTS[variant]
    snr = 10 ** (snr_db / 10)
    batch = 8
    step = ChainStep(300 * 4, 512, 52, 300, block_static=block_static,
                     fused=fused, signal_dtype=torch.bfloat16, device="cpu")
    data, phi, psi, noise = _inputs(step, batch, 1 + int(snr_db) + fused)
    out = step.forward(torch.from_numpy(data),
                       JakesState.from_numpy(phi, psi, np.zeros(batch),
                                             device="cpu"),
                       torch.from_numpy(noise), snr)
    args = [(data[b], phi[b], psi[b], noise[b], block_static, fused, snr)
            for b in range(batch)]
    geometry = (512, 52, 300)
    j_bf16 = np.array([_jax_chain(geometry, *a, signal_dtype=jnp.bfloat16)[0]
                       for a in args])
    j_f32 = np.array([_jax_chain(geometry, *a)[0] for a in args])
    rounded = [_jax_chain(geometry, *a, rounded=True) for a in args]
    port = out.bit_errors.numpy()
    # every received value is a bf16 value
    assert torch.equal(out.received, round_bf16(out.received))
    noise_per_attempt = np.abs(j_bf16 - j_f32)
    slack = max(1, batch * step.bits_per_attempt // 10_000)
    assert j_bf16.sum() > 0 and noise_per_attempt.sum() > 0
    per_attempt = np.abs(port - j_bf16)
    assert per_attempt.max() <= noise_per_attempt.max() + 1, (
        per_attempt, noise_per_attempt)
    diff = abs(int(port.sum()) - int(j_bf16.sum()))
    assert diff <= noise_per_attempt.sum() + slack, (
        diff, noise_per_attempt, slack)

    r_errors = np.array([r[0] for r in rounded])
    assert np.abs(port - r_errors).max() <= 1, (port, r_errors)
    r_rx = np.stack([r[2] for r in rounded])
    far = np.abs(out.received.numpy() - r_rx) > 1e-6 * np.abs(r_rx).max()
    assert far.mean() < ROUNDED_MISMATCH[variant], far.mean()


def test_round_bf16_matches_jax_casts():
    """Bitwise equal to ``jnp.bfloat16`` casts, ties to even included."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096))
    ties = 1.0 + (2 * np.arange(64) + 1) * 2.0 ** -8   # halfway pairs
    re = np.concatenate([x, ties, -ties, [0.0, -0.0, 3e38]]).astype(
        np.float32)
    im = re[::-1].copy()
    got = round_bf16(torch.complex(torch.from_numpy(re),
                                   torch.from_numpy(im)))
    want = CArray(jnp.asarray(re), jnp.asarray(im)).astype(
        jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(got.real.numpy().view(np.uint32),
                                  np.asarray(want.re).view(np.uint32))
    np.testing.assert_array_equal(got.imag.numpy().view(np.uint32),
                                  np.asarray(want.im).view(np.uint32))
    real = round_bf16(torch.from_numpy(re))
    assert real.dtype == torch.float32
    np.testing.assert_array_equal(real.numpy(), np.asarray(want.re))


def test_bf16_noise_moments():
    """The step's noise, drawn in float32 from the attempt streams and
    rounded to bf16, has mean 0 and unit power within the tolerances of
    the JAX package's own bf16 moment test (``tests/test_utils.py``)."""
    noise = round_bf16(randn_c(AttemptStreams.from_range(21, 0, 16, "cpu"),
                               125_000))
    re = noise.real.double().numpy().ravel()
    im = noise.imag.double().numpy().ravel()
    sem = np.sqrt(0.5 / re.size)
    assert abs(re.mean()) < max(4 * sem, 2.5e-3)
    assert abs(im.mean()) < max(4 * sem, 2.5e-3)
    assert np.isclose((re ** 2 + im ** 2).mean(), 1.0, atol=0.01)


def test_chain_arguments():
    for bad in ("float16", torch.float16, torch.complex64, "bf16"):
        with pytest.raises(ValueError, match="signal_dtype"):
            ChainStep(300, 512, 52, 300, signal_dtype=bad, device="cpu")
    for ok in (None, "bfloat16", torch.bfloat16):
        step = ChainStep(300, 512, 52, 300, signal_dtype=ok, device="cpu")
        assert step.signal_dtype == (None if ok is None else torch.bfloat16)
    with pytest.raises(ValueError, match="block-static"):
        ChainStep(300, 512, 52, 300, fused=True, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        ChainStep(301, 512, 52, 300, device="cpu")
    step = ChainStep(600, 512, 52, 300, device="cpu")
    assert step.bits_per_attempt == 2400
    assert step.noise_length == 2 * 564 + 43
    fused = ChainStep(600, 512, 52, 300, block_static=True, fused=True,
                      device="cpu")
    assert fused.noise_length == 600
