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

SNR = 10 ** 1.5
VARIANTS = {"per_sample": (False, False), "block_static": (True, False),
            "fused": (True, True)}


def _jax_chain(geometry, data, phi, psi, noise, block_static, fused):
    """One attempt of the JAX chain; returns (bit errors, equalized,
    received) as numpy."""
    fft, cp, used = geometry
    qam, ofdm = J_QAM(16), J_OFDM(fft, cp, used)
    channel = J_Tdl(J_Jakes(Fd=30.0, Ts=1 / 20e6, L=16), J_TU)
    state = J_JakesState(jnp.asarray(phi), jnp.asarray(psi), jnp.zeros(()))
    tx = qam.modulate(jnp.asarray(data, jnp.int32))
    nz = CArray(jnp.asarray(noise.real), jnp.asarray(noise.imag))
    if fused:
        fop = J_Fused(ofdm, channel)
        rx, ir, _ = fop.corrupt_and_demodulate(state, tx)
        rx = rx + nz * (jnp.sqrt(1.0 / SNR) * fop.noise_gain)
    else:
        sig = ofdm.modulate(tx)
        block = ofdm.samples_per_symbol if block_static else None
        rx_sig, ir, _ = channel.corrupt_data(state, sig, block_size=block)
        rx_sig = rx_sig + nz * jnp.sqrt(1.0 / SNR)
        rx = ofdm.demodulate(rx_sig[..., :sig.shape[-1]])
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


def test_chain_arguments():
    with pytest.raises(NotImplementedError, match="complex64"):
        ChainStep(300, 512, 52, 300, signal_dtype="bfloat16", device="cpu")
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
