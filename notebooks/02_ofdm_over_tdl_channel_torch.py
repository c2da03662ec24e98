# %% [markdown]
# # OFDM transmission over a time-varying TDL channel (PyTorch port)
#
# The port's counterpart of `02_ofdm_over_tdl_channel.py`, the north-star
# chain: 16-QAM -> OFDM(512, 52, 300) -> COST259 Typical Urban channel
# (16 rays, Fd 30 Hz) -> one-tap equalization -> demodulation, for a batch
# of attempts in one call. Shows the per-sample and block-static channel
# modes and the frequency-domain transmission path.
#
# The block-static mode convolves each OFDM symbol with its own taps
# through `channels.fading.BLOCK_CONV_IMPL`: on the card that is the
# `block_fir` CUDA kernel (`ops/csrc/block_fir.cu`), on the CPU its plain
# PyTorch version. Attempt `a` draws its data, channel and noise from the
# Philox streams of attempt `a`, so the card and the CPU see the same bits.
#
# Runs on the card by default; `runpy.run_path(path, init_globals=
# {"DEVICE": "cpu"})` runs it on the CPU.

# %%
import os
import sys

# the repository root: the parent of this file's folder, or of the working
# directory of a notebook server started in notebooks/
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    globals().get("__file__", "notebook")))))

import math

from pyphysim_tpu_torch._device import require_cuda
from pyphysim_tpu_torch.channels import (COST259_TUx, JakesSampleGenerator,
                                         TdlChannel)
from pyphysim_tpu_torch.modulators import OFDM, QAM, OfdmOneTapEqualizer
from pyphysim_tpu_torch.ops.streams import AttemptStreams
from pyphysim_tpu_torch.utils.misc import count_bit_errors, randn_c

DEVICE = globals().get("DEVICE", "cuda")
require_cuda(DEVICE)      # no CPU fallback: without a card, say DEVICE="cpu"
SEED = 2024

bandwidth = 20e6
fft_size, cp_size, num_used = 512, 52, 300
Fd = 30.0  # Doppler (Hz)

qam = QAM(16, device=DEVICE)
ofdm = OFDM(fft_size, cp_size, num_used, device=DEVICE)
jakes = JakesSampleGenerator(Fd=Fd, Ts=1.0 / bandwidth, L=16, device=DEVICE)
channel = TdlChannel(jakes, COST259_TUx)
equalizer = OfdmOneTapEqualizer(ofdm)

print("channel:", channel.channel_profile)
print("discretized taps:", channel.num_taps,
      "span:", channel.num_taps_with_padding)

# %% One end-to-end transmission of a batch of attempts


def transmit(streams, snr_db, block_static=True):
    """(n,) bit errors of the attempts of ``streams`` and the bits each
    sent: 16 OFDM symbols an attempt."""
    s_data, s_channel, s_noise = streams.split(3)
    n = num_used * 16
    data = s_data.integers(16, (n,))
    tx = ofdm.modulate(qam.modulate(data))
    state = channel.init_state(s_channel)
    block = ofdm.samples_per_symbol if block_static else None
    rx, ir, _ = channel.corrupt_data(state, tx, block_size=block)
    rx = rx + randn_c(s_noise, rx.shape[-1]) * math.sqrt(10 ** (-snr_db / 10))
    demod = ofdm.demodulate(rx[..., :tx.shape[-1]])
    eq = equalizer.equalize_data(demod, ir)
    decided = qam.demodulate_hard(eq)
    return count_bit_errors(data, decided, axis=-1), n * 4


# %% BER vs SNR (both channel modes agree): the 8 attempts in one call
attempts = AttemptStreams.from_range(SEED, 0, 8, DEVICE)
bit_errors = {}
for mode in (False, True):
    print(f"\nblock_static={mode}:")
    for snr in (5.0, 15.0, 25.0):
        errs, bits = transmit(attempts, snr, mode)
        bit_errors[mode, snr] = int(errs.sum())
        print(f"  SNR {snr:5.1f} dB -> BER "
              f"{bit_errors[mode, snr] / (bits * attempts.n):.4f}")
bits_per_point = num_used * 16 * 4 * attempts.n

# %% Frequency-domain (block static) transmission path — the reference's
# corrupt_data_in_freq_domain: one impulse response per OFDM block, no
# time-domain convolution at all.
one = AttemptStreams.from_range(SEED + 1, 0, 1, DEVICE)
s_channel, s_data = one.split(2)
state = channel.init_state(s_channel)
sym = qam.modulate(s_data.integers(16, (num_used * 4,)))
carriers = ofdm.get_used_subcarrier_indexes()
out, ir, _ = channel.corrupt_data_in_freq_domain(state, sym, fft_size,
                                                 carriers)
print("\nfreq-domain output shape:", tuple(out.shape),
      "impulse responses:", ir.num_samples)
