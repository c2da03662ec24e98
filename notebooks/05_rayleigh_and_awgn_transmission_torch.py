# %% [markdown]
# # Transmission over Rayleigh and AWGN channels, with MRC (PyTorch port)
#
# The port's counterpart of `05_rayleigh_and_awgn_transmission.py`: QPSK
# through (a) a pure AWGN channel, (b) a flat Rayleigh fading channel with
# one receive antenna, and (c) a 1x2 Rayleigh channel with maximum ratio
# combining. Each SNR point is one batched call over its repetitions; the
# fading BER is compared against the closed-form Rayleigh curve.
#
# Repetition `a` draws its data, noise and channel from the Philox streams
# of attempt `a`, so the card and the CPU see the same bits. Runs on the
# card by default; `runpy.run_path(path, init_globals={"DEVICE": "cpu"})`
# runs it on the CPU.

# %%
import os
import sys

# the repository root: the parent of this file's folder, or of the working
# directory of a notebook server started in notebooks/
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    globals().get("__file__", "notebook")))))

import numpy as np

from pyphysim_tpu_torch._device import require_cuda
from pyphysim_tpu_torch.modulators import QPSK
from pyphysim_tpu_torch.ops.streams import AttemptStreams
from pyphysim_tpu_torch.utils.conversion import dB2Linear
from pyphysim_tpu_torch.utils.misc import count_bit_errors, randn_c

DEVICE = globals().get("DEVICE", "cuda")
require_cuda(DEVICE)      # no CPU fallback: without a card, say DEVICE="cpu"
SEED = 2024

mod = QPSK(device=DEVICE)
NUM_SYMBOLS = 20_000
NUM_REPS = 50
SNRS_DB = np.arange(0.0, 22.0, 3.0)

# %% [markdown]
# ## The three channel kernels
#
# Flat Rayleigh fading multiplies each symbol by h ~ CN(0, 1); the
# receiver knows h (coherent detection), so equalization is the
# matched-filter division. With two receive antennas, MRC combines
# y = h^H r / ||h||^2, which is the MRC receive filter of
# `pyphysim_tpu_torch.mimo` specialized to one stream — written inline
# here to keep the whole kernel in one screen.


# %%
def make_kernel(snr_db, mode):
    scale = float(np.sqrt(1.0 / dB2Linear(snr_db)))

    def kernel(streams):
        """(reps,) bit errors of the repetitions of ``streams``."""
        s_data, s_noise, s_h = streams.split(3)
        data = s_data.integers(mod.M, (NUM_SYMBOLS,))
        tx = mod.modulate(data)
        if mode == "awgn":
            y = tx + randn_c(s_noise, NUM_SYMBOLS) * scale
        elif mode == "rayleigh":
            h = randn_c(s_h, NUM_SYMBOLS)
            noise = randn_c(s_noise, NUM_SYMBOLS) * scale
            y = (h * tx + noise) * h.conj() / (h.abs() ** 2)
        else:  # mrc over 2 rx antennas
            h = randn_c(s_h, 2, NUM_SYMBOLS)
            r = h * tx[:, None, :] + randn_c(s_noise, 2, NUM_SYMBOLS) * scale
            y = (h.conj() * r).sum(dim=-2) / (h.abs() ** 2).sum(dim=-2)
        return count_bit_errors(data, mod.demodulate(y), axis=-1)

    return kernel


def simulate(mode):
    """Bit errors a point, the repetitions of each point in one call."""
    errors = []
    for snr_db in SNRS_DB:
        streams = AttemptStreams.from_range(SEED + int(snr_db), 0, NUM_REPS,
                                            DEVICE)
        errors.append(int(make_kernel(snr_db, mode)(streams).sum()))
    return np.array(errors)


num_bits = NUM_SYMBOLS * NUM_REPS * mod.K
bit_errors = {mode: simulate(mode) for mode in ("awgn", "rayleigh", "mrc")}
ber_awgn, ber_rayleigh, ber_mrc = (bit_errors[m] / num_bits
                                   for m in ("awgn", "rayleigh", "mrc"))

# %% [markdown]
# ## Compare against theory
#
# AWGN: the QPSK closed form. Flat Rayleigh (1 rx): per-bit
# `0.5 (1 - sqrt(g / (1 + g)))` with g the average SNR per bit. MRC with
# L antennas follows the diversity-order-L closed form.

# %%
snr_lin = dB2Linear(SNRS_DB)
theory_awgn = mod.calcTheoreticalBER(SNRS_DB)
g = snr_lin / mod.K  # average SNR per bit
theory_rayleigh = 0.5 * (1.0 - np.sqrt(g / (1.0 + g)))
mu = np.sqrt(g / (1.0 + g))
theory_mrc = (((1 - mu) / 2) ** 2) * (2 + mu)  # L = 2 diversity

print(f"{'SNR':>5} {'AWGN sim':>10} {'AWGN th':>10} {'Ray sim':>10} "
      f"{'Ray th':>10} {'MRC sim':>10} {'MRC th':>10}")
for i, s in enumerate(SNRS_DB):
    print(f"{s:5.0f} {ber_awgn[i]:10.2e} {theory_awgn[i]:10.2e} "
          f"{ber_rayleigh[i]:10.2e} {theory_rayleigh[i]:10.2e} "
          f"{ber_mrc[i]:10.2e} {theory_mrc[i]:10.2e}")

# %% [markdown]
# Fading costs orders of magnitude at high SNR (the BER decays only as
# 1/SNR), and two-branch MRC restores a slope of 1/SNR^2 — the classic
# diversity picture.

# %%
try:
    from matplotlib import pyplot as plt
    plt.semilogy(SNRS_DB, ber_awgn, "o-", label="AWGN (sim)")
    plt.semilogy(SNRS_DB, ber_rayleigh, "s-", label="Rayleigh (sim)")
    plt.semilogy(SNRS_DB, ber_mrc, "^-", label="Rayleigh + MRC 1x2 (sim)")
    plt.semilogy(SNRS_DB, theory_awgn, "k:", label="theory")
    plt.semilogy(SNRS_DB, theory_rayleigh, "k:")
    plt.semilogy(SNRS_DB, theory_mrc, "k:")
    plt.xlabel("SNR (dB)"), plt.ylabel("BER"), plt.legend()
    plt.grid(True, which="both")
    plt.savefig("rayleigh_awgn_ber.png", dpi=120)
    plt.close()
    print("Saved rayleigh_awgn_ber.png")
except ImportError:
    pass
