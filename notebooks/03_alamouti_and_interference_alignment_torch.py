# %% [markdown]
# # Alamouti diversity and interference alignment (PyTorch port)
#
# The port's counterpart of `03_alamouti_and_interference_alignment.py`:
# Alamouti 2x1 vs MRC 1x2 over Rayleigh fading with the port's MIMO
# classes, then a 3-user IA sum-capacity sweep with the batched Max-SINR
# solver (`pyphysim_tpu_torch.ia.batched`), every draw and every SNR of a
# sweep one batch of complex tensors on the device.
#
# Repetition `a` draws its data, channel and noise from the Philox
# streams of attempt `a`, so the card and the CPU see the same bits. Runs
# on the card by default; `runpy.run_path(path, init_globals={"DEVICE":
# "cpu"})` runs it on the CPU.

# %%
import os
import sys

# the repository root: the parent of this file's folder, or of the working
# directory of a notebook server started in notebooks/
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    globals().get("__file__", "notebook")))))

import math

import torch

from pyphysim_tpu_torch._device import require_cuda
from pyphysim_tpu_torch.mimo import MRC, Alamouti
from pyphysim_tpu_torch.modulators import QPSK
from pyphysim_tpu_torch.ops.streams import AttemptStreams
from pyphysim_tpu_torch.utils.misc import count_bit_errors, randn_c

DEVICE = globals().get("DEVICE", "cuda")
require_cuda(DEVICE)      # no CPU fallback: without a card, say DEVICE="cpu"
SEED = 2024

qpsk = QPSK(device=DEVICE)
n = 200
reps = 400

# %% Alamouti vs MRC BER: the 400 repetitions in one call


def alamouti_rep(streams, snr):
    """(reps,) bit errors of Alamouti 2x1, one channel a repetition."""
    s_data, s_h, s_noise = streams.split(3)
    data = s_data.integers(4, (n,))
    h = randn_c(s_h, 1, 2)                               # (reps, 1, 2)
    al = Alamouti(h, device=DEVICE)
    rx = h @ al.encode(qpsk.modulate(data)) + \
        randn_c(s_noise, 1, n) * math.sqrt(1 / snr)
    return count_bit_errors(data, qpsk.demodulate(al.decode(rx)), axis=-1)


def mrc_rep(streams, snr):
    """(reps,) bit errors of MRC 1x2, one channel a repetition."""
    s_data, s_h, s_noise = streams.split(3)
    data = s_data.integers(4, (n,))
    h = randn_c(s_h, 2, 1)                               # (reps, 2, 1)
    rx = h * qpsk.modulate(data)[:, None, :] + \
        randn_c(s_noise, 2, n) * math.sqrt(1 / snr)
    return count_bit_errors(data, qpsk.demodulate(MRC(h, device=DEVICE)
                                                  .decode(rx)), axis=-1)


streams = AttemptStreams.from_range(SEED, 0, reps, DEVICE)
ber = {}
for name, rep in [("Alamouti 2x1", alamouti_rep), ("MRC 1x2", mrc_rep)]:
    print(f"\n{name}:")
    for snr_db in (5.0, 10.0, 15.0, 20.0):
        errs = int(rep(streams, 10 ** (snr_db / 10)).sum())
        ber[name, snr_db] = errs / (reps * n * 2)
        print(f"  SNR {snr_db:5.1f} dB -> BER {ber[name, snr_db]:.5f}")

# %% 3-user IA sum-capacity sweep: 32 channel draws x 4 SNRs, one batch
from pyphysim_tpu_torch.ia.batched import (calc_sinrs, max_sinr_solve,
                                           sum_capacity)

ia_snrs = (0.0, 10.0, 20.0, 30.0)
draws = 32


def sweep_inputs(seed):
    """The batch of a sweep, SNR-major: the same 32 draws at every SNR
    (attempts 0-31 repeated), their channels (128, 3, 3, 2, 2), the
    solvers' random source and the noise variances (128, 1, 1)."""
    attempts = torch.arange(draws, device=DEVICE).repeat(len(ia_snrs))
    s_h, s_init = AttemptStreams(seed, attempts).split(2)
    nv = torch.tensor([10 ** (-s / 10.0) for s in ia_snrs],
                      device=DEVICE).repeat_interleave(draws)
    return randn_c(s_h, 3, 3, 2, 2), s_init, nv[:, None, None]


H, s_init, nv = sweep_inputs(SEED + 1)
F, U = max_sinr_solve(H, s_init, Ns=1, P=1.0, noise_var=nv, iterations=25)
caps = sum_capacity(calc_sinrs(H, F, U, nv, 1.0)).reshape(
    len(ia_snrs), draws).mean(dim=1).cpu().numpy()
print("\n3-user IA mean sum capacity (bits) at 0/10/20/30 dB:")
print("  " + "  ".join(f"{c:6.2f}" for c in caps))

# %% [markdown]
# ## Solver comparison: Max-SINR vs Min-Leakage vs MMSE
#
# All three iterative IA algorithms run batched with fixed iteration
# counts, from the same random initial precoders. The physics to expect:
# Min-Leakage ignores noise, so it loses at low SNR and catches up at high
# SNR; MMSE tracks Max-SINR closely.

# %%
from pyphysim_tpu_torch.ia.batched import min_leakage_solve, mmse_solve

H, s_init, nv = sweep_inputs(SEED + 2)
Fm, Um = max_sinr_solve(H, s_init, Ns=1, P=1.0, noise_var=nv,
                        iterations=25)
Fl, Ul = min_leakage_solve(H, s_init, Ns=1, iterations=25)
Fe, Ue = mmse_solve(H, s_init, Ns=1, P=1.0, noise_var=nv, iterations=25)
Fen = Fe / torch.sqrt((Fe.abs() ** 2).sum(dim=(-2, -1), keepdim=True))
caps3 = torch.stack([sum_capacity(calc_sinrs(H, F_, U_, nv, 1.0))
                     for F_, U_ in ((Fm, Um), (Fl, Ul), (Fen, Ue))],
                    dim=-1).reshape(len(ia_snrs), draws, 3).mean(
                        dim=1).cpu().numpy()
print("\nmean sum capacity (bits) [max-sinr, min-leakage, mmse]:")
for snr, row in zip(ia_snrs, caps3):
    print(f"  SNR {snr:4.0f} dB: " + "  ".join(f"{c:6.2f}" for c in row))
