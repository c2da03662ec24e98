#!/usr/bin/env python
"""Compare MMSE and Max-SINR interference alignment on one channel, on the
PyTorch port.

The counterpart of ``apps/ia/simple_ia.py``: a K=3 user 4x4 interference
channel with 2 streams a user at SNR 30 dB; the MMSE and Max-SINR iterative
host solvers start from the SAME random precoders
(``initialize_with='fix'``) and their per-stream SINRs and sum capacities
are compared. The solvers compute on the host in numpy; the channel lives
on ``--device``.

Run: ``python apps/ia/simple_ia_torch.py [--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyphysim_tpu_torch.channels import MultiUserChannelMatrix  # noqa: E402
from pyphysim_tpu_torch.ia import MaxSinrIASolver, MMSEIASolver  # noqa: E402
from pyphysim_tpu_torch.progressbar import ProgressbarText  # noqa: E402
from pyphysim_tpu_torch.utils.conversion import (dB2Linear,  # noqa: E402
                                                 linear2dB)


def calc_capacity(sinr):
    """Per-user capacity from per-user SINR arrays (linear scale)."""
    return np.array([np.sum(np.log2(1 + user_sinrs)) for user_sinrs in sinr])


def run(device="cuda", rep_max: int = 1, max_iterations: int = 200):
    """Mean per-stream SINRs (dB) and sum capacities of both solvers over
    ``rep_max`` channels: ``(mmse_sinrs, max_sinr_sinrs, mmse_capacity,
    max_sinr_capacity)``."""
    K, Nr, Nt, Ns = 3, 4, 4, 2
    SNR = 30.0
    P = 1.0
    noise_var = 1 / dB2Linear(SNR)
    mmse_sinrs = np.empty([rep_max, K, Ns], dtype=float)
    max_sinr_sinrs = np.empty([rep_max, K, Ns], dtype=float)
    mmse_capacity = np.empty(rep_max, dtype=float)
    max_sinr_capacity = np.empty(rep_max, dtype=float)

    pbar = ProgressbarText(rep_max, message=f"Simulating for SNR: {SNR}")
    for rep in range(rep_max):
        channel = MultiUserChannelMatrix(device=device)
        channel.randomize(Nr, Nt, K, generator=torch.Generator(
            device=channel.device).manual_seed(rep))
        channel.noise_var = noise_var

        mmse_solver = MMSEIASolver(channel)
        max_sinr_solver = MaxSinrIASolver(channel)
        mmse_solver.set_precoder_seed(rep)

        # both solvers start from the SAME random precoders
        mmse_solver.randomizeF(Ns, P)
        mmse_solver.initialize_with = "fix"
        max_sinr_solver.initialize_with = "fix"
        max_sinr_solver._F = mmse_solver._F

        mmse_solver.max_iterations = max_iterations
        mmse_solver.solve(Ns)
        max_sinr_solver.max_iterations = max_iterations
        max_sinr_solver.solve(Ns)

        mmse_sinrs[rep] = [linear2dB(s) for s in mmse_solver.calc_SINR()]
        max_sinr_sinrs[rep] = [linear2dB(s)
                               for s in max_sinr_solver.calc_SINR()]
        mmse_capacity[rep] = np.sum(calc_capacity(mmse_solver.calc_SINR()))
        max_sinr_capacity[rep] = np.sum(
            calc_capacity(max_sinr_solver.calc_SINR()))
        pbar.progress(rep + 1)
    return (mmse_sinrs.mean(0), max_sinr_sinrs.mean(0), mmse_capacity.mean(),
            max_sinr_capacity.mean())


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()
    mmse_sinrs, max_sinr_sinrs, mmse_cap, max_sinr_cap = run(args.device)
    print()
    print(f"MMSE Average SINRs:\n{mmse_sinrs}")
    print(f"Max SINR Average SINRs:\n{max_sinr_sinrs}")
    print(f"MMSE Average Capacity: {mmse_cap}")
    print(f"Max SINR Average Capacity: {max_sinr_cap}")
    print("\nEnd!")


if __name__ == "__main__":
    main()
