#!/usr/bin/env python
"""SINR / sum-capacity statistics of the batched IA solvers over many
channels, on the PyTorch port.

The counterpart of the batched part of ``apps/ia/ia_SINRs_and_capacity.py``:
all ``--reps`` channels are solved at once by the batched fixed-iteration
solvers (``pyphysim_tpu_torch.ia.batched``) for Min-Leakage, Max-SINR,
MMSE, alternating minimization and the closed form, and the mean sum
capacities are printed and written to a CSV. The channels and the random
inits come from one seeded ``torch.Generator`` on ``--device``.

Run: ``python apps/ia/ia_SINRs_and_capacity_torch.py [--reps 100] [--snr 5]
[--iters 60] [--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.ia import batched  # noqa: E402
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402
from pyphysim_tpu_torch.utils.misc import randn_c  # noqa: E402

SOLVERS = ("minleakage", "maxsinr", "mmse", "altmin", "closedform")


def solve_all(reps: int, snr_db: float, iters: int, solvers=SOLVERS,
              device="cuda", seed: int = 0):
    """Sum capacity (reps,) of each solver in ``solvers`` over ``reps``
    K=3, 4x4, Ns=2 interference channels, as a dict of numpy arrays keyed
    by the solver's display name."""
    K, Nr, Nt, Ns = 3, 4, 4, 2
    nv = 1.0 / float(dB2Linear(snr_db))
    dev = require_cuda(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    H = randn_c(gen, reps, K, K, Nr, Nt)
    menu = {
        "minleakage": ("Min. Leakage", lambda: batched.min_leakage_solve(
            H, gen, Ns, 1.0, iterations=iters)),
        "maxsinr": ("Max SINR", lambda: batched.max_sinr_solve(
            H, gen, Ns, 1.0, nv, iterations=iters)),
        "mmse": ("MMSE", lambda: batched.mmse_solve(
            H, gen, Ns, 1.0, nv, iterations=iters)),
        "altmin": ("Alt Min", lambda: batched.alt_min_solve(
            H, gen, Ns, 1.0, iterations=iters)),
        "closedform": ("Closed Form", lambda: batched.closed_form_solve(
            H, Ns, 1.0, nv)),
    }
    unknown = [s for s in solvers if s not in menu]
    if unknown:
        raise ValueError(f"unknown solvers: {unknown}")
    caps = {}
    for name in solvers:
        label, solve = menu[name]
        F, U = solve()
        caps[label] = batched.sum_capacity(
            batched.calc_sinrs(H, F, U, nv)).cpu().numpy()
    return caps


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=100)
    parser.add_argument("--snr", type=float, default=5.0)
    parser.add_argument("--iters", type=int, default=60)
    parser.add_argument("--solvers", default="all",
                        help="comma list from {minleakage,maxsinr,mmse,"
                             "altmin,closedform} (default all five)")
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()
    chosen = (SOLVERS if args.solvers == "all"
              else [x.strip() for x in args.solvers.split(",")])
    caps = solve_all(args.reps, args.snr, args.iters, chosen, args.device)
    print(f"SNR {args.snr} dB, {args.reps} channels, {args.iters} "
          f"iterations, 3 users 4x4(2)")
    for name, cap in caps.items():
        print(f"{name:>13}: mean sum capacity {cap.mean():.3f} "
              f"(std {cap.std():.3f}) bits/s/Hz")
    out = f"sum_capacity_4x4_2_SNR_{args.snr:g}_batched_torch.txt"
    np.savetxt(out, np.stack(list(caps.values()), 1),
               header=" ".join(k.replace(" ", "") for k in caps))
    print(f"Wrote {out}")


if __name__ == "__main__":
    main()
