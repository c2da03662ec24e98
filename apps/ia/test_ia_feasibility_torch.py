#!/usr/bin/env python
"""Probe the feasibility of an IA configuration by running the solvers, on
the PyTorch port.

The counterpart of ``apps/ia/test_ia_feasibility.py``: for a K = 3 user
4x4 channel with Ns = 2 streams (feasible by the [CadambeDoF2008] DoF
count), run the port's AlternatingMin (400 iterations), MMSE and Max-SINR
(100 each) host solvers and print the residual interference cost and the
sum capacities; alignment is feasible when the alternating-minimization
leakage cost drops to ~0.

The channel is drawn from the port's Philox streams keyed from ``--seed``
and lives on ``--device``; each solver's initial precoders come from its
own seeded numpy stream. The solvers compute on the host in numpy, as the
JAX package's do, reading the channel's blocks from the device.

Run: ``python apps/ia/test_ia_feasibility_torch.py [--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from pyphysim_tpu_torch.channels import MultiUserChannelMatrix  # noqa: E402
from pyphysim_tpu_torch.ia import (AlternatingMinIASolver,  # noqa: E402
                                   MaxSinrIASolver, MMSEIASolver)
from pyphysim_tpu_torch.ops.streams import AttemptStreams  # noqa: E402
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402
from pyphysim_tpu_torch.utils.misc import randn_c  # noqa: E402

K = 3
NR = np.full(K, 4)
NT = np.full(K, 4)
NS = np.array([2, 2, 2])
SNR = 40.0
# (name, solver class, max_iterations), in the JAX app's order
SOLVERS = (("Alt Min", AlternatingMinIASolver, 400),
           ("MMSE", MMSEIASolver, 100),
           ("Max SINR", MaxSinrIASolver, 100))


def make_channel(seed: int = 0, device="cuda") -> MultiUserChannelMatrix:
    """The K = 3, 4x4 channel of attempt 0 of the Philox stream ``seed``,
    on ``device``, with the app's noise variance."""
    channel = MultiUserChannelMatrix(device=device)
    streams = AttemptStreams.from_range(seed, 0, 1, channel.device)
    channel.init_from_channel_matrix(
        randn_c(streams, int(NR.sum()), int(NT.sum()))[0], NR, NT, K)
    channel.noise_var = 1 / dB2Linear(SNR)
    return channel


def make_solvers(channel, seed: int = 0):
    """``{name: solver}``, each solver at its app iteration count with its
    initial precoders drawn (seeded by ``seed`` and its position)."""
    solvers = {}
    for i, (name, cls, iterations) in enumerate(SOLVERS):
        solver = cls(channel)
        solver.set_precoder_seed(seed + i)
        solver.randomizeF(NS)
        solver.max_iterations = iterations
        solvers[name] = solver
    return solvers


def sum_capacity(solver) -> float:
    """``sum log2(1 + SINR)`` over every stream of the solution."""
    return float(np.sum(np.log2(np.hstack(
        [1.0 + np.asarray(s) for s in solver.calc_SINR()]))))


def run(seed: int = 0, device="cuda"):
    """Solve with the three solvers: ``{"cost": alt-min leakage,
    "capacity": {name: sum capacity}, "iterations": {name: runs}}``."""
    solvers = make_solvers(make_channel(seed, device), seed)
    iterations = {name: solver.solve(NS) for name, solver in solvers.items()}
    return {"cost": float(solvers["Alt Min"].get_cost()),
            "capacity": {name: sum_capacity(s) for name, s in
                         solvers.items()},
            "iterations": iterations}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    print(f"SNR: {SNR}")
    print(f"noise_var: {1 / dB2Linear(SNR)}")
    out = run(args.seed, args.device)
    print(f"Final cost (Alt Min leakage): {out['cost']}\n")
    for name, _, _ in SOLVERS:
        print(f"Sum Capacity ({name}):".ljust(25) +
              f"{out['capacity'][name]}")
    return out


if __name__ == "__main__":
    main()
