#!/usr/bin/env python
"""Stream-selection statistics through the port's batched brute-force and
greedy searches.

The counterpart of ``apps/ia/batched_stream_selection.py``: for each SNR,
Monte Carlo channels are solved with
:func:`pyphysim_tpu_torch.ia.batched.brute_force_stream_solve` (every
per-user stream-count combination from the deterministic svd init, the
winner by sum capacity), and the chosen combination feeds a CHOICETYPE
histogram Result, through the runner's per-key path (one batched call per
chunk of attempts, each attempt's channel from its own stream). The same
channels run :func:`~pyphysim_tpu_torch.ia.batched.greedy_stream_solve`
(worst-stream deletion), reporting how much of the exhaustive search's
capacity the greedy search keeps and how often it lands within 1 % of it.

Run: ``python apps/ia/batched_stream_selection_torch.py [--reps 64]
[--iters 12] [--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.ia.batched import (  # noqa: E402
    brute_force_stream_solve, greedy_stream_solve, stream_combinations)
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationRunner)
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402
from pyphysim_tpu_torch.utils.misc import randn_c  # noqa: E402


class StreamSelectionRunner(SimulationRunner):
    """Brute-force stream selection over iid Rayleigh MIMO-IC channels."""

    def __init__(self, K=3, Nr=2, Nt=2, max_Ns=2, iters=12, reps=64,
                 device="cuda", read_command_line_args: bool = False):
        super().__init__(read_command_line_args=read_command_line_args)
        self.device = require_cuda(device)
        self.params.add("SNR", np.array([0.0, 10.0, 20.0]))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = reps
        self.K, self.Nr, self.Nt, self.max_Ns = K, Nr, Nt, max_Ns
        self.iters = iters
        self.combos = stream_combinations(max_Ns, K)
        self.update_progress_function_style = None
        self.batch_result_types = {
            "stream_choice": (Result.CHOICETYPE, len(self.combos)),
            "sum_capacity": Result.RATIOTYPE,
            "greedy_capacity_ratio": Result.RATIOTYPE,
            "greedy_within_1pct": Result.RATIOTYPE,
        }
        self.chunks_dispatched = 0

    def _gen_simulation_kernel(self, p):
        noise_var = float(1.0 / dB2Linear(float(p["SNR"])))
        K, Nr, Nt = self.K, self.Nr, self.Nt
        max_Ns, iters = self.max_Ns, self.iters

        def kernel(streams):
            self.chunks_dispatched += 1
            H = randn_c(streams, K, K, Nr, Nt)
            _, _, best, caps = brute_force_stream_solve(
                H, None, max_Ns=max_Ns, noise_var=noise_var,
                iterations=iters)
            brute_cap = caps.max(dim=-1).values
            # candidate_init='svd' is the brute-force search's optimizer
            # policy, so greedy / brute <= 1 by construction; the achieved
            # greedy capacity is the trajectory's maximum
            _, _, _, gcaps = greedy_stream_solve(
                H, None, Ns=max_Ns, noise_var=noise_var, iterations=iters,
                candidate_init="svd")
            greedy_cap = gcaps.max(dim=-1).values
            return {"stream_choice": best,
                    "sum_capacity": (brute_cap, 1.0),
                    "greedy_capacity_ratio": (greedy_cap, brute_cap),
                    "greedy_within_1pct": (
                        (greedy_cap >= 0.99 * brute_cap).float(), 1.0)}

        return kernel


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=64)
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()

    runner = StreamSelectionRunner(iters=args.iters, reps=args.reps,
                                   device=args.device)
    runner.simulate()
    print(f"{args.reps} channels/SNR, combos {runner.combos}")
    for i, snr in enumerate(np.atleast_1d(runner.params["SNR"])):
        hist = runner.results["stream_choice"][i].get_result()
        cap = runner.results["sum_capacity"][i].get_result()
        gratio = runner.results["greedy_capacity_ratio"][i].get_result()
        gwin = runner.results["greedy_within_1pct"][i].get_result()
        pct = ", ".join(f"{c}:{100 * h:.0f}%"
                        for c, h in zip(runner.combos, hist) if h > 0)
        print(f"SNR {snr:5.1f} dB: mean best capacity {cap:6.3f}  "
              f"greedy/brute {100 * gratio:.1f}% "
              f"(within 1%: {100 * gwin:.0f}%)  [{pct}]")


if __name__ == "__main__":
    main()
