#!/usr/bin/env python
"""Max-SINR IA sum-capacity sweep driven by the port's CUDA kernel.

The counterpart of ``apps/ia/ia_mc_kernel.py``: the whole Monte Carlo
repetition runs in ONE CUDA kernel (``pyphysim_tpu_torch/ops/ia_kernel.py``
``MonteCarloMaxSinr``, source ``ops/csrc/mc_ia.cu``) plugged into
``SimulationRunner`` through the bulk-kernel path, as the Alamouti and BD
kernel apps do: the kernel owns its repetition axis and draws each attempt's
channels from its Philox stream, while the runner provides the SNR sweep,
Result accumulation, checkpoint / resume and early stop. ``K`` is any
user count >= 2 (one outside the prebuilt kernel library compiles on its
first launch); the noise variance is a run-time argument, so one build
serves every SNR. On ``device="cpu"`` the plain
PyTorch version runs on the same Philox bits.

Run: ``python apps/ia/ia_mc_kernel_torch.py [K] [--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.ops.ia_kernel import MonteCarloMaxSinr  # noqa: E402
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationRunner,
                                            kernel_stream_seed)
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402


class IaMcKernelSimulationRunner(SimulationRunner):
    """K-user 2x2 Ns=1 Max-SINR IA sum capacity; one repetition =
    ``num_tiles * tile * lane`` independent solves ('svd'-style init, fixed
    iteration count), noise_var = 1/SNR_linear at unit power."""

    def __init__(self, K: int = 3, tile: int = 8, lane: int = 256,
                 num_tiles: int = 2, iterations: int = 10, device="cuda",
                 read_command_line_args: bool = True):
        super().__init__(read_command_line_args=read_command_line_args)
        self.device = require_cuda(device)
        self.params.add("SNR", np.array([0.0, 10.0, 20.0]))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 16
        self.batch_size = 8
        self.update_progress_function_style = "text2"
        self.progressbar_message = "Max-SINR IA kernel - SNR {SNR}"
        self.num_tiles = num_tiles
        self.mc = MonteCarloMaxSinr(tile=tile, lane=lane,
                                    iterations=iterations, K=K,
                                    device=self.device)
        self.batch_result_types = {"sum_capacity": Result.RATIOTYPE}
        self.chunks_dispatched = 0
        self._fns = {}

    def _gen_bulk_kernel(self, current_parameters):
        mc, nt = self.mc, self.num_tiles
        noise_var = 1.0 / float(dB2Linear(float(current_parameters["SNR"])))
        solves_per_rep = float(nt * mc.solves_per_grid_step)
        unpack_idx = max(current_parameters.unpack_index, 0)
        seed = kernel_stream_seed(self.base_seed, unpack_idx)
        mesh = self.mesh      # set by simulate_in_parallel: reps sharded

        def bulk(start, n):
            self.chunks_dispatched += 1
            if (n, mesh) not in self._fns:
                self._fns[n, mesh] = mc.build(n, nt, mesh=mesh)
            caps = self._fns[n, mesh](seed, noise_var, start)
            # device tensors, not synchronised; float64, in which the
            # runner's sums of these float32 values are exact, so the
            # results do not depend on the chunk size
            return {"sum_capacity": (caps.double().sum(dim=1),
                                     np.full(n, solves_per_rep))}

        return bulk


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("K", nargs="?", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()
    runner = IaMcKernelSimulationRunner(K=args.K, device=args.device)
    runner.simulate()
    print("\nElapsed time:", runner.elapsed_time)
    print("SNR:", runner.results.params["SNR"])
    print("sum capacity:", np.array(
        runner.results.get_result_values_list("sum_capacity")))


if __name__ == "__main__":
    main()
