#!/usr/bin/env python
"""CoMP Block Diagonalization sum-capacity sweep on the PyTorch / CUDA port.

The counterpart of ``apps/comp_BD/batched_bd_capacity.py``, with its two
engines:

* ``BatchedBDCapacityRunner``: the batched chain
  (``pyphysim_tpu_torch.comm.bd_precoders_batched``) through the runner's
  per-key path; any square (K, Nr_u) geometry. A degenerate draw is marked
  invalid (``__valid__``) and the runner skips it and retries.
* ``BDKernelCapacityRunner``: the BD CUDA kernel
  (``pyphysim_tpu_torch.ops.bd_kernel.MonteCarloBD``) through the runner's
  bulk path; any square (K, Nr_u) with K >= 2 and Nr_u in (1, 2), a
  geometry outside the prebuilt kernel library compiled on its first
  launch. Degenerate draws are zeroed inside the kernel instead of
  retried.

Both sweep the per-BS power (in dB) and report the mean BD sum capacity.

Run: ``python apps/comp_BD/batched_bd_capacity_torch.py [K Nr_u]
[--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.comm import bd_precoders_batched  # noqa: E402
from pyphysim_tpu_torch.ops.bd_kernel import MonteCarloBD  # noqa: E402
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationRunner,
                                            kernel_stream_seed)
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402
from pyphysim_tpu_torch.utils.misc import randn_c  # noqa: E402


def bd_capacity(H: torch.Tensor, K: int, iPu: float, noise_var: float,
                mode: str):
    """Sum capacity of BD over a batch of joint channels and the validity
    mask of each draw: ``(cap (B,), valid (B,))``. The guard is
    scale-relative (the smallest stream gain against the largest)."""
    _, Ms, Sigma = bd_precoders_batched(H, K, iPu, noise_var, mode)
    p = (Ms.real ** 2 + Ms.imag ** 2).sum(dim=-2)     # per-stream power
    cap = torch.log2(1.0 + p * Sigma ** 2 / noise_var).sum(dim=-1)
    valid = torch.isfinite(cap) & \
        (Sigma.min(dim=-1).values > 1e-6 * Sigma.max(dim=-1).values)
    return cap, valid


class BatchedBDCapacityRunner(SimulationRunner):
    """Sum capacity of [Spencer2004] BD over iid Rayleigh joint channels,
    each chunk of repetitions one batched call; any square (K, Nr_u)."""

    def __init__(self, mode: str = "global", K: int = 3, nr_u: int = 2,
                 device="cuda", read_command_line_args: bool = True):
        super().__init__(read_command_line_args=read_command_line_args)
        self.device = require_cuda(device)
        self.params.add("Pu_dB", np.arange(-5.0, 21.0, 5.0))
        self.params.set_unpack_parameter("Pu_dB")
        self.rep_max = 512
        self.K, self.nr_u, self.nt_tot = K, nr_u, K * nr_u
        self.noise_var = 1.0
        self.mode = mode
        self.progressbar_message = f"BD capacity ({mode}) - Pu {{Pu_dB}}"
        self.update_progress_function_style = "text2"
        self.batch_result_types = {"sum_capacity": Result.RATIOTYPE}
        self.chunks_dispatched = 0

    def _gen_simulation_kernel(self, current_parameters):
        iPu = float(dB2Linear(float(current_parameters["Pu_dB"])))
        K, nr_u, nt_tot = self.K, self.nr_u, self.nt_tot
        nv, mode = self.noise_var, self.mode

        def kernel(streams):
            self.chunks_dispatched += 1
            H = randn_c(streams, K * nr_u, nt_tot)
            cap, valid = bd_capacity(H, K, iPu, nv, mode)
            # a degenerate draw is skipped and retried by the runner
            return {"sum_capacity": (cap, 1.0), "__valid__": valid}

        return kernel


class BDKernelCapacityRunner(SimulationRunner):
    """The same sweep through the BD kernel on the runner's bulk path: one
    repetition = ``num_tiles * tile * lane`` independent BD solves.
    ``K`` / ``nr_u`` pick the geometry (K >= 2, Nr_u in (1, 2)); the
    kernel draws each attempt's channels from its Philox stream."""

    def __init__(self, K: int = 2, nr_u: int = 2, tile: int = 8,
                 lane: int = 256, num_tiles: int = 2, device="cuda",
                 read_command_line_args: bool = True):
        super().__init__(read_command_line_args=read_command_line_args)
        self.device = require_cuda(device)
        self.params.add("Pu_dB", np.array([-5.0, 5.0, 15.0]))
        self.params.set_unpack_parameter("Pu_dB")
        self.rep_max = 8
        self.batch_size = 4
        self.K, self.nr_u = K, nr_u
        self.num_tiles = num_tiles
        self.noise_var = 1.0
        self.mc = MonteCarloBD(tile=tile, lane=lane, K=K, Nr_u=nr_u,
                               device=self.device)
        self.progressbar_message = "BD kernel capacity - Pu {Pu_dB}"
        self.update_progress_function_style = "text2"
        self.batch_result_types = {"sum_capacity": Result.RATIOTYPE}
        self.chunks_dispatched = 0
        self._fns = {}

    def _gen_bulk_kernel(self, current_parameters):
        iPu = float(dB2Linear(float(current_parameters["Pu_dB"])))
        mc, nt, nv = self.mc, self.num_tiles, self.noise_var
        solves_per_rep = float(nt * mc.solves_per_grid_step)
        unpack_idx = max(current_parameters.unpack_index, 0)
        seed = kernel_stream_seed(self.base_seed, unpack_idx)
        mesh = self.mesh      # set by simulate_in_parallel: reps sharded

        def bulk(start, n):
            self.chunks_dispatched += 1
            if (n, mesh) not in self._fns:
                self._fns[n, mesh] = mc.build(n, nt, mesh=mesh)
            caps = self._fns[n, mesh](seed, start, iPu=iPu, noise_var=nv)
            # device tensors, not synchronised
            return {"sum_capacity": (caps.sum(dim=1),
                                     np.full(n, solves_per_rep))}

        return bulk


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("geometry", nargs="*", type=int,
                        help="K Nr_u (default 3 2)")
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()
    K, nr_u = args.geometry if len(args.geometry) == 2 else (3, 2)
    for mode in ("global", "none"):
        runner = BatchedBDCapacityRunner(mode, K=K, nr_u=nr_u,
                                         device=args.device)
        runner.simulate()
        caps = np.array(
            runner.results.get_result_values_list("sum_capacity"))
        label = {"global": "waterfilling", "none": "equal power"}[mode]
        print(f"{label:13s} ({runner.elapsed_time}): "
              + " ".join(f"{c:6.2f}" for c in caps))
    # the kernel tier at a geometry other than the bench's
    kr = BDKernelCapacityRunner(K=2, nr_u=2, device=args.device)
    kr.simulate()
    caps = np.array(kr.results.get_result_values_list("sum_capacity"))
    print(f"kernel (2,2)  ({kr.elapsed_time}): "
          + " ".join(f"{c:6.2f}" for c in caps))


if __name__ == "__main__":
    main()
