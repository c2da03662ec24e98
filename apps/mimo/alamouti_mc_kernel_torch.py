#!/usr/bin/env python
"""Alamouti 2x1 QPSK BER sweep driven by the port's Alamouti CUDA kernel.

The PyTorch / CUDA counterpart of ``apps/mimo/alamouti_mc_kernel.py``:
QPSK -> Alamouti 2x1 -> flat Rayleigh fading held per (repetition, lane)
-> AWGN -> matched combining -> hard decisions, with the whole Monte Carlo
repetition in one kernel (``pyphysim_tpu_torch/ops/alamouti_kernel.py``)
plugged into ``SimulationRunner`` through the bulk path
(``_gen_bulk_kernel``). The runner provides the SNR sweep, Result
accumulation, checkpoint/resume and early stop.

On ``device="cuda"`` the kernel draws its bits from Philox streams keyed by
``kernel_stream_seed(base_seed, unpack_index)`` and the absolute attempt;
on ``device="cpu"`` the plain PyTorch version runs on the same Philox bits.
Setting ``bit_source`` instead supplies the bits of each attempt from the
host (inject mode), which is how the tests hold the port against the JAX
app on identical bits.

Run: ``python apps/mimo/alamouti_mc_kernel_torch.py [--device cuda]``.
"""

import argparse
import sys
from typing import Callable, Optional

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.ops.alamouti_kernel import \
    MonteCarloAlamouti  # noqa: E402
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationRunner,
                                            kernel_stream_seed)
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402


class AlamoutiMcKernelSimulationRunner(SimulationRunner):
    """QPSK / Alamouti 2x1 / iid flat Rayleigh; one repetition =
    ``num_tiles * tile * lane * 2`` symbols (lanes are independent channel
    streams).

    ``bit_source``: None (PRNG mode), or a callable
    ``(unpack_index, start, n) -> (ch, d, n1r, n1i, n2r, n2i)`` returning
    the bits of attempts ``[start, start + n)`` in the inject layout of
    :meth:`MonteCarloAlamouti.build_inject`.
    """

    def __init__(self, tile: int = 64, lane: int = 256, num_tiles: int = 2,
                 device="cuda", read_command_line_args: bool = True):
        super().__init__(read_command_line_args=read_command_line_args)
        self.device = require_cuda(device)
        self.params.add("SNR", np.arange(0.0, 21.0, 5.0))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 16
        self.batch_size = 8
        self.update_progress_function_style = "text2"
        self.num_tiles = num_tiles
        self.mc = MonteCarloAlamouti(tile=tile, lane=lane,
                                     device=self.device)
        self.batch_result_types = {
            "bit_errors": Result.SUMTYPE,
            "ber": Result.RATIOTYPE,
        }
        self.bit_source: Optional[Callable] = None
        self.chunks_dispatched = 0
        self._fns = {}

    def _bits_per_rep(self) -> int:
        return self.num_tiles * self.mc.symbols_per_grid_step * 2

    def _gen_bulk_kernel(self, current_parameters):
        mc, nt = self.mc, self.num_tiles
        snr = dB2Linear(float(current_parameters["SNR"]))
        bits_per_rep = float(self._bits_per_rep())
        unpack_idx = max(current_parameters.unpack_index, 0)
        seed = kernel_stream_seed(self.base_seed, unpack_idx)
        source = self.bit_source
        # under simulate_in_parallel the chunk's reps are split over the
        # mesh, each rank from its own absolute attempt (the builds' mesh=)
        mesh = self.mesh

        def bulk(start, n):
            self.chunks_dispatched += 1
            fkey = (n, source is None, mesh)
            if fkey not in self._fns:
                self._fns[fkey] = (mc.build(n, nt, mesh=mesh)
                                   if source is None
                                   else mc.build_inject(n, nt, mesh=mesh))
            if source is None:
                counts = self._fns[fkey](seed, snr, start)
            else:
                counts = self._fns[fkey](*source(unpack_idx, start, n),
                                         mc.amp(snr))
            # device tensors, not synchronised: the runner fetches them
            # after it has enqueued the next chunk
            counts = counts.sum(dim=1)
            return {"bit_errors": counts,
                    "ber": (counts, np.full(n, bits_per_rep))}

        return bulk


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()
    runner = AlamoutiMcKernelSimulationRunner(device=args.device)
    runner.simulate()
    print("\nElapsed time:", runner.elapsed_time)
    print("SNR:", runner.results.params["SNR"])
    print("BER:", np.array(runner.results.get_result_values_list("ber")))


if __name__ == "__main__":
    main()
