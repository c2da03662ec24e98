#!/usr/bin/env python
"""OFDM-over-TDL BER sweep driven by the port's Monte Carlo CUDA kernel.

The PyTorch / CUDA counterpart of ``apps/ofdm/ofdm_mc_kernel.py``: the same
16-QAM / OFDM(512, cp 52, 300 used) / COST259-TU chain with Jakes Doppler,
with the whole Monte Carlo repetition in one kernel
(``pyphysim_tpu_torch/ops/mc_kernel.py``) plugged into ``SimulationRunner``
through the bulk path (``_gen_bulk_kernel``). The runner provides the
parameter sweep, Result accumulation, checkpoint/resume and early stop.

On ``device="cuda"`` the kernel draws its bits from Philox streams keyed by
``kernel_stream_seed(base_seed, unpack_index)`` and the absolute attempt;
on ``device="cpu"`` the plain PyTorch version runs on the same Philox bits.
Setting ``bit_source`` instead supplies the bits of each attempt from the
host (inject mode), which is how the tests hold the port against the JAX
app on identical bits. ``matmul_dtype="bfloat16"`` runs the kernel's bf16
channel-product mode (the JAX option ``matmul_dtype=jnp.bfloat16`` that
``bench.py`` times).

Run: ``python apps/ofdm/ofdm_mc_kernel_torch.py [--device cuda]
[--matmul-dtype bfloat16]``.
"""

import argparse
import sys
from typing import Callable, Optional

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.channels import (COST259_TUx,  # noqa: E402
                                         JakesSampleGenerator, TdlChannel)
from pyphysim_tpu_torch.modulators import OFDM  # noqa: E402
from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl  # noqa: E402
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationRunner,
                                            kernel_stream_seed)
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402


class OfdmMcKernelSimulationRunner(SimulationRunner):
    """16-QAM / OFDM(512, cp 52, 300 used) / COST259-TU with Jakes
    Doppler, one repetition = ``num_tiles * tile`` OFDM symbols.

    ``bit_source``: None (PRNG mode), or a callable
    ``(unpack_index, start, n) -> (phase_bits, data_bits, n1_bits,
    n2_bits)`` returning the bits of attempts ``[start, start + n)`` in the
    inject layout of :meth:`MonteCarloOfdmTdl.build_inject`.
    """

    def __init__(self, device="cuda", read_command_line_args: bool = True,
                 matmul_dtype="float32"):
        super().__init__(read_command_line_args=read_command_line_args)
        self.device = require_cuda(device)
        self.params.add("SNR", np.arange(0.0, 31.0, 5.0))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 16
        self.batch_size = 8
        self.update_progress_function_style = "text2"
        self.tile = 128              # OFDM symbols per kernel grid step
        self.num_tiles = 2           # grid steps (tiles) per repetition
        bandwidth = 20e6
        self.ofdm = OFDM(512, 52, 300, device=self.device)
        self.jakes = JakesSampleGenerator(Fd=30.0, Ts=1.0 / bandwidth, L=16,
                                          device=self.device)
        self.channel = TdlChannel(self.jakes, COST259_TUx)
        self.mc = MonteCarloOfdmTdl(self.ofdm, self.channel, M=16,
                                    tile=self.tile, matmul_dtype=matmul_dtype,
                                    device=self.device)
        self.batch_result_types = {
            "bit_errors": Result.SUMTYPE,
            "ber": Result.RATIOTYPE,
        }
        self.bit_source: Optional[Callable] = None
        self.chunks_dispatched = 0
        self._fns = {}

    # -- the bulk kernel ---------------------------------------------------

    def _bits_per_rep(self) -> int:
        return self.num_tiles * self.tile * self.mc.used * \
            self.mc.bits_per_symbol

    def _gen_bulk_kernel(self, current_parameters):
        mc, nt = self.mc, self.num_tiles
        if mc.tile != self.tile:
            raise ValueError(f"runner tile {self.tile} != kernel tile "
                             f"{mc.tile}: rebuild self.mc")
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
    parser.add_argument("--matmul-dtype", default="float32",
                        choices=("float32", "bfloat16"))
    args, _ = parser.parse_known_args()
    runner = OfdmMcKernelSimulationRunner(device=args.device,
                                          matmul_dtype=args.matmul_dtype)
    runner.simulate()
    print("\nElapsed time:", runner.elapsed_time)
    print("SNR:", runner.results.params["SNR"])
    print("BER:", np.array(runner.results.get_result_values_list("ber")))
    total = runner.rep_max * runner._bits_per_rep() // 4
    print(f"({len(runner.results.params['SNR'])} SNR points x "
          f"{total:,} symbols each)")


if __name__ == "__main__":
    main()
