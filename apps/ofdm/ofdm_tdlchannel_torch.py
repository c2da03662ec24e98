#!/usr/bin/env python
"""16-QAM OFDM transmission over a time-varying COST259 TDL channel, on the
PyTorch / CUDA port.

The counterpart of ``apps/ofdm/ofdm_tdlchannel.py`` (the north-star
chain): 16-QAM -> OFDM(512, cp 52, 300 used) -> Jakes/COST259-TU TDL with a
per-sample channel -> AWGN -> one-tap equalizer -> hard demodulation, the
same sweep (0 to 30 dB in steps of 5, 100 repetitions of 4 OFDM symbols).
Each chunk of repetitions is one batched call of the chain
(``pyphysim_tpu_torch/chain.py``) through the runner's per-key path
(``_gen_simulation_kernel``): repetition ``a`` draws its data, channel and
noise from the streams of absolute attempt ``a``.

Run: ``python apps/ofdm/ofdm_tdlchannel_torch.py [--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.chain import ChainStep  # noqa: E402
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationRunner)
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402


class OfdmTdlSimulationRunner(SimulationRunner):
    def __init__(self, device="cuda", read_command_line_args: bool = True):
        super().__init__(read_command_line_args=read_command_line_args)
        self.device = require_cuda(device)
        self.params.add("SNR", np.arange(0.0, 31.0, 5.0))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 100
        self.update_progress_function_style = "text2"
        self.fft_size = 512
        self.cp_size = 52
        self.num_used = 300
        self.num_ofdm_symbols = 4
        self.chain = ChainStep(self.num_used * self.num_ofdm_symbols,
                               self.fft_size, self.cp_size, self.num_used,
                               device=self.device)
        self.batch_result_types = {
            "bit_errors": Result.SUMTYPE,
            "ber": Result.RATIOTYPE,
        }
        self.chunks_dispatched = 0

    def _gen_simulation_kernel(self, current_parameters):
        snr = dB2Linear(float(current_parameters["SNR"]))
        chain = self.chain

        def kernel(streams):
            self.chunks_dispatched += 1
            bit_errors = chain.step(streams, snr)
            return {"bit_errors": bit_errors,
                    "ber": (bit_errors, float(chain.bits_per_attempt))}

        return kernel


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()
    runner = OfdmTdlSimulationRunner(device=args.device)
    runner.simulate()
    print("\nElapsed time:", runner.elapsed_time)
    print("SNR:", runner.results.params["SNR"])
    print("BER:", np.array(runner.results.get_result_values_list("ber")))


if __name__ == "__main__":
    main()
