#!/usr/bin/env python
"""4x4 spatial multiplexing over LTE 20 MHz OFDM on the 3GPP EVA70
channel, with per-subcarrier MMSE detection, on the PyTorch / CUDA port.

The LTE downlink link-level setting: 4 transmit x 4 receive antennas, 4
layers of uncoded 16-QAM (``mimo.Blast``'s 1/sqrt(Nt) split); the 20 MHz
numerology of 3GPP TS 36.211 (Table 6.12-1: 30.72 MHz sampling, 2,048-point
FFT, 1,200 used subcarriers, a normal cyclic prefix of 144 samples, 14 OFDM
symbols a 1 ms subframe); the Extended Vehicular A profile of TS 36.101
Annex B.2.1 (Table B.2.1-3) at 70 Hz Doppler (Table B.2.2-1), with low
MIMO correlation (B.2.3.1: the 16 links independent), Jakes fading with 16
rays, the channel held over each OFDM symbol; perfect CSI and Blast's MMSE
filter on each subcarrier. One attempt is one subframe: 4 x 14 x 1,200 =
67,200 symbols, 268,800 bits.

Each chunk of attempts is one call of the MIMO step
(``pyphysim_tpu_torch/mimo_chain.py``) through the runner's per-key path
(``_gen_simulation_kernel``): attempt ``a`` draws its data, channel and
noise from the streams of absolute attempt ``a``; on CUDA each call after
the first at an attempt count replays one captured CUDA graph. The sweep:
0 to 40 dB by 10, each point until 10,000 bit errors or 4,096 subframes,
chunks of 256 run as 8 sub-chunks of 32 under the stop rule.

Run: ``python apps/mimo/mimo_ofdm_tdl_torch.py [--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.channels import (JakesSampleGenerator,  # noqa: E402
                                         TdlChannel, TdlChannelProfile)
from pyphysim_tpu_torch.mimo_chain import MimoChainStep  # noqa: E402
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationRunner)
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402

# 3GPP TS 36.101 Table B.2.1-3: Extended Vehicular A
EVA_DELAYS_S = np.array([0, 30, 150, 310, 370, 710, 1090, 1730, 2510]) * 1e-9
EVA_POWERS_DB = np.array([0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0,
                          -16.9])
DOPPLER_HZ = 70.0      # EVA70, Table B.2.2-1
JAKES_RAYS = 16


def eva_channel(num_rx: int, num_tx: int, bandwidth_hz: float = 30.72e6,
                device="cuda") -> TdlChannel:
    """A ``num_rx`` x ``num_tx`` EVA70 channel on a Jakes generator at the
    sampling rate ``bandwidth_hz``."""
    jakes = JakesSampleGenerator(Fd=DOPPLER_HZ, Ts=1.0 / bandwidth_hz,
                                 L=JAKES_RAYS, device=device)
    channel = TdlChannel(jakes, TdlChannelProfile(EVA_POWERS_DB,
                                                  EVA_DELAYS_S, "EVA"))
    channel.set_num_antennas(num_rx, num_tx)
    return channel


class MimoOfdmTdlSimulationRunner(SimulationRunner):
    """The sweep above; ``chain`` replaces the default step (another
    configuration's :class:`MimoChainStep`)."""

    def __init__(self, device="cuda", read_command_line_args: bool = True,
                 chain: MimoChainStep = None):
        super().__init__(read_command_line_args=read_command_line_args)
        self.device = require_cuda(device)
        self.params.add("SNR", np.arange(0.0, 41.0, 10.0))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 4096
        self.batch_size = 256
        self.num_stop_subchunks = 8
        self.batch_stop_criterion = ("bit_errors", 10000.0)
        self.update_progress_function_style = "text2"
        if chain is None:
            chain = MimoChainStep(
                4, 4, 16, 1200 * 14, 2048, 144, 1200,
                eva_channel(4, 4, device=self.device), device=self.device)
        self.chain = chain
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
    runner = MimoOfdmTdlSimulationRunner(device=args.device)
    runner.simulate()
    print("\nElapsed time:", runner.elapsed_time)
    print("SNR:", runner.results.params["SNR"])
    print("BER:", np.array(runner.results.get_result_values_list("ber")))
    print("subframes:", list(runner.runned_reps))


if __name__ == "__main__":
    main()
