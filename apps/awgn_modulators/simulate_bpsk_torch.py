#!/usr/bin/env python
"""BPSK over AWGN on the port: a minimal runner subclass.

The PyTorch counterpart of ``apps/awgn_modulators/simulate_bpsk.py``: only
the modulator and the SNR grid change from the PSK runner; the per-key
kernel, early stop, checkpointing and progress all come from it.

Run:  python apps/awgn_modulators/simulate_bpsk_torch.py [--device cuda]
"""

import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from apps.awgn_modulators.simulate_psk_torch import (  # noqa: E402
    VerySimplePskSimulationRunner, device_arg, print_and_plot)
from pyphysim_tpu_torch.modulators import BPSK  # noqa: E402


class VerySimpleBpskSimulationRunner(VerySimplePskSimulationRunner):
    """BER/SER of BPSK over AWGN; everything inherited but the modulator."""

    def __init__(self, device="cuda", read_command_line_args: bool = True):
        super().__init__(device=device,
                         read_command_line_args=read_command_line_args)
        self.params.add("SNR", np.array([0.0, 2, 4, 6, 8, 10]))
        self.params.add("M", 2)
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 5000
        self.modulator = BPSK(device=self.device)
        self.progressbar_message = "BPSK Simulation - SNR: {SNR}"


def main():
    sim = VerySimpleBpskSimulationRunner(device=device_arg())
    sim.simulate()
    print_and_plot(sim, "bpsk_awgn.png")


if __name__ == "__main__":
    main()
