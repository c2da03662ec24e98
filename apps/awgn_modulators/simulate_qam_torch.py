#!/usr/bin/env python
"""M-QAM over AWGN on the port: a minimal runner subclass.

The PyTorch counterpart of ``apps/awgn_modulators/simulate_qam.py``: only
the modulator and the SNR grid change from the PSK runner.

Run:  python apps/awgn_modulators/simulate_qam_torch.py [--device cuda]
"""

import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from apps.awgn_modulators.simulate_psk_torch import (  # noqa: E402
    VerySimplePskSimulationRunner, device_arg, print_and_plot)
from pyphysim_tpu_torch.modulators import QAM  # noqa: E402


class VerySimpleQamSimulationRunner(VerySimplePskSimulationRunner):
    """BER/SER of 16-QAM over AWGN; everything inherited but the
    modulator."""

    def __init__(self, device="cuda", read_command_line_args: bool = True):
        super().__init__(device=device,
                         read_command_line_args=read_command_line_args)
        M = 16
        self.params.add("SNR", np.array([0.0, 3, 6, 9, 12, 15, 18]))
        self.params.add("M", M)
        self.params.set_unpack_parameter("SNR")
        self.modulator = QAM(M, device=self.device)
        self.progressbar_message = f"{M}-QAM Simulation - SNR: {{SNR}}"


def main():
    sim = VerySimpleQamSimulationRunner(device=device_arg())
    sim.simulate()
    print_and_plot(sim, "qam_awgn.png")


if __name__ == "__main__":
    main()
