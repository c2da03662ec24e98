#!/usr/bin/env python
"""K-user interference over TDL channels in the frequency domain, on the
PyTorch port: the symbol error rate of receiver 0 with one-tap
equalization of its own link and the other transmitters as interference.

The sweep of the JAX package's ``tests/test_multiuser_comm.py``
(``test_k3_mumimo_ofdm_sweep_through_batch_runner``) at the flagship's
widths: QPSK on the used carriers of an OFDM grid (300 of a 512 FFT, 14
OFDM symbols an attempt), a ``MuMimoChannel`` of K users (1 x 1 antennas
a link, COST259-TU with Jakes Doppler, Ts = 50 ns), block-static over each
OFDM symbol (``corrupt_data_in_freq_domain`` at the used carriers), an
optional per-link path loss, AWGN at the SNR of a unit-power link.

It runs through the runner's per-key path: a chunk of attempts is one
batched call, its data, channel states and noise drawn from the attempts'
own streams (three ``philox_stream_fill`` launches on the card), so the
result does not depend on the chunk size. The K^2 links of all the
chunk's attempts are one ``TdlChannel`` call.

Run: ``python apps/mimo/mu_mimo_interference_torch.py [--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.channels import (COST259_TUx,  # noqa: E402
                                         JakesSampleGenerator,
                                         MuMimoChannel)
from pyphysim_tpu_torch.modulators import OFDM, QPSK  # noqa: E402
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationRunner)
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402
from pyphysim_tpu_torch.utils.misc import randn_c  # noqa: E402

# the path losses of the JAX package's MuChannel test (rx, tx)
JAX_TEST_PATHLOSS = np.array([[1.0, 0.1, 0.1],
                              [0.2, 0.9, 0.05],
                              [0.3, 0.1, 0.8]])


class MuMimoInterferenceRunner(SimulationRunner):
    """Receiver 0's SER over a K-user TDL interference channel (see the
    module docstring), swept over ``SNR`` (dB) on the per-key path."""

    def __init__(self, K: int = 3, fft_size: int = 512, num_used: int = 300,
                 num_symbols: int = 14, pathloss=None, Fd: float = 30.0,
                 Ts: float = 1.0 / 20e6, L: int = 16, device="cuda",
                 read_command_line_args: bool = True):
        super().__init__(read_command_line_args=read_command_line_args)
        self.device = require_cuda(device)
        self.params.add("SNR", np.array([10.0, 20.0, 30.0]))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 4096
        self.batch_size = 256
        self.update_progress_function_style = None
        self.K = int(K)
        self.fft_size = int(fft_size)
        self.num_symbols = int(num_symbols)
        self.carriers = OFDM(fft_size, 0, num_used, device="cpu") \
            .get_used_subcarrier_indexes()
        self.num_used = int(num_used)
        self.modulator = QPSK(device=self.device)
        self.mu = MuMimoChannel(
            self.K, 1, 1, JakesSampleGenerator(Fd, Ts, L,
                                               device=self.device),
            COST259_TUx)
        self.mu.set_pathloss(pathloss)
        self.batch_result_types = {"symbol_errors": Result.SUMTYPE,
                                   "ser": Result.RATIOTYPE}
        self.chunks_dispatched = 0

    @property
    def symbols_per_attempt(self) -> int:
        return self.num_used * self.num_symbols

    def symbol_errors(self, streams, snr_linear: float) -> torch.Tensor:
        """Receiver 0's symbol errors of each attempt of ``streams``
        (int64, one per attempt)."""
        n_sym, nb = self.symbols_per_attempt, self.num_symbols
        s_data, s_channel, s_noise = streams.split(3)
        data = s_data.integers(4, (self.K, n_sym))      # (n, K, n_sym)
        tx = self.modulator.modulate(data).unsqueeze(-2)  # one tx antenna
        states = self.mu.init_state(s_channel)
        rx, irs, _ = self.mu.corrupt_data_in_freq_domain(
            states, tx, self.fft_size, self.carriers)
        y = rx[0][:, 0] + randn_c(s_noise, n_sym) * \
            np.float32(np.sqrt(1.0 / snr_linear))
        # one-tap equalization by the desired link's response, per block
        h = self.mu.get_last_impulse_response(0, 0, irs) \
            .get_freq_response(self.fft_size)[:, 0, 0][..., self.carriers]
        y_eq = (y.reshape(-1, nb, self.num_used) / h).reshape(-1, n_sym)
        return (self.modulator.demodulate(y_eq) != data[:, 0]).sum(dim=-1)

    def _gen_simulation_kernel(self, current_parameters):
        snr = dB2Linear(float(current_parameters["SNR"]))
        n_sym = float(self.symbols_per_attempt)

        def kernel(streams):
            self.chunks_dispatched += 1
            errors = self.symbol_errors(streams, snr)
            return {"symbol_errors": errors, "ser": (errors, n_sym)}

        return kernel


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--equal-power", action="store_true",
                        help="no path loss (the JAX test's case); default: "
                        "the JAX test's path-loss matrix")
    args, _ = parser.parse_known_args()
    runner = MuMimoInterferenceRunner(
        pathloss=None if args.equal_power else JAX_TEST_PATHLOSS,
        device=args.device)
    runner.simulate()
    print("SNR:", runner.results.params["SNR"])
    print("SER:", np.array(runner.results.get_result_values_list("ser")))
    print("Elapsed time:", runner.elapsed_time)


if __name__ == "__main__":
    main()
