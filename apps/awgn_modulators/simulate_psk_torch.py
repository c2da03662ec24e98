#!/usr/bin/env python
"""Monte Carlo BER/SER of M-PSK over AWGN, on the port.

The PyTorch counterpart of ``apps/awgn_modulators/simulate_psk.py``: the
per-attempt chain (draw symbols -> modulate -> AWGN -> demodulate -> count
errors) is a per-key kernel over a chunk of attempts' streams
(``ops/streams.py`` ``AttemptStreams``); the runner sweeps the SNR and
handles early stop, checkpointing and progress. ``simulate_do_what_i_mean``
shards the sweep over the ranks when the process runs in a
``torch.distributed`` group of several ranks.

Run:  python apps/awgn_modulators/simulate_psk_torch.py [-c config]
[-i index] [--device cuda]
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.modulators import PSK  # noqa: E402
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationRunner,
                                            simulate_do_what_i_mean)
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402
from pyphysim_tpu_torch.utils.misc import (count_bit_errors,  # noqa: E402
                                           randn_c)

CONFIG_SPEC = """
[Simulation]
SNR = real_numpy_array(min=-50, max=100, default=0:2:19)
M = integer(min=2, max=256, default=4)
NSymbs = integer(min=10, max=1000000, default=1000)
rep_max = integer(min=1, default=500)
max_bit_errors = integer(min=1, default=3000)
unpacked_parameters = string_list(default=list('SNR'))
"""


class VerySimplePskSimulationRunner(SimulationRunner):
    """BER/SER of M-PSK over AWGN (per-key path): attempt ``a`` draws its
    ``NSymbs`` symbols and noise from its own streams."""

    def __init__(self, config_file=None, device="cuda",
                 read_command_line_args: bool = True):
        super().__init__(default_config_file=config_file,
                         config_spec=CONFIG_SPEC,
                         read_command_line_args=read_command_line_args)
        self.device = require_cuda(device)
        if "SNR" not in self.params:
            self.params.add("SNR", np.arange(0.0, 19.0, 2.0))
            self.params.add("M", 4)
            self.params.add("NSymbs", 1000)
            self.params.add("max_bit_errors", 3000)
            self.params.set_unpack_parameter("SNR")
            self.rep_max = 500
        else:
            self.rep_max = int(self.params["rep_max"])
        self.modulator = PSK(int(self.params["M"]), device=self.device)
        self.progressbar_message = "{M}-PSK Simulation - SNR {SNR}"
        self.batch_result_types = {
            "symbol_errors": Result.SUMTYPE,
            "num_symbols": Result.SUMTYPE,
            "bit_errors": Result.SUMTYPE,
            "num_bits": Result.SUMTYPE,
            "ber": Result.RATIOTYPE,
            "ser": Result.RATIOTYPE,
        }

    def _gen_simulation_kernel(self, current_parameters):
        snr = dB2Linear(float(current_parameters["SNR"]))
        nsymbs = int(self.params["NSymbs"])
        mod = self.modulator
        noise_scale = float(np.sqrt(1.0 / snr))

        def kernel(streams):
            s_data, s_noise = streams.split(2)
            data = s_data.integers(mod.M, (nsymbs,))
            rx = mod.modulate(data) + randn_c(s_noise, nsymbs) * noise_scale
            decided = mod.demodulate(rx)
            symbol_errors = (decided != data).sum(dim=-1)
            bit_errors = count_bit_errors(data, decided, axis=-1)
            n, nb = float(nsymbs), float(nsymbs * mod.K)
            return {"symbol_errors": symbol_errors,
                    "num_symbols": np.full(streams.n, nsymbs),
                    "bit_errors": bit_errors,
                    "num_bits": np.full(streams.n, nsymbs * mod.K),
                    "ber": (bit_errors, nb), "ser": (symbol_errors, n)}

        return kernel

    def _keep_going(self, current_params, current_sim_results, current_rep):
        if "bit_errors" in current_sim_results and \
                current_sim_results["bit_errors"]:
            cumulated = current_sim_results["bit_errors"][-1].get_result()
            return cumulated < self.params["max_bit_errors"]
        return True

    def get_data_to_be_plotted(self):
        """(SNR, ber, ser, theoretical_ber, theoretical_ser)."""
        snr = np.asarray(self.results.params["SNR"], dtype=float)
        ber = np.asarray(self.results.get_result_values_list("ber"))
        ser = np.asarray(self.results.get_result_values_list("ser"))
        theoretical_ber = self.modulator.calcTheoreticalBER(snr)
        theoretical_ser = self.modulator.calcTheoreticalSER(snr)
        return snr, ber, ser, theoretical_ber, theoretical_ser


def device_arg() -> str:
    """The ``--device`` option of the AWGN apps (default ``cuda``)."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda")
    return parser.parse_known_args()[0].device


def print_and_plot(sim, png: str) -> None:
    """Print a finished runner's BER against theory and, where matplotlib
    is installed, save the BER / SER plot to ``png``."""
    snr, ber, ser, t_ber, t_ser = sim.get_data_to_be_plotted()
    print("Elapsed time:", sim.elapsed_time)
    print("SNR:", snr)
    print("BER:", ber)
    print("Theoretical BER:", t_ber)
    try:
        from matplotlib import pyplot as plt
    except ImportError:
        return
    plt.semilogy(snr, ber, "--g*", label="BER")
    plt.semilogy(snr, ser, "--b*", label="SER")
    plt.semilogy(snr, t_ber, "-g+", label="Theoretical BER")
    plt.semilogy(snr, t_ser, "-b+", label="Theoretical SER")
    plt.xlabel("SNR")
    plt.ylabel("Error")
    plt.title(f"BER and SER for {sim.modulator.name} in AWGN channel")
    plt.legend()
    plt.grid(True, which="both", axis="both")
    plt.savefig(png, dpi=120)
    print(f"Saved plot to {png}")


def main():
    runner = VerySimplePskSimulationRunner(device=device_arg())
    runner.set_results_filename("psk_results_{M}-PSK_{SNR}")
    simulate_do_what_i_mean(runner)

    print("Elapsed time:", runner.elapsed_time)
    print("SNR:", runner.results.params["SNR"])
    print("BER:", runner.results.get_result_values_list("ber"))
    print("Theory:", runner.modulator.calcTheoreticalBER(
        np.asarray(runner.results.params["SNR"], dtype=float)))


if __name__ == "__main__":
    main()
