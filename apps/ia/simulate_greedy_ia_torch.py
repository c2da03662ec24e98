#!/usr/bin/env python
"""IA with greedy / brute-force stream selection: BER + capacity sweep, on
the PyTorch port.

The counterpart of ``apps/ia/simulate_greedy_ia.py``, with the same config
file, result names and command line: an MMSE-IA simulation where the
number of streams per user is chosen by the GreedStream meta-solver
(drop the worst-SINR stream while sum capacity improves), the BruteForce
meta-solver (try every stream-count combination), or not at all
('none'). Driven by ``greedy_config_file.txt``: the sweep
unpacks SNR x stream_sel_method x scenario x initialize_with, where
scenario is 'NoPathLoss' (unit-gain channels) or 'Random' (users dropped
uniformly in a hexagonal cell grid with 3GPP path loss, transmit power set
to hit the target SNR at the cell border). Tracks BER, sum capacity,
solver iterations and the chosen stream configuration as a CHOICETYPE
histogram.

The meta-solvers and the IA solver run on the host in numpy, one
repetition at a time, as the JAX app's; the channel matrix, its products
and its noise live on ``--device`` (the card unless the caller asks for
the CPU). ``channel_draws`` (a callable returning the next repetition's
channel matrix and unit-variance noise, numpy) replaces the channel's own
draws, so that two runs (another device, or the JAX app) see the same
channels.

Run:  python apps/ia/simulate_greedy_ia_torch.py [-c config] [-i index]
[--device cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.cell import cell  # noqa: E402
from pyphysim_tpu_torch.channels import multiuser, pathloss  # noqa: E402
from pyphysim_tpu_torch.ia import algorithms  # noqa: E402
from pyphysim_tpu_torch.modulators import fundamental  # noqa: E402
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationResults,
                                            SimulationRunner, SkipThisOne,
                                            simulate_do_what_i_mean)
from pyphysim_tpu_torch.utils.conversion import (dB2Linear,  # noqa: E402
                                                 dBm2Linear)
from pyphysim_tpu_torch.utils.misc import (count_bit_errors,  # noqa: E402
                                           level2bits)

# The JAX app's spec.
SPEC = """[Grid]
cell_radius=float(min=0.01, default=1.0)
num_cells=integer(min=3, default=3)
num_clusters=integer(min=1, default=1)
[Scenario]
NSymbs=integer(min=10, max=1000000, default=200)
SNR=real_numpy_array(min=-50, max=100, default=0:5:31)
M=integer(min=4, max=512, default=4)
modulator=option('QPSK', 'PSK', 'QAM', 'BPSK', default="PSK")
Nr=integer_scalar_or_integer_numpy_array_check(min=2, default=3)
Nt=integer_scalar_or_integer_numpy_array_check(min=2, default=3)
Ns=integer_scalar_or_integer_numpy_array_check(min=1, default=3)
N0=float(default=-116.4)
scenario=string_list(default=list('Random', 'NoPathLoss'))
[IA Algorithm]
max_iterations=integer(min=1, default=120)
initialize_with=string_list(default=list('random'))
stream_sel_method=string_list(default=list('greedy', 'brute'))
[General]
rep_max=integer(min=1, default=2000)
max_bit_errors=integer(min=1, default=3000)
unpacked_parameters=string_list(default=list('SNR', 'stream_sel_method', 'scenario', 'initialize_with'))
""".split("\n")


class IAStreamSelSimulationRunner(SimulationRunner):
    """BER/sum-capacity of MMSE IA under stream-selection policies, the
    channel on ``device``."""

    def __init__(self, default_config_file: str = "greedy_config_file.txt",
                 read_command_line_args: bool = True, device="cuda"):
        device = require_cuda(device)
        super().__init__(default_config_file, SPEC, read_command_line_args)
        self.rep_max = int(self.params["rep_max"])
        self.device = device

        self.multiUserChannel = multiuser.MultiUserChannelMatrix(
            device=self.device)
        self.path_loss_obj = pathloss.PathLoss3GPP1()
        self.channel_draws = None

        # seeds kept explicit for debugging replays
        self.channel_seed = None
        self.noise_seed = None
        self.data_gen_seed = int(np.random.randint(10000))
        self.multiUserChannel.set_channel_seed(self.channel_seed)
        self.multiUserChannel.set_noise_seed(self.noise_seed)
        self.data_RS = np.random.RandomState(self.data_gen_seed)

        M = int(self.params["M"])
        modulator_options = {"PSK": fundamental.PSK,
                             "QPSK": fundamental.QPSK,
                             "QAM": fundamental.QAM,
                             "BPSK": fundamental.BPSK}
        name = str(self.params["modulator"])
        # the symbols are mapped on the host (numpy in, numpy out)
        self.modulator = (
            modulator_options[name](device="cpu") if name in
            ("QPSK", "BPSK") else modulator_options[name](M, device="cpu"))

        self.progressbar_message = "SNR: {SNR}"

        # hexagonal cell grid for the 'Random' scenario
        self.cell_grid = cell.Grid()
        self.cell_grid.create_clusters(int(self.params["num_clusters"]),
                                       int(self.params["num_cells"]),
                                       float(self.params["cell_radius"]))
        self.noise_var = None
        self._path_loss_border = self.path_loss_obj.calc_path_loss(
            float(self.params["cell_radius"]))

        self.ia_solver = algorithms.MMSEIASolver(self.multiUserChannel)
        self.ia_top_object = None

    # -- scenario construction ----------------------------------------------

    @staticmethod
    def _calc_transmit_power(SNR_dB, noise_var, path_loss=1.0):
        """Transmit power achieving the desired mean SNR at the cell
        border."""
        return dB2Linear(SNR_dB) * noise_var / path_loss

    def _create_random_users_scenario(self, current_params):
        cluster0 = self.cell_grid.get_cluster_from_index(0)
        cell_ids = np.arange(1, int(current_params["num_cells"]) + 1)
        cluster0.delete_all_users()
        cluster0.add_random_users(cell_ids)

    def _create_users_channels_according_to_scenario(self, current_params):
        """The repetition's channel (and its unit noise, when
        ``channel_draws`` gives it; None: the channel draws its own)."""
        Nr, Nt = current_params["Nr"], current_params["Nt"]
        K = int(current_params["num_cells"])
        noise = None
        if self.channel_draws is None:
            self.multiUserChannel.randomize(Nr, Nt, K)
        else:
            big_H, noise = self.channel_draws()
            self.multiUserChannel.init_from_channel_matrix(big_H, Nr, Nt, K)
        scenario = str(current_params["scenario"])
        if scenario == "NoPathLoss":
            self.cell_grid.get_cluster_from_index(0).delete_all_users()
        elif scenario == "Random":
            self._create_random_users_scenario(current_params)
            cluster0 = self.cell_grid.get_cluster_from_index(0)
            dists = cluster0.calc_dist_all_users_to_each_cell()
            pl = self.path_loss_obj.calc_path_loss(dists)
            self.multiUserChannel.set_pathloss(pl)
        else:
            raise RuntimeError(f"Invalid scenario: {scenario}")
        return noise

    # -- one repetition -------------------------------------------------------

    def _run_simulation(self, current_parameters):
        noise = self._create_users_channels_according_to_scenario(
            current_parameters)

        M = self.modulator.M
        NSymbs = int(current_parameters["NSymbs"])
        K = int(current_parameters["num_cells"])
        Ns = current_parameters["Ns"]
        SNR = float(current_parameters["SNR"])

        if str(current_parameters["scenario"]) == "NoPathLoss":
            pt = self._calc_transmit_power(SNR, self.noise_var)
        else:
            pt = self._calc_transmit_power(SNR, self.noise_var,
                                           self._path_loss_border)

        orig_Ns = (np.ones(K, dtype=int) * int(Ns)
                   if np.ndim(Ns) == 0 else np.asarray(Ns).copy())

        self.ia_solver.clear()
        self.ia_solver.initialize_with = str(
            current_parameters["initialize_with"])
        try:
            self.ia_top_object.solve(Ns=Ns, P=pt)
        except (RuntimeError, np.linalg.LinAlgError) as exc:
            raise SkipThisOne(
                "Could not find the IA solution. Skipping this repetition"
            ) from exc

        Ns_arr = self.ia_solver.Ns
        cumNs = np.cumsum(Ns_arr)

        inputData = self.data_RS.randint(0, M, (int(np.sum(Ns_arr)), NSymbs))
        modulatedData = np.asarray(self.modulator.modulate(inputData))

        transmit_signal = np.split(modulatedData, cumNs[:-1])
        precoded = [self.ia_solver.full_F[k] @ transmit_signal[k]
                    for k in range(K)]

        received = self.multiUserChannel.corrupt_data(precoded, noise=noise)
        no_interf = [self.ia_solver.full_W_H[k] @ received[k]
                     for k in range(K)]
        demodulated = np.asarray(
            self.modulator.demodulate(np.vstack(no_interf)))

        symbolErrors = int(np.sum(inputData != demodulated))
        bitErrors = int(count_bit_errors(inputData, demodulated))
        numSymbols = inputData.size
        numBits = inputData.size * level2bits(M)
        ia_cost = float(self.ia_solver.get_cost())

        sinr_all_k = self.ia_solver.calc_SINR()
        total_sum_capacity = float(sum(
            np.sum(np.log2(1.0 + np.asarray(s))) for s in sinr_all_k))
        ia_runned_iterations = int(
            getattr(self.ia_solver, "runned_iterations", 0) or 0)

        # chosen stream configuration as a CHOICETYPE histogram index
        stream_index = int(np.ravel_multi_index(Ns_arr - 1, orig_Ns))
        num_choices = int(np.prod(orig_Ns))

        simResults = SimulationResults()
        simResults.add_result(
            Result.create("symbol_errors", Result.SUMTYPE, symbolErrors))
        simResults.add_result(
            Result.create("num_symbols", Result.SUMTYPE, numSymbols))
        simResults.add_result(
            Result.create("bit_errors", Result.SUMTYPE, bitErrors))
        simResults.add_result(
            Result.create("num_bits", Result.SUMTYPE, numBits))
        simResults.add_result(Result.create(
            "ber", Result.RATIOTYPE, bitErrors, numBits))
        simResults.add_result(Result.create(
            "ser", Result.RATIOTYPE, symbolErrors, numSymbols))
        simResults.add_result(Result.create(
            "ia_cost", Result.RATIOTYPE, ia_cost, 1))
        simResults.add_result(Result.create(
            "sum_capacity", Result.RATIOTYPE, total_sum_capacity, 1))
        simResults.add_result(Result.create(
            "ia_runned_iterations", Result.RATIOTYPE,
            ia_runned_iterations, 1))
        simResults.add_result(Result.create(
            "stream_statistics", Result.CHOICETYPE, stream_index,
            num_choices))
        return simResults

    def _keep_going(self, current_params, current_sim_results, current_rep):
        # Every 300 reps: stop once the 95% CI is narrower than a tenth of
        # the BER and at least 5000 reps ran
        if current_rep % 300 == 0 and current_rep > 0:
            ber_result = current_sim_results["ber"][-1]
            ber_value = ber_result.get_result()
            if ber_value == 0.0:
                return True
            lo, hi = ber_result.get_confidence_interval(P=95)
            if abs(hi - lo) < ber_value / 10.0 and current_rep > 5000:
                return False
        return True

    def _on_simulate_current_params_start(self, current_params):
        # fresh streams per variation so parallel workers differ
        self.multiUserChannel.re_seed()

        if str(current_params["scenario"]) == "NoPathLoss":
            self.noise_var = 1.0
        else:
            self.noise_var = dBm2Linear(float(self.params["N0"]))
        self.multiUserChannel.noise_var = self.noise_var

        self.ia_solver.max_iterations = int(current_params["max_iterations"])

        alg = str(current_params["stream_sel_method"])
        if alg == "greedy":
            self.ia_top_object = algorithms.GreedStreamIASolver(
                self.ia_solver)
        elif alg == "brute":
            self.ia_top_object = algorithms.BruteForceStreamIASolver(
                self.ia_solver)
        elif alg == "none":
            self.ia_top_object = self.ia_solver
        else:
            raise ValueError(f"Invalid stream selection method: '{alg}'")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()
    config = "greedy_config_file.txt"
    if not os.path.exists(config):
        here = os.path.dirname(os.path.abspath(__file__))
        candidate = os.path.join(here, "greedy_config_file.txt")
        config = candidate if os.path.exists(candidate) else None

    runner = IAStreamSelSimulationRunner(config, device=args.device)
    # the base name greedy_statistics.py reads
    runner.set_results_filename(
        "greedy_IA_stream_sel_results_{SNR}_{M}-{modulator}_{Nr}x{Nt}"
        "_({Ns})_MaxIter_{max_iterations}_({initialize_with})")
    simulate_do_what_i_mean(runner)

    params = runner.results.params
    methods = params["stream_sel_method"]
    caps = np.array(runner.results.get_result_values_list("sum_capacity"))
    bers = np.array(runner.results.get_result_values_list("ber"))
    for method in methods:
        idx = params.get_pack_indexes({"stream_sel_method": method})
        print(f"\n{method}:")
        print("  sum capacity: ", np.round(caps[idx], 2))
        print("  BER:          ", bers[idx])
    print("Elapsed:", runner.elapsed_time)


if __name__ == "__main__":
    main()
