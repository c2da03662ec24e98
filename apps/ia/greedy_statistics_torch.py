#!/usr/bin/env python
"""Read result files created by simulate_greedy_ia_torch.py and print a
table with the stream-selection statistics, on the PyTorch port.

The counterpart of ``apps/ia/greedy_statistics.py``: loads the results
file named from ``greedy_config_file.txt``, slices the CHOICETYPE
``stream_statistics`` result per (stream_sel_method, scenario) and prints,
for every SNR, the percentage of repetitions that picked each stream-count
combination. It reads results on the host and launches nothing on a
device.

Run: ``python apps/ia/greedy_statistics_torch.py [results_file.pickle]``.
"""

import itertools
import os
import sys

sys.path.insert(0, ".")

import numpy as np

from pyphysim_tpu_torch.simulations.parameters import SimulationParameters
from pyphysim_tpu_torch.simulations.results import SimulationResults
from pyphysim_tpu_torch.utils import misc

# Same spec as simulate_greedy_ia (reference greedy_statistics.py:25-47).
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


def get_result_from_file(config_file: str = "greedy_config_file.txt"):
    """Load the SimulationResults whose filename is derived from the
    config file (reference greedy_statistics.py:18-62)."""
    params = SimulationParameters.load_from_config_file(config_file, SPEC)
    base_name = ("greedy_IA_stream_sel_results_{SNR}_{M}-{modulator}"
                 "_{Nr}x{Nt}_({Ns})_MaxIter_{max_iterations}"
                 "_({initialize_with})")
    base_name = misc.replace_dict_values(base_name, params.parameters, True)
    return SimulationResults.load_from_file(f"{base_name}.pickle")


def get_pretty_statistic_table(statistics, Ns=None, multiply=100):
    """Pair each stream-count combination with its (percentage) statistic
    (reference greedy_statistics.py:65-91).

    Parameters
    ----------
    statistics : 1D array
        CHOICETYPE fractions, one per combination (row-major over Ns).
    Ns : sequence of int, optional
        Maximum streams per user; defaults to [3, 3, 3].
    multiply : number
        Scale factor (100 -> percentages; pass the rep count for counts).
    """
    if Ns is None:
        Ns = [3, 3, 3]
    all_combinations = itertools.product(
        *(range(1, int(n) + 1) for n in Ns))
    return list(zip(all_combinations,
                    np.round(np.asarray(statistics) * multiply, 2)))


def print_statistics_table(statistic_table):
    """Print non-zero rows of the table
    (reference greedy_statistics.py:94-105)."""
    for combo, value in statistic_table:
        if value != 0:
            print(f"{combo}: {value}%")


def print_all(results, Ns=None):
    """Print the per-SNR statistics tables for every stream-selection
    method and scenario present in the results."""
    params = results.params
    SNR = np.atleast_1d(params["SNR"])
    methods = np.atleast_1d(params["stream_sel_method"])
    scenarios = np.atleast_1d(params["scenario"])
    if Ns is None:
        K = int(params["num_cells"]) if "num_cells" in params else 3
        ns_param = params["Ns"] if "Ns" in params else 3
        Ns = (np.ones(K, dtype=int) * int(ns_param)
              if np.ndim(ns_param) == 0 else np.asarray(ns_param))

    for method in methods:
        for scenario in scenarios:
            print("x" * 65)
            print(f"xxxxx {method} / {scenario} ".ljust(64, "x") + "x")
            print("x" * 65)
            stats = results.get_result_values_list(
                "stream_statistics",
                fixed_params={"stream_sel_method": str(method),
                              "scenario": str(scenario)})
            for idx, snr in enumerate(SNR):
                print(f"SNR: {snr}")
                print_statistics_table(
                    get_pretty_statistic_table(stats[idx], Ns))
                print()


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1].endswith(".pickle"):
        results = SimulationResults.load_from_file(sys.argv[1])
    else:
        config = sys.argv[1] if len(sys.argv) > 1 else (
            "greedy_config_file.txt"
            if os.path.exists("greedy_config_file.txt") else
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "greedy_config_file.txt"))
        results = get_result_from_file(config)
    print_all(results)
