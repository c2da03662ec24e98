#!/usr/bin/env python
"""Generate the BER / sum-capacity / mean-iterations tikz plots from the
result files written by simulate_ia_torch.py, on the PyTorch port.

The counterpart of ``apps/ia/ia_results_plots.py``: loads the per-solver
result files (closed form, alt-min, max-SINR, MMSE), slices BER / sum
capacity / mean iterations run at a chosen ``max_iterations`` value,
renders pgfplots ``\\addplot`` lines, and fills the
``ber_plot_template.tikz`` / ``sum_capacity_template.tikz`` templates
(placeholders MAXITER, BER_ALL_ALGS, SUM_CAPACITY_ALL_ALGS, ITER_ALL_ALGS,
SECONDTICK, YMAX). It reads results on the host and launches nothing on a
device.

Run: ``python apps/ia/ia_results_plots_torch.py [results_dir]
[max_iterations]``.
"""

import os
import sys

sys.path.insert(0, ".")

import numpy as np

from pyphysim_tpu_torch.extra.pgfplotshelper import generate_pgfplots_plotline
from pyphysim_tpu_torch.simulations.results import SimulationResults


def get_ber_for_given_num_iter(result_obj, max_iterations):
    """BER curve at a fixed max_iterations
    (reference IA_Results_NrxNt(Ns).py:21-38)."""
    return result_obj.get_result_values_list(
        "ber", fixed_params={"max_iterations": max_iterations})


def get_sum_capacity_for_given_num_iter(result_obj, max_iterations):
    """Sum-capacity curve at a fixed max_iterations
    (reference IA_Results_NrxNt(Ns).py:41-58)."""
    return result_obj.get_result_values_list(
        "sum_capacity", fixed_params={"max_iterations": max_iterations})


def get_num_mean_ia_iterations(sim_results_object, fixed_params=None):
    """Mean number of solver iterations actually run
    (reference IA_Results_NrxNt(Ns).py:102-120)."""
    if fixed_params is None:
        fixed_params = {}
    return sim_results_object.get_result_values_list("ia_runned_iterations",
                                                     fixed_params)


def get_mean_iterations(result_obj, max_iterations):
    """(reference IA_Results_NrxNt(Ns).py:61-77)"""
    return get_num_mean_ia_iterations(
        result_obj, {"max_iterations": max_iterations})


def get_num_runned_reps(sim_results_object, fixed_params=None):
    """Repetitions run for each variation matching fixed_params
    (reference IA_Results_NrxNt(Ns).py:80-99)."""
    if fixed_params is None:
        fixed_params = {}
    all_runned_reps = np.array(sim_results_object.runned_reps)
    indexes = sim_results_object.params.get_pack_indexes(fixed_params)
    return all_runned_reps[indexes]


def _load(results_dir, name):
    path = os.path.join(results_dir, name)
    return SimulationResults.load_from_file(path)


def make_plots(results_dir=".", max_iterations=60, templates_dir=None,
               out_dir=None, base_name=None, base_name_no_iter=None,
               init_suffix="_['random']"):
    """Load the four solver result files and write the two tikz plots
    (reference IA_Results_NrxNt(Ns).py:123-415). ``base_name`` names the
    iterative solvers' files (with the MaxIter range); the max-SINR and
    MMSE files additionally carry the ``initialize_with`` suffix
    (simulate_ia.py result naming). Returns the two output filenames."""
    if templates_dir is None:
        templates_dir = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "..")
    if out_dir is None:
        out_dir = results_dir

    if base_name is None or base_name_no_iter is None:
        raise ValueError("provide base_name and base_name_no_iter, e.g. "
                         "'4-PSK_2x2_(1)_MaxIter_[5_(5)_60]'")

    alt_min = _load(results_dir, f"ia_alt_min_results_{base_name}.pickle")
    closed_form = _load(
        results_dir, f"ia_closed_form_results_{base_name_no_iter}.pickle")
    max_sinr = _load(
        results_dir, f"ia_max_sinr_results_{base_name}{init_suffix}.pickle")
    mmse = _load(
        results_dir, f"ia_mmse_results_{base_name}{init_suffix}.pickle")

    SNR_alt_min = np.array(alt_min.params["SNR"])
    SNR_closed_form = np.array(closed_form.params["SNR"])
    SNR_max_sinr = np.array(max_sinr.params["SNR"])
    SNR_mmse = np.array(mmse.params["SNR"])

    it = int(max_iterations)
    ber_closed_form = closed_form.get_result_values_list("ber")
    ber_alt_min = get_ber_for_given_num_iter(alt_min, it)
    ber_max_sinr = get_ber_for_given_num_iter(max_sinr, it)
    ber_mmse = get_ber_for_given_num_iter(mmse, it)

    cap_closed_form = closed_form.get_result_values_list("sum_capacity")
    cap_alt_min = get_sum_capacity_for_given_num_iter(alt_min, it)
    cap_max_sinr = get_sum_capacity_for_given_num_iter(max_sinr, it)
    cap_mmse = get_sum_capacity_for_given_num_iter(mmse, it)

    iter_alt_min = get_mean_iterations(alt_min, it)
    iter_max_sinr = get_mean_iterations(max_sinr, it)
    iter_mmse = get_mean_iterations(mmse, it)

    ITER_ALL_ALGS = "\n\n".join([
        generate_pgfplots_plotline(SNR_alt_min, iter_alt_min,
                                   options="alt min iter style"),
        generate_pgfplots_plotline(SNR_max_sinr, iter_max_sinr,
                                   options="max sinr iter style"),
        generate_pgfplots_plotline(SNR_mmse, iter_mmse,
                                   options="mmse iter style"),
    ])

    BER_ALL_ALGS = "\n\n".join([
        generate_pgfplots_plotline(SNR_closed_form, ber_closed_form,
                                   options="closed form style",
                                   legend="Closed-Form"),
        generate_pgfplots_plotline(SNR_alt_min, ber_alt_min,
                                   options="alt min style",
                                   legend="Alt. Min."),
        generate_pgfplots_plotline(SNR_max_sinr, ber_max_sinr,
                                   options="max sinr style",
                                   legend="Max SINR"),
        generate_pgfplots_plotline(SNR_mmse, ber_mmse,
                                   options="mmse style", legend="MMSE"),
    ])

    SUM_CAPACITY_ALL_ALGS = "\n\n".join([
        generate_pgfplots_plotline(SNR_closed_form, cap_closed_form,
                                   options="closed form style",
                                   legend="Closed-Form"),
        generate_pgfplots_plotline(SNR_alt_min, cap_alt_min,
                                   options="alt min style",
                                   legend="Alt. Min."),
        generate_pgfplots_plotline(SNR_max_sinr, cap_max_sinr,
                                   options="max sinr style",
                                   legend="Max SINR"),
        generate_pgfplots_plotline(SNR_mmse, cap_mmse,
                                   options="mmse style", legend="MMSE"),
    ])

    second_tick = str((it // 10) + 1)

    with open(os.path.join(templates_dir, "ber_plot_template.tikz")) as fid:
        ber_template = fid.read()
    with open(os.path.join(templates_dir,
                           "sum_capacity_template.tikz")) as fid:
        cap_template = fid.read()

    ber_name = os.path.join(out_dir,
                            f"ber_all_ia_algs_max_iter_{it}.tikz")
    cap_name = os.path.join(out_dir,
                            f"sum_capacity_all_ia_algs_max_iter_{it}.tikz")

    with open(ber_name, "w") as fid:
        fid.write(ber_template
                  .replace("MAXITER", str(it))
                  .replace("BER_ALL_ALGS", BER_ALL_ALGS)
                  .replace("ITER_ALL_ALGS", ITER_ALL_ALGS)
                  .replace("SECONDTICK", second_tick))
    with open(cap_name, "w") as fid:
        fid.write(cap_template
                  .replace("MAXITER", str(it))
                  .replace("SUM_CAPACITY_ALL_ALGS", SUM_CAPACITY_ALL_ALGS)
                  .replace("ITER_ALL_ALGS", ITER_ALL_ALGS)
                  .replace("SECONDTICK", second_tick)
                  .replace("YMAX", "60"))
    return ber_name, cap_name


if __name__ == "__main__":
    results_dir = sys.argv[1] if len(sys.argv) > 1 else "."
    max_iter = int(sys.argv[2]) if len(sys.argv) > 2 else 60
    # default scenario naming from ia_config_file.txt defaults
    make_plots(results_dir, max_iter,
               base_name="4-PSK_2x2_(1)_MaxIter_[5_(5)_60]_random",
               base_name_no_iter="4-PSK_2x2_(1)")
