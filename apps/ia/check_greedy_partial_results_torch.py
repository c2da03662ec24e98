#!/usr/bin/env python
"""Inspect the partial-results files left by a (possibly interrupted)
simulate_greedy_ia_torch.py run, on the PyTorch port.

The counterpart of ``apps/ia/check_greedy_partial_results.py``: loads the
full results file (for the unpacked-variation count), then each
``partial_results/<base>_unpack_<i>.pickle`` and prints the unpacked
parameters it was computed for: a quick audit that every variation's
checkpoint is present and consistent before or after a resume. It reads
results on the host and launches nothing on a device.

Run: ``python apps/ia/check_greedy_partial_results_torch.py
<full_results.pickle>``.
"""

import os
import sys

sys.path.insert(0, ".")

from pyphysim_tpu_torch.simulations.results import SimulationResults


def check_partials(full_results_name: str,
                   partial_folder: str = "partial_results"):
    """Print the unpacked parameters of every partial pickle belonging to
    ``full_results_name`` (reference check_greedy_partial_results.py:5-24).
    Returns the list of loaded partial SimulationResults."""
    full_result = SimulationResults.load_from_file(full_results_name)
    num_variations = full_result.params.get_num_unpacked_variations()

    base = os.path.splitext(os.path.basename(full_results_name))[0]
    # index padded to the digit count of the variation total, exactly as
    # the runner writes them (runner.py get_partial_results_filename)
    digits = len(str(num_variations))
    name = os.path.join(partial_folder,
                        base + "_unpack_{:0>" + str(digits) + "d}.pickle")

    partials = []
    for i in range(num_variations):
        result = SimulationResults.load_from_file(name.format(i))
        params = result.params
        fields = []
        for key in ("scenario", "stream_sel_method", "initialize_with",
                    "SNR"):
            if key in params:
                fields.append(f"{key}: {params[key]!s:>10}")
        print(" | ".join(fields))
        partials.append(result)
    return partials


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__)
        sys.exit(1)
    check_partials(sys.argv[1])
