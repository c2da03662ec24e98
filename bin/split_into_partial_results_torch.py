#!/usr/bin/env python
"""Explode a saved SimulationResults file back into per-variation partial
results files, on the PyTorch port.

The counterpart of ``bin/split_into_partial_results.py``, with the same
arguments. A port ``SimulationRunner`` whose results file has the same
base name resumes from these files (from its ``partial_results`` folder
beside the results file): each variation continues at the repetitions it
had run, and no repetition runs again. So the files are

* named by ``simulations.get_partial_results_filename``, the name the
  runner looks for (the variation index zero-padded to the digit count of
  the number of variations);
* saved with ``current_rep`` set to the repetitions the variation ran
  (``runned_reps``), not to a count of result updates: the per-key and
  bulk paths update a result once a chunk.

Usage: python bin/split_into_partial_results_torch.py results_file
[-o output_folder]
"""

import argparse
import os
import sys
from typing import List

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pyphysim_tpu_torch.simulations import (  # noqa: E402
    SimulationResults, get_partial_results_filename)

# the extensions SimulationResults.save_to_file writes
_EXTENSIONS = (".pickle", ".json")


def results_base_name(results_file: str) -> str:
    """The runner's results base name of a saved results file: its name
    without the folder and without the extension ``save_to_file`` adds."""
    name = os.path.basename(results_file)
    base, ext = os.path.splitext(name)
    return base if ext in _EXTENSIONS else name


def main(argv=None) -> List[str]:
    """Split the results file named in ``argv``; returns the names of the
    partial results files written."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("results_file",
                        help="The name of the SimulationResults file.")
    parser.add_argument("-o", "--output_folder", default="partial_results",
                        help="Folder for the partial results files.")
    args = parser.parse_args(argv)

    results = SimulationResults.load_from_file(args.results_file)
    unpacked = results.params.get_unpacked_params_list()
    if results.runned_reps is None or \
            len(results.runned_reps) != len(unpacked):
        raise ValueError(
            f"'{args.results_file}' records the repetitions of "
            f"{0 if results.runned_reps is None else len(results.runned_reps)}"
            f" variations, not of its {len(unpacked)}: it was not saved by "
            "a finished simulate()")
    os.makedirs(args.output_folder, exist_ok=True)
    base = results_base_name(args.results_file)

    written = []
    for i, var_params in enumerate(unpacked):
        partial = SimulationResults()
        partial.set_parameters(var_params)
        for name in results.get_result_names():
            entries = results[name]
            if i < len(entries):
                partial.append_result(entries[i])
        partial.current_rep = int(results.runned_reps[i])
        filename = get_partial_results_filename(base, var_params,
                                                args.output_folder)
        partial.save_to_file(filename)
        print(f"Saved '{filename}'")
        written.append(filename)
    return written


if __name__ == "__main__":
    main()
