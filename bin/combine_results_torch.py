#!/usr/bin/env python
"""Combine two saved SimulationResults files over the union of their
parameter grids, on the PyTorch port.

The counterpart of ``bin/combine_results.py``: the same arguments and the
same default output name, through the port's ``SimulationResults``.

Usage: python bin/combine_results_torch.py first second [output]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pyphysim_tpu_torch.simulations import (  # noqa: E402
    SimulationResults, combine_simulation_results)
from pyphysim_tpu_torch.utils.misc import replace_dict_values  # noqa: E402


def main(argv=None) -> str:
    """Combine the two files named in ``argv``; returns the name the
    combined results were saved to."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("first",
                        help="The name of the first SimulationResults file.")
    parser.add_argument("second",
                        help="The name of the second SimulationResults file.")
    parser.add_argument("output", nargs="?",
                        help="Name for the combined results file.")
    args = parser.parse_args(argv)

    first = SimulationResults.load_from_file(args.first)
    second = SimulationResults.load_from_file(args.second)
    union = combine_simulation_results(first, second)

    if args.output is None:
        output = replace_dict_values("combined_results",
                                     union.params.parameters,
                                     filename_mode=True)
    else:
        output = args.output
    name = union.save_to_file(output)
    print(f"Combined results saved to '{name}'")
    return name


if __name__ == "__main__":
    main()
