"""Monte Carlo runtime: typed result accumulators, parameter grids with
unpack semantics, and the simulation runner."""

from .parameters import (SimulationParameters,  # noqa: F401
                         combine_simulation_parameters)
from .results import (Result, SimulationResults,  # noqa: F401
                      combine_simulation_results)
from .runner import (SimulationRunner, SkipThisOne,  # noqa: F401
                     get_partial_results_filename, kernel_stream_seed)
