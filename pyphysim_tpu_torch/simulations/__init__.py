"""Monte Carlo runtime: typed result accumulators, parameter grids with
unpack semantics, the simulation runner and its 'do what I mean'
launcher."""

from .parameters import (SimulationParameters,  # noqa: F401
                         combine_simulation_parameters)
from .results import (Result, SimulationResults,  # noqa: F401
                      combine_simulation_results)
from .runner import (SimulationRunner, SkipThisOne,  # noqa: F401
                     get_partial_results_filename, kernel_stream_seed)
from .simulationhelpers import simulate_do_what_i_mean  # noqa: F401
