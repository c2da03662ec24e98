"""'Do what I mean' simulation launcher.

Counterpart of ``pyphysim_tpu/simulations/simulationhelpers.py``: run one
runner or a list of them, honouring the ``-i/--index`` command-line
argument (one parameter variation, the cluster job-splitting mode), and
print where the results went.

The JAX package runs a list of runners concurrently in threads behind a
shared progress server, and shards one runner's batches over a device mesh
when it sees several devices. The port has neither the multi-process
progress server nor ``simulate_in_parallel`` yet (``ROADMAP.md`` queue 1
items 4 and 5), so it runs a list one runner after another, each on its
own device, with its own progress bar.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

from .runner import SimulationRunner

__all__ = ["simulate_do_what_i_mean"]


def simulate_do_what_i_mean(
        runner_or_list: Union[SimulationRunner, Sequence[SimulationRunner]],
        folder: Optional[str] = None) -> None:
    """Run a runner, or each runner of a list in turn.

    ``folder`` is accepted for call-site compatibility and ignored (the
    reference appended it to its workers' ``sys.path``)."""
    del folder
    runners = [runner_or_list] if isinstance(runner_or_list,
                                             SimulationRunner) \
        else list(runner_or_list)
    for runner in runners:
        _simulate_single(runner)


def _simulate_single(runner: SimulationRunner) -> None:
    index = runner.command_line_args.index
    if index is not None:
        runner.simulate(param_variation_index=index)
        return
    runner.simulate()
    if runner.results_base_filename is not None:
        print(f"Results saved to '{runner.results_filename}'")
