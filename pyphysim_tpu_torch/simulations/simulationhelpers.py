"""'Do what I mean' simulation launcher.

Counterpart of ``pyphysim_tpu/simulations/simulationhelpers.py``: run one
runner or a list of them, honouring the ``-i/--index`` command-line
argument (one parameter variation, the cluster job-splitting mode), and
print where the results went.

Mode selection: where the JAX package shards a sweep when it sees several
devices, the port shards it when the process runs in a
``torch.distributed`` group of more than one rank (each rank one device):
``simulate_in_parallel`` then splits every chunk over the group. A list
of runners runs concurrently on threads behind one shared progress server;
in a group of several ranks it runs one runner after another instead,
because the ranks must issue their collectives in the same order, and
only rank 0 starts the server and draws its bar.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Union

from .runner import SimulationRunner

__all__ = ["simulate_do_what_i_mean"]


def _group_size() -> int:
    """The world size of the initialised process group, else 1."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _group_rank() -> int:
    """This process's rank in the initialised process group, else 0."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def simulate_do_what_i_mean(
        runner_or_list: Union[SimulationRunner, Sequence[SimulationRunner]],
        folder: Optional[str] = None) -> None:
    """Run a runner, or a list of runners sharing one progress server.

    ``folder`` is accepted for call-site compatibility and ignored (the
    reference appended it to its workers' ``sys.path``)."""
    del folder
    if isinstance(runner_or_list, SimulationRunner):
        _simulate_single(runner_or_list)
    else:
        _simulate_multiple(list(runner_or_list))


def _simulate_multiple(runners: List[SimulationRunner]) -> None:
    """Run ``runners`` with one shared progress server: concurrently on
    threads (their device work overlaps; every future's error is
    re-raised), or in turn in a group of several ranks, where rank 0
    alone runs the server and the other ranks report to no bar."""
    from ..progressbar import DummyProgressbar, ProgressbarMultiProcessServer

    server = None
    if _group_rank() == 0:
        server = ProgressbarMultiProcessServer(
            message="Simulating all runners")
    for runner in runners:
        num_vars = runner.params.get_num_unpacked_variations()
        if runner.command_line_args.index is not None:
            num_vars = 1
        runner.external_progress_proxy = DummyProgressbar() \
            if server is None else \
            server.register_client_and_get_proxy_progressbar(
                runner.rep_max * num_vars)

    if server is not None:
        server.start_updater()
    try:
        if _group_size() > 1:
            for runner in runners:
                _simulate_single(runner)
        else:
            with ThreadPoolExecutor(max_workers=len(runners)) as pool:
                futures = [pool.submit(_simulate_single, r)
                           for r in runners]
                for future in futures:
                    future.result()
    finally:
        if server is not None:
            server.close()
        for runner in runners:
            runner.external_progress_proxy = None


def _simulate_single(runner: SimulationRunner) -> None:
    index = runner.command_line_args.index
    if index is not None:
        runner.simulate(param_variation_index=index)
        return
    if _group_size() > 1:
        runner.simulate_in_parallel()
    else:
        runner.simulate()
    if runner.results_base_filename is not None:
        print(f"Results saved to '{runner.results_filename}'")
