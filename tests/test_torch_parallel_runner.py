"""``SimulationRunner.simulate_in_parallel`` on the per-key path across a
2-rank ``gloo`` group, against the same runner's ``simulate()`` in one
process (the JAX package's ``tests/test_parallel.py`` and
``tests/test_multihost.py`` semantics):

* a QPSK / AWGN runner on attempt streams gives exactly the single-process
  Results on both ranks, with and without a stop criterion (each rank
  reads the all-gathered metric, so both stop at the same sub-chunk);
* a sweep interrupted at ``rep_max`` 8 and resumed to 16 from rank 0's
  partial-results files equals the uninterrupted run, and only rank 0
  wrote files;
* ``simulate_do_what_i_mean`` takes the parallel route at world size 2,
  for one runner and for a list (run in turn in a group, behind a
  progress server on rank 0 alone);
* without a group, a list of two runners runs concurrently behind one
  progress server.
"""

import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_parallel_checks as checks  # noqa: E402
from pyphysim_tpu_torch.parallel.launch import run_ranks  # noqa: E402

WORLD = 2


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return tmp_path_factory.mktemp("shared")


@pytest.fixture(scope="module")
def ranks(shared):
    return run_ranks(checks.runner_checks, WORLD, args=(str(shared),),
                     store_dir=str(shared))


def _single(**kwargs):
    runner = checks.QpskRunner(**kwargs)
    runner.simulate()
    return checks.summary(runner)


@pytest.mark.parametrize("key,stop", [("plain", None),
                                      ("stop", checks.STOP)])
def test_parallel_equals_single_process(ranks, key, stop):
    want = _single(stop=stop)
    for out in ranks:
        assert out[key] == want
    if stop is not None:
        assert want["runned_reps"][0] < 64      # the criterion tripped


def test_resume_across_a_restart(ranks, shared):
    want = _single(rep_max=16, batch=4)
    for out in ranks:
        assert out["resume_8"] == _single(rep_max=8, batch=4)
        assert out["resume_16"] == want
    partials = sorted(p.name for p in (shared / "partial").iterdir())
    assert partials == ["res_unpack_0.pickle", "res_unpack_1.pickle"]
    assert (shared / "res.pickle").exists()
    assert ranks[0]["saves"] > 0
    assert ranks[1]["saves"] == 0           # rank 1 never wrote a file


def test_do_what_i_mean_takes_the_parallel_route(ranks):
    want = _single()
    for out in ranks:
        summary, under_mesh = out["dwim"]
        assert under_mesh and summary == want
        assert out["dwim_list"] == [(want, True),
                                    (_single(batch=32), True)]


def test_only_rank_0_starts_a_progress_server(ranks):
    assert [out["servers"] for out in ranks] == [1, 0]


def test_list_runs_concurrently_behind_one_server():
    """Two runners whose kernels meet at a barrier: run one after the
    other, the first would wait alone and time out."""
    from pyphysim_tpu_torch.simulations import simulate_do_what_i_mean
    barrier = threading.Barrier(2, timeout=30)
    proxies = []

    class Meeting(checks.QpskRunner):
        def _gen_simulation_kernel(self, current_parameters):
            kernel = super()._gen_simulation_kernel(current_parameters)

            def meet(streams):
                if len(proxies) < 2:
                    proxies.append(self.external_progress_proxy)
                    barrier.wait()
                return kernel(streams)

            return meet

    pair = [Meeting(rep_max=8, batch=8), Meeting(rep_max=8, batch=8)]
    simulate_do_what_i_mean(pair)
    assert len(proxies) == 2 and all(p is not None for p in proxies)
    assert proxies[0] is not proxies[1]
    want = _single(rep_max=8, batch=8)
    for runner in pair:
        assert checks.summary(runner) == want
        assert runner.external_progress_proxy is None


def test_progress_server_sums_its_clients():
    from pyphysim_tpu_torch.progressbar import (
        ProgressbarMultiProcessClient, ProgressbarMultiProcessServer)
    server = ProgressbarMultiProcessServer(message="two clients")
    try:
        a = server.register_client_and_get_proxy_progressbar(10)
        b = server.register_client_and_get_proxy_progressbar(30)
        assert isinstance(a, ProgressbarMultiProcessClient)
        assert (server.num_clients, server.finalcount) == (2, 40)
        a.progress(4)
        b(25)
        assert server._get_total_count() == 29
        server.start_updater()
        assert server.is_running
        a.progress(10)
        b.progress(30)
        server._update_thread.join(timeout=10)
        assert not server.is_running     # ends at the final count
    finally:
        server.close()
