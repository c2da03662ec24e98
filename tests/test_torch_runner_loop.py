"""The runner's one chunk loop against the two loops it replaced.

The per-key and the bulk path run through one loop (``_chunk_loop``). Each
case runs a sweep through it and through frozen copies of the per-key and
bulk loops it replaced (``torch_runner_checks.py``), and requires the same
kernel calls ``(start, n)`` in order (the speculative ones too), the same
accounts of every chunk and Results equal in value and dtype: with and
without a stop rule, with and without skipped attempts, at two chunk
sizes, on the CPU and (``cuda``-marked) on a card. The per-key path
hands its RATIOTYPE totals on as float64 rows, the bulk path as the
kernel gives them (int64 here). Imports no JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import pyphysim_tpu_torch.simulations as T  # noqa: E402
from pyphysim_tpu_torch.ops.streams import AttemptStreams  # noqa: E402
from torch_runner_checks import use_parent_loops  # noqa: E402

SNRS = np.array([0.0, 10.0, 20.0])
REP_MAX = 13          # a multiple of neither chunk size
LIMIT = 150.0         # bit errors: reached after about five attempts


def _runner(path, stop, p_skip, batch, device):
    """A runner on ``path`` whose kernel draws each attempt's bit errors
    (0-63) and ``__valid__`` mask from its attempt streams; ``calls``
    logs each kernel call as ``(point, start, n)``, ``accounts`` each
    chunk's size, missing attempts, active mask and counts."""

    class Loop(T.SimulationRunner):
        def __init__(self):
            super().__init__(read_command_line_args=False)
            self.params.add("SNR", SNRS)
            self.params.set_unpack_parameter("SNR")
            self.rep_max, self.batch_size = REP_MAX, batch
            self.batch_stop_criterion = \
                ("bit_errors", LIMIT) if stop else None
            self.num_stop_subchunks = 2
            self.update_progress_function_style = None
            self.device = device
            self.batch_result_types = {"bit_errors": T.Result.SUMTYPE,
                                       "ber": T.Result.RATIOTYPE}
            self.calls, self.accounts = [], []

        def _draw(self, point, streams):
            self.calls.append((point, int(streams.attempts[0]), streams.n))
            errors = streams.integers(64, ())
            valid = streams.split(2)[1].uniform(()) >= p_skip
            return errors, valid

        def _gen_simulation_kernel(self, current_parameters):
            point = current_parameters.unpack_index

            def kernel(streams):
                errors, valid = self._draw(point, streams)
                return {"bit_errors": errors,
                        "ber": (errors, torch.tensor(6.0, device=device)),
                        "__valid__": valid}
            return None if path == "bulk" else kernel

        def _gen_bulk_kernel(self, current_parameters):
            point = current_parameters.unpack_index
            seed = T.kernel_stream_seed(self.base_seed, point)

            def bulk(start, n):
                errors, valid = self._draw(point, AttemptStreams.from_range(
                    seed, start, n, device))
                return {"bit_errors": errors,
                        "ber": (errors, np.full(n, 6, np.int64)),
                        "__valid__": valid}
            return bulk if path == "bulk" else None

        def _consume_chunk(self, out, nk, needed, elapsed, current_results,
                           active=None):
            counts = super()._consume_chunk(out, nk, needed, elapsed,
                                            current_results, active)
            self.accounts.append((nk, needed, None if active is None
                                  else active.tolist(), counts))
            return counts

    return Loop()


def _typed(v):
    """``v`` with the type of every number in it."""
    if isinstance(v, np.ndarray):
        return v.dtype.str, v.tolist()
    if isinstance(v, (list, tuple)):
        return [_typed(x) for x in v]
    return type(v).__name__, v


def _state(runner):
    res = runner.results
    return {name: [sorted((k, _typed(v)) for k, v in vars(r).items())
                   for r in res[name]]
            for name in res.get_result_names() if name != "elapsed_time"}


def _check(path, stop, p_skip, batch, device):
    want = use_parent_loops(_runner(path, stop, p_skip, batch, device))
    want.simulate()
    got = _runner(path, stop, p_skip, batch, device)
    got.simulate()
    assert got.calls == want.calls
    assert got.accounts == want.accounts
    assert got.runned_reps == want.runned_reps
    assert _state(got) == _state(want)
    if stop:
        assert min(got.runned_reps) < REP_MAX        # the rule stopped
    if p_skip:
        assert sum(got.results.get_result_values_list(
            "num_skipped_reps")) > 0
    return got


@pytest.mark.parametrize("batch", [2, 6])
@pytest.mark.parametrize("p_skip", [0.0, 0.3])
@pytest.mark.parametrize("stop", [False, True])
@pytest.mark.parametrize("path", ["bulk", "perkey"])
def test_one_loop_makes_the_calls_and_results_of_the_two(path, stop, p_skip,
                                                         batch):
    got = _check(path, stop, p_skip, batch, "cpu")
    ber = got.results["ber"][0]
    assert type(ber._total) is (np.int64 if path == "bulk" else np.float64)
    if path == "perkey" and p_skip and not stop:
        # a speculative chunk, sized as if no attempt were skipped, was
        # discarded
        assert len(got.calls) > len(got.accounts)


@pytest.mark.cuda
@pytest.mark.parametrize("stop", [False, True])
@pytest.mark.parametrize("path", ["bulk", "perkey"])
def test_one_loop_makes_the_calls_and_results_of_the_two_on_the_card(
        path, stop):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _check(path, stop, 0.3, 6, "cuda")
