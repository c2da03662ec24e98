"""The runner's one chunk loop against the two loops it replaced.

The per-key and the bulk path run through one loop (``_chunk_loop``). Each
case runs a sweep through it and through frozen copies of the per-key and
bulk loops it replaced (``torch_runner_checks.py``), and requires the same
kernel calls ``(start, n)`` in order (the speculative ones too), the same
accounts of every chunk and Results equal in value and dtype: with and
without a stop rule, with and without skipped attempts, at two chunk
sizes, on the CPU and (``cuda``-marked) on a card. The per-key path
hands its RATIOTYPE totals on as float64 rows, the bulk path as the
kernel gives them (int64 here).

Under a stop rule the loop gates on its own running counts and books chunk
k after it has dispatched chunk k + 1 (a runner that overrides
``_keep_going`` keeps the order of book, then gate); the cases below log
the order, the stop metric each dispatch is given, and hold the bulk
path's calls to the benchmark's replay of the rules. Imports no JAX."""

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


def _runner(path, stop, p_skip, batch, device, keep_going=False):
    """A runner on ``path`` whose kernel draws each attempt's bit errors
    (0-63) and ``__valid__`` mask from its attempt streams; ``calls``
    logs each kernel call as ``(point, start, n)``, ``counts`` its bit
    errors, ``accounts`` each chunk's size, missing attempts, active mask
    and counts, and ``log`` each point's start, each chunk's dispatch
    with the stop metric it is given, each kernel call, and each chunk's
    bookkeeping with the stop metric of the Results after it.
    ``keep_going``: the runner overrides ``_keep_going`` (to return what
    the base hook returns)."""

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
            self.counts, self.log = [], []

        def _draw(self, point, streams):
            self.calls.append((point, int(streams.attempts[0]), streams.n))
            self.log.append(("call", int(streams.attempts[0])))
            errors = streams.integers(64, ())
            valid = streams.split(2)[1].uniform(()) >= p_skip
            self.counts.append(errors.cpu().numpy())
            return errors, valid

        def _on_simulate_current_params_start(self, current_params):
            self.log.append(("point", current_params.unpack_index))

        def _logged(self, chunks):
            dispatch, chunk_size = chunks

            def logged(cursor, nk, metric):
                self.log.append(("dispatch", cursor, nk, metric))
                return dispatch(cursor, nk, metric)
            return logged, chunk_size

        def _bulk_chunks(self, bulk):
            return self._logged(super()._bulk_chunks(bulk))

        def _perkey_chunks(self, kernel, current_params):
            return self._logged(super()._perkey_chunks(kernel,
                                                       current_params))

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
            self.log.append(("book", counts[1],
                             self._stop_metric_value(current_results)
                             if stop else None))
            return counts

    class Gated(Loop):
        def _keep_going(self, current_params, current_sim_results,
                        current_rep):
            return super()._keep_going(current_params, current_sim_results,
                                       current_rep)

    return Gated() if keep_going else Loop()


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


def _points(log):
    """``log`` cut into one list of events a point."""
    points = []
    for event in log:
        if event[0] == "point":
            points.append([])
        else:
            points[-1].append(event)
    return points


def _check_order(path, p_skip, batch, device, keep_going):
    r = _runner(path, True, p_skip, batch, device, keep_going)
    r.simulate()
    for point, events in enumerate(_points(r.log)):
        dispatches = [e for e in events if e[0] == "dispatch"]
        books = [e for e in events if e[0] == "book"]
        m = len(books)
        assert len(dispatches) == m >= 1
        # chunk k + 1 is dispatched before chunk k is booked, except at
        # a point's last chunk; a runner with its own _keep_going books
        # each chunk before the next is gated and dispatched
        if keep_going:
            order = [x for k in range(m) for x in (("d", k), ("b", k))]
        else:
            order = [("d", 0)] + [x for k in range(1, m)
                                  for x in (("d", k), ("b", k - 1))] + \
                [("b", m - 1)]
        seen = {"dispatch": 0, "book": 0}
        got = []
        for e in events:
            if e[0] in seen:
                got.append((e[0][0], seen[e[0]]))
                seen[e[0]] += 1
        assert got == order
        if not keep_going:
            # between chunk k + 1's dispatch and chunk k's bookkeeping the
            # loop makes one call: the next chunk's first (sub-)chunk
            at = {kind: [i for i, e in enumerate(events) if e[0] == kind]
                  for kind in ("dispatch", "book")}
            for k in range(1, m):
                assert events[at["dispatch"][k] + 1:at["book"][k - 1]] == \
                    [("call", dispatches[k][1])]
        # the stop metric the loop gates chunk k + 1 on is the Results'
        # once chunk k is booked; the point's last gate closed the loop
        assert dispatches[0][3] == 0.0
        assert [d[3] for d in dispatches[1:]] == [b[2] for b in books[:-1]]
        assert all(type(d[3]) is float for d in dispatches)
        assert books[-1][2] >= LIMIT or r.runned_reps[point] == REP_MAX
        # each chunk starts where the chunks booked before it ended
        assert [d[1] for d in dispatches] == \
            list(np.cumsum([0] + [b[1] for b in books[:-1]]))
    return r


@pytest.mark.parametrize("keep_going", [False, True])
@pytest.mark.parametrize("batch", [2, 6])
@pytest.mark.parametrize("p_skip", [0.0, 0.3])
@pytest.mark.parametrize("path", ["bulk", "perkey"])
def test_a_chunk_is_booked_after_the_next_dispatch(path, p_skip, batch,
                                                   keep_going):
    got = _check_order(path, p_skip, batch, "cpu", keep_going)
    want = _runner(path, True, p_skip, batch, "cpu", not keep_going)
    want.simulate()
    assert got.calls == want.calls
    assert _state(got) == _state(want)


@pytest.mark.cuda
@pytest.mark.parametrize("keep_going", [False, True])
@pytest.mark.parametrize("path", ["bulk", "perkey"])
def test_a_chunk_is_booked_after_the_next_dispatch_on_the_card(path,
                                                               keep_going):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _check_order(path, 0.3, 6, "cuda", keep_going)


def _check_replay(stop, batch, device):
    from perfbench.reference import engine
    r = _runner("bulk", stop, 0.0, batch, device)
    r.simulate()
    bit_errors = r.results.get_result_values_list("bit_errors")
    for point, reps in enumerate(r.runned_reps):
        calls = [(start, n, counts) for (p, start, n), counts
                 in zip(r.calls, r.counts) if p == point]
        replay = engine.replay_bulk(calls, REP_MAX, batch,
                                    LIMIT if stop else None,
                                    r.num_stop_subchunks)
        assert replay["ok"], replay["why"]
        assert replay["calls"] == [c[:2] for c in calls]
        assert replay["reps"] == reps
        assert replay["bit_errors"] == bit_errors[point]


@pytest.mark.parametrize("batch", [2, 6])
@pytest.mark.parametrize("stop", [False, True])
def test_the_bulk_calls_are_those_of_the_rules(stop, batch):
    """With no skipped attempt, the benchmark's replay of the runner's
    rules makes the bulk path's calls, reps and bit errors."""
    _check_replay(stop, batch, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("stop", [False, True])
def test_the_bulk_calls_are_those_of_the_rules_on_the_card(stop):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _check_replay(stop, 6, "cuda")
