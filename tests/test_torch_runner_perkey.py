"""The port's per-key runner path (``_gen_simulation_kernel``) and its
per-attempt random streams (``ops/streams.py``).

* A constant-output kernel gives the JAX runner and the port's identical
  ``runned_reps`` and Results, with and without ``batch_stop_criterion``
  and ``num_stop_subchunks`` (exact: no float math differs).
* The attempt streams are chunk-size invariant: attempt ``a`` draws the
  same numbers in any chunk, so Results do not depend on the batch size.
* ``__valid__`` skip-and-retry keeps the first ``rep_max`` valid attempts.
* A sweep resumed from its partial-results files equals an uninterrupted
  one.
* Under a stop rule the executor fetches each distinct device tensor of a
  sub-chunk once and dispatches the next sub-chunk before it builds this
  one's host outputs, with the calls, accepted attempts and Results of the
  sequential order (``torch_runner_checks.py``) and of the benchmark's
  replay of the rules.
* ``randn_c`` and ``random_symbols`` draw from an explicit source.
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import pyphysim_tpu.simulations as J  # noqa: E402
import pyphysim_tpu_torch.simulations as T  # noqa: E402
from pyphysim_tpu_torch.ops.streams import AttemptStreams  # noqa: E402
from pyphysim_tpu_torch.utils.misc import randn_c, random_symbols  # noqa: E402

SNRS = np.array([0.0, 10.0, 20.0])
ERRORS, TOTAL = 3, 100.0


def _constant_runner(pkg, rep_max, batch, stop, n_sub):
    """A per-key runner of ``pkg`` whose kernel gives ``ERRORS`` bit
    errors for every attempt."""

    class PerKey(pkg.SimulationRunner):
        def __init__(self):
            super().__init__(read_command_line_args=False)
            self.params.add("SNR", SNRS)
            self.params.set_unpack_parameter("SNR")
            self.rep_max, self.batch_size = rep_max, batch
            self.batch_stop_criterion = stop
            self.num_stop_subchunks = n_sub
            self.update_progress_function_style = None
            self.device = "cpu"
            self.batch_result_types = {"bit_errors": pkg.Result.SUMTYPE,
                                       "ber": pkg.Result.RATIOTYPE}

        def _gen_simulation_kernel(self, current_parameters):
            if pkg is J:
                def kernel(key):
                    e = jnp.int32(ERRORS)
                    return {"bit_errors": e, "ber": (e, jnp.float32(TOTAL))}
            else:
                def kernel(streams):
                    e = torch.full((streams.n,), ERRORS)
                    return {"bit_errors": e, "ber": (e, TOTAL)}
            return kernel

    return PerKey()


def _summary(runner):
    res = runner.results
    return {
        "bit_errors": [int(v) for v in
                       res.get_result_values_list("bit_errors")],
        "ber": [float(v) for v in res.get_result_values_list("ber")],
        "num_skipped_reps": [int(v) for v in
                             res.get_result_values_list("num_skipped_reps")],
        "runned_reps": list(runner.runned_reps),
    }


@pytest.mark.parametrize("rep_max,batch,stop,n_sub", [
    (20, 4, None, 8),
    (20, 7, None, 8),
    (40, 8, ("bit_errors", 50.0), 2),
    (40, 8, ("bit_errors", 50.0), 4),
    (40, 16, ("bit_errors", 100.0), 8),
])
def test_constant_kernel_equals_jax(rep_max, batch, stop, n_sub):
    out = []
    for pkg in (J, T):
        r = _constant_runner(pkg, rep_max, batch, stop, n_sub)
        r.simulate()
        out.append(_summary(r))
    assert out[1] == out[0]
    if stop is not None:
        assert max(out[1]["runned_reps"]) < rep_max   # stopped early


def _streams_runner(rep_max=12, batch=4, p_skip=0.0):
    """A per-key runner whose outputs come from the attempt streams:
    ``errors`` uniform in [0, 400), ``attempt`` the absolute attempt
    index, ``__valid__`` drawn with probability ``1 - p_skip``."""

    class Streams(T.SimulationRunner):
        def __init__(self):
            super().__init__(read_command_line_args=False)
            self.params.add("SNR", SNRS)
            self.params.set_unpack_parameter("SNR")
            self.rep_max, self.batch_size = rep_max, batch
            self.update_progress_function_style = None
            self.device = "cpu"
            self.batch_result_types = {"bit_errors": T.Result.SUMTYPE,
                                       "attempt": T.Result.SUMTYPE}
            self.calls = []

        def _gen_simulation_kernel(self, current_parameters):
            def kernel(streams):
                self.calls.append((int(streams.attempts[0]), streams.n))
                return {"bit_errors": streams.integers(512, ()) % 400,
                        "attempt": streams.attempts,
                        "__valid__": _valid(streams, p_skip)}
            return kernel

    return Streams()


def _valid(streams, p_skip):
    return streams.split(2)[1].uniform(()) >= p_skip


def test_streams_are_chunk_size_invariant():
    whole = AttemptStreams.from_range(77, 3, 10, "cpu")
    parts = [AttemptStreams.from_range(77, 3, 4, "cpu"),
             AttemptStreams.from_range(77, 7, 6, "cpu")]
    for draw in (lambda s: s.bits((3,)), lambda s: s.uniform((2, 5)),
                 lambda s: s.normal((7,)), lambda s: s.integers(16, (4,)),
                 lambda s: s.split(3)[2].normal(4)):
        a = draw(whole)
        assert a.shape[0] == 10
        assert torch.equal(a, torch.cat([draw(p) for p in parts]))
    # slices of a chunk are the same attempts' streams
    assert torch.equal(whole[2:5].uniform(3), whole.uniform(3)[2:5])
    # other seeds, salts and attempts give other numbers
    assert not torch.equal(whole.bits(4),
                           AttemptStreams.from_range(78, 3, 10, "cpu")
                           .bits(4))
    s0, s1 = whole.split(2)
    assert not torch.equal(s0.bits(4), s1.bits(4))
    assert not torch.equal(whole.bits(4)[1:], whole.bits(4)[:-1])
    with pytest.raises(ValueError, match="power of two"):
        whole.integers(10, 3)


def test_stream_moments():
    s = AttemptStreams.from_range(5, 0, 1000, "cpu")
    u = s.uniform(100)
    z = s.normal(100)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 5 * np.sqrt(1 / 12 / u.numel())
    assert abs(float(z.mean())) < 5 / np.sqrt(z.numel())
    assert abs(float(z.var()) - 1.0) < 5 * np.sqrt(2 / z.numel())


@pytest.mark.parametrize("p_skip", [0.0, 0.3])
def test_results_do_not_depend_on_the_chunk_size(p_skip):
    a, b = _streams_runner(batch=3, p_skip=p_skip), \
        _streams_runner(batch=7, p_skip=p_skip)
    a.simulate()
    b.simulate()
    assert _summary_streams(a) == _summary_streams(b)


def _summary_streams(runner):
    res = runner.results
    return {name: [int(v) for v in res.get_result_values_list(name)]
            for name in ("bit_errors", "attempt", "num_skipped_reps")}


def test_skip_and_retry_keeps_the_first_valid_attempts():
    p_skip, rep_max = 0.3, 12
    r = _streams_runner(rep_max=rep_max, batch=5, p_skip=p_skip)
    r.simulate()
    summary = _summary_streams(r)
    for i in range(len(SNRS)):
        seed = T.kernel_stream_seed(r.base_seed, i)
        streams = AttemptStreams.from_range(seed, 0, 200, "cpu")
        valid = np.flatnonzero(_valid(streams, p_skip).numpy())
        first = valid[:rep_max]
        assert summary["attempt"][i] == int(first.sum())
        assert summary["num_skipped_reps"][i] == int(first[-1]) + 1 - rep_max
    assert sum(summary["num_skipped_reps"]) > 0
    assert r.runned_reps == [rep_max] * len(SNRS)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    first = _streams_runner(rep_max=6, batch=4, p_skip=0.3)
    first.set_results_filename(str(tmp_path / "res_{SNR}"))
    first.simulate()
    assert len(list((tmp_path / "partial_results").iterdir())) == len(SNRS)
    resumed = _streams_runner(rep_max=12, batch=4, p_skip=0.3)
    resumed.set_results_filename(str(tmp_path / "res_{SNR}"))
    resumed.simulate()
    straight = _streams_runner(rep_max=12, batch=4, p_skip=0.3)
    straight.simulate()
    assert _summary_streams(resumed) == _summary_streams(straight)
    # the resumed sweep only simulated attempts the first one had not
    assert min(start for start, _ in resumed.calls) >= 6


def test_speculative_chunk_is_dispatched_ahead():
    """Without a stop criterion the loop dispatches chunk k + 1 before it
    accounts chunk k (double buffering); with no skips every dispatched
    chunk is used, in order."""
    r = _streams_runner(rep_max=12, batch=4)
    r.params.add("SNR", SNRS[:1])
    events = []
    consume = r._consume_chunk

    def logged(out, nk, *args, **kwargs):
        events.append(("consume", nk))
        return consume(out, nk, *args, **kwargs)

    r._consume_chunk = logged
    kernel_of = r._gen_simulation_kernel

    def logging_kernel(params):
        kernel = kernel_of(params)

        def run(streams):
            events.append(("dispatch", int(streams.attempts[0])))
            return kernel(streams)
        return run

    r._gen_simulation_kernel = logging_kernel
    r.simulate()
    assert events == [("dispatch", 0), ("dispatch", 4), ("consume", 4),
                      ("dispatch", 8), ("consume", 4), ("consume", 4)]


class _OnCard:
    """A CPU tensor that the executor takes for a CUDA one: it fetches it
    through ``_HostCopy`` (stubbed by the tests), and ``.detach()`` hands
    the tensor to the sequential order's ``.cpu()``."""

    is_cuda = True

    def __init__(self, tensor):
        self.tensor = tensor

    def detach(self):
        return self.tensor


def _gate_runner(limit, n_sub, p_skip, on_card):
    """A per-key runner under a stop rule whose kernel returns one tensor
    of errors under three names (``bit_errors``, ``ber``'s values,
    ``errors``), a tensor total and a ``__valid__`` mask; ``calls`` logs
    each call's point, attempts and counts, ``events`` each chunk and each
    dispatch, ``accounts`` each chunk's accepted, consumed and skipped
    attempts."""

    class Gate(T.SimulationRunner):
        def __init__(self):
            super().__init__(read_command_line_args=False)
            self.params.add("SNR", SNRS)
            self.params.set_unpack_parameter("SNR")
            self.rep_max, self.batch_size = 64, 16
            self.batch_stop_criterion = ("bit_errors", limit)
            self.num_stop_subchunks = n_sub
            self.update_progress_function_style = None
            self.device = "cpu"
            self.batch_result_types = {"bit_errors": T.Result.SUMTYPE,
                                       "ber": T.Result.RATIOTYPE,
                                       "errors": T.Result.SUMTYPE}
            self.calls, self.events, self.accounts = [], [], []

        def _gen_simulation_kernel(self, current_parameters):
            point = current_parameters.unpack_index
            wrap = _OnCard if on_card else (lambda t: t)

            def kernel(streams):
                start = int(streams.attempts[0])
                self.events.append(("dispatch", start))
                e = streams.integers(64, ())
                self.calls.append((point, start, streams.n, e.numpy()))
                errors = wrap(e)
                return {"bit_errors": errors,
                        "ber": (errors, wrap(torch.tensor(6.0))),
                        "errors": errors,
                        "__valid__": wrap(_valid(streams, p_skip))}
            return kernel

        def _make_chunk_executor(self, kernel, seed, device):
            executor = super()._make_chunk_executor(kernel, seed, device)

            def logged(cursor, nk, prior_metric):
                self.events.append(("chunk", nk))
                return executor(cursor, nk, prior_metric)
            return logged

        def _consume_chunk(self, out, nk, *args, **kwargs):
            counts = super()._consume_chunk(out, nk, *args, **kwargs)
            self.accounts.append(counts)
            return counts

    return Gate()


def _gate_summary(runner):
    res = runner.results
    return {name: [float(v) for v in res.get_result_values_list(name)]
            for name in ("bit_errors", "ber", "errors",
                         "num_skipped_reps")} | {
        "runned_reps": list(runner.runned_reps),
        "accounts": runner.accounts,
        "calls": [c[:3] for c in runner.calls]}


class _Done:
    @staticmethod
    def synchronize():
        pass


def _stub_fetches(monkeypatch, runner):
    """Log each host copy the executor queues (``("fetch",)``) and each
    host-output build (``("book", rows)``) into ``runner.events``, and a
    weak reference to each copy into ``runner.copies``."""
    import pyphysim_tpu_torch.simulations.runner as R
    runner.copies = []

    class Copy:
        def __init__(self, value):
            runner.events.append(("fetch",))
            runner.copies.append(weakref.ref(self))
            self.host = value.tensor
            self.done = _Done

    book = R._host_outputs

    def logged_book(out, n):
        runner.events.append(("book", n))
        return book(out, n)

    monkeypatch.setattr(R, "_HostCopy", Copy)
    monkeypatch.setattr(R, "_host_outputs", logged_book)


GATES = [(limit, n_sub) for limit in (300.0, 1200.0, 1e9)
         for n_sub in (1, 2, 4)]


@pytest.mark.parametrize("on_card", [True, False])
@pytest.mark.parametrize("p_skip", [0.0, 0.3])
@pytest.mark.parametrize("limit,n_sub", GATES)
def test_gated_subchunks_make_the_sequential_calls(monkeypatch, limit, n_sub,
                                                   p_skip, on_card):
    """The executor that gates each sub-chunk on one fetch and dispatches
    the next before its bookkeeping makes the calls, accepts the attempts
    and keeps the Results of the sequential order; with no skipped
    attempt, the calls and counts the benchmark's replay of the rules
    gives."""
    from perfbench.reference import engine
    from torch_runner_checks import use_sequential_executor

    want = use_sequential_executor(_gate_runner(limit, n_sub, p_skip,
                                                on_card))
    want.simulate()
    got = _gate_runner(limit, n_sub, p_skip, on_card)
    _stub_fetches(monkeypatch, got)
    got.simulate()
    assert _gate_summary(got) == _gate_summary(want)
    for g, w in zip(got.calls, want.calls):
        np.testing.assert_array_equal(g[3], w[3])
    if limit < 1e9:
        assert min(got.runned_reps) < got.rep_max     # the rule stopped
    if p_skip == 0.0:
        for point, reps in enumerate(got.runned_reps):
            calls = [c[1:] for c in got.calls if c[0] == point]
            replay = engine.replay_perkey(calls, got.rep_max,
                                          got.batch_size, limit, n_sub)
            assert replay["ok"], replay["why"]
            assert replay["calls"] == [c[:2] for c in calls]
            assert replay["reps"] == reps
            assert replay["bit_errors"] == \
                got.results.get_result_values_list("bit_errors")[point]


@pytest.mark.parametrize("on_card", [True, False])
@pytest.mark.parametrize("limit,n_sub", GATES)
def test_next_subchunk_is_dispatched_before_the_bookkeeping(
        monkeypatch, limit, n_sub, on_card):
    """Each sub-chunk queues one host copy a distinct device tensor (the
    errors, the total, the mask: 3 for 5 outputs; none for CPU tensors),
    and sub-chunk k + 1 is dispatched before sub-chunk k's host outputs
    are built; a chunk's last sub-chunk is built after its wait, and the
    loop builds nothing more of the chunk."""
    r = _gate_runner(limit, n_sub, 0.3, on_card)
    _stub_fetches(monkeypatch, r)
    r.simulate()
    fetches = [("fetch",)] * (3 if on_card else 0)
    starts = [i for i, e in enumerate(r.events) if e[0] == "chunk"]
    want = []
    for a, b in zip(starts, starts[1:] + [len(r.events)]):
        nk = r.events[a][1]
        dispatches = [e for e in r.events[a:b] if e[0] == "dispatch"]
        want += [r.events[a], dispatches[0]] + fetches
        for d in dispatches[1:]:
            want += [d, ("book", nk // n_sub)] + fetches
        want += [("book", nk // n_sub)]
    assert r.events == want
    assert len(r.calls) >= len(starts) >= len(SNRS)


def test_host_copies_are_freed_without_the_garbage_collector(monkeypatch):
    """No reference cycle holds a sub-chunk's host copies (pinned memory
    on a card): each is freed with its last reference, so the collector
    never frees one inside a CUDA graph capture."""
    r = _gate_runner(1200.0, 4, 0.3, True)
    _stub_fetches(monkeypatch, r)
    gc.disable()
    try:
        r.simulate()
        alive = sum(ref() is not None for ref in r.copies)
    finally:
        gc.enable()
    assert len(r.copies) == 3 * len(r.calls)
    assert alive == 0


def test_randn_c_and_random_symbols():
    g = torch.Generator().manual_seed(0)
    x = randn_c(g, 4, 25_000)
    assert x.shape == (4, 25_000) and x.dtype == torch.complex64
    assert abs(float((x.abs() ** 2).mean()) - 1.0) < 5 / np.sqrt(x.numel())
    assert abs(float(x.real.var()) - 0.5) < 5 * 0.5 * np.sqrt(2 / x.numel())
    streams = AttemptStreams.from_range(9, 0, 3, "cpu")
    y = randn_c(streams, 10)
    assert y.shape == (3, 10) and torch.equal(y, randn_c(streams, 10))
    assert torch.equal(y[1:], randn_c(streams[1:], 10))

    # random_symbols unpacks 32-bit words low bits first, as the JAX
    # package's does
    sym = random_symbols(streams, 16, 4)
    words = streams.bits((2,)).numpy()
    want = (words[..., None] >> (4 * np.arange(8))) & 15
    np.testing.assert_array_equal(sym.numpy(), want.reshape(3, 16))
    assert random_symbols(g, 64, 2).shape == (64,)
    with pytest.raises(ValueError, match="multiple"):
        random_symbols(g, 10, 4)
