"""The port's SimulationRunner against the JAX package's, each given the
same numpy kernel.

The bulk kernel draws everything for attempt ``a`` from
``numpy.random.default_rng([base_seed, unpack_index, a])``, so both
runners see the same values for the same absolute attempt; their Results
(``bit_errors`` sums, ``ber``, ``num_skipped_reps``, ``runned_reps``) must
be equal — exactly, since no float math differs. Covered: the
``__valid__`` skip-and-retry, chunk sizes 2 and 6, the early-stop ladder,
checkpoint then resume, the serial path, and results JSON files crossing
between the packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import pyphysim_tpu.simulations as J  # noqa: E402
import pyphysim_tpu_torch.simulations as T  # noqa: E402

SNRS = np.array([0.0, 10.0, 20.0])
TOTAL = 1000.0


def _attempt(base_seed, unpack, a, p_skip):
    rng = np.random.default_rng([base_seed, unpack, a])
    errors = int(rng.integers(0, 400))
    valid = bool(rng.random() >= p_skip)
    return errors, valid


def _make_runner(pkg, rep_max=12, batch=4, p_skip=0.0, stop=None,
                 serial=False, as_tensors=None):
    """A runner of ``pkg`` (the JAX or the port's simulations module)
    driven by the numpy kernel above."""

    class Bulk(pkg.SimulationRunner):
        def __init__(self):
            super().__init__(read_command_line_args=False)
            self.params.add("SNR", SNRS)
            self.params.set_unpack_parameter("SNR")
            self.rep_max = rep_max
            self.batch_size = batch
            self.batch_stop_criterion = stop
            self.update_progress_function_style = None
            self.batch_result_types = {"bit_errors": pkg.Result.SUMTYPE,
                                       "ber": pkg.Result.RATIOTYPE}
            self.calls = []

        def _gen_bulk_kernel(self, current_parameters):
            unpack = max(current_parameters.unpack_index, 0)

            def bulk(start, n):
                self.calls.append((unpack, start, n))
                rows = [_attempt(self.base_seed, unpack, a, p_skip)
                        for a in range(start, start + n)]
                errors = np.array([r[0] for r in rows], np.int64)
                valid = np.array([r[1] for r in rows])
                if as_tensors:
                    errors = torch.from_numpy(errors).to(as_tensors)
                    valid = torch.from_numpy(valid).to(as_tensors)
                return {"bit_errors": errors,
                        "ber": (errors, np.full(n, TOTAL)),
                        "__valid__": valid}

            return bulk

    class Serial(pkg.SimulationRunner):
        def __init__(self):
            super().__init__(read_command_line_args=False)
            self.params.add("SNR", SNRS)
            self.params.set_unpack_parameter("SNR")
            self.rep_max = rep_max
            self.update_progress_function_style = None

        def _run_simulation(self, current_parameters):
            unpack = max(current_parameters.unpack_index, 0)
            errors, valid = _attempt(self.base_seed, unpack,
                                     self.serial_attempt, p_skip)
            if not valid:
                raise pkg.SkipThisOne("drawn as invalid")
            res = pkg.SimulationResults()
            res.add_new_result("bit_errors", pkg.Result.SUMTYPE, errors)
            res.add_new_result("ber", pkg.Result.RATIOTYPE, errors, TOTAL)
            return res

    return Serial() if serial else Bulk()


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


def _both(**kw):
    out = []
    for pkg in (J, T):
        r = _make_runner(pkg, **kw)
        r.simulate()
        out.append(r)
    return out


@pytest.mark.parametrize("batch", [2, 6])
@pytest.mark.parametrize("p_skip", [0.0, 0.3])
def test_bulk_results_equal_jax(batch, p_skip):
    jr, tr = _both(batch=batch, p_skip=p_skip)
    assert _summary(tr) == _summary(jr)
    assert tr.calls == jr.calls
    if p_skip:
        assert sum(_summary(tr)["num_skipped_reps"]) > 0


def test_results_are_chunk_size_invariant():
    a = _make_runner(T, batch=2, p_skip=0.3)
    b = _make_runner(T, batch=6, p_skip=0.3)
    a.simulate()
    b.simulate()
    assert _summary(a) == _summary(b)


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_tensor_outputs_are_fetched(device):
    """Kernel outputs as tensors (on the card: fetched through pinned
    copies queued behind each chunk) give the numpy kernel's Results."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    a = _make_runner(T, p_skip=0.3, as_tensors=device)
    b = _make_runner(T, p_skip=0.3)
    a.simulate()
    b.simulate()
    assert _summary(a) == _summary(b)


def test_clear_resets_results_and_keeps_parameters():
    """``clear`` as the JAX runner's: elapsed time, run repetitions and
    results go; the parameters stay, and a second run gives the first's
    results."""
    runners = []
    for pkg in (J, T):
        r = _make_runner(pkg, p_skip=0.3)
        r.simulate()
        first = _summary(r)
        r.clear()
        assert (r.elapsed_time, r.runned_reps) == ("0.00s", [])
        assert r.results.get_result_names() == []
        assert list(r.params["SNR"]) == list(SNRS)
        r.simulate()
        assert _summary(r) == first
        runners.append(r)
    assert _summary(runners[1]) == _summary(runners[0])


def test_stop_criterion_ladder_equal_jax():
    jr, tr = _both(rep_max=200, batch=32, stop=("bit_errors", 6000.0))
    assert _summary(tr) == _summary(jr)
    assert tr.calls == jr.calls
    assert max(tr.runned_reps) < 200   # the criterion stopped early
    assert {n for _, _, n in tr.calls} <= {4, 8, 16, 32}


def test_serial_path_equal_jax():
    jr, tr = _both(serial=True, p_skip=0.3)
    assert _summary(tr) == _summary(jr)


def test_checkpoint_then_resume(tmp_path):
    """A sweep stopped at rep_max 6 and resumed to 12 from its partial
    results equals one run straight to 12, in both packages."""
    for pkg in (J, T):
        folder = tmp_path / pkg.__name__.split(".")[0]
        folder.mkdir()
        first = _make_runner(pkg, rep_max=6, p_skip=0.3)
        first.set_results_filename(str(folder / "res_{SNR}"))
        first.simulate()
        partials = sorted(p.name for p in (folder / "partial_results")
                          .iterdir())
        assert len(partials) == len(SNRS)
        resumed = _make_runner(pkg, rep_max=12, p_skip=0.3)
        resumed.set_results_filename(str(folder / "res_{SNR}"))
        resumed.simulate()
        straight = _make_runner(pkg, rep_max=12, p_skip=0.3)
        straight.simulate()
        assert _summary(resumed)["bit_errors"] == \
            _summary(straight)["bit_errors"]
        assert _summary(resumed)["num_skipped_reps"] == \
            _summary(straight)["num_skipped_reps"]
        # the resumed sweep only simulated the missing attempts
        assert min(start for _, start, _ in resumed.calls) >= 6
        if pkg is T:
            port = _summary(resumed)
        else:
            ref = _summary(resumed)
    assert port["bit_errors"] == ref["bit_errors"]


def test_resume_rejects_other_parameters(tmp_path):
    first = _make_runner(T, rep_max=4)
    first.set_results_filename(str(tmp_path / "res"))
    first.simulate()
    other = _make_runner(T, rep_max=4)
    other.params.add("extra", 1)
    other.set_results_filename(str(tmp_path / "res"))
    with pytest.raises(ValueError, match="do not match"):
        other.simulate()


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J)])
def test_results_json_crosses_packages(tmp_path, writer, reader):
    r = _make_runner(writer, p_skip=0.3)
    r.set_results_filename(str(tmp_path / "results.json"))
    r.simulate()
    loaded = reader.SimulationResults.load_from_file(
        str(tmp_path / "results.json"))
    assert isinstance(loaded, reader.SimulationResults)
    assert loaded.runned_reps == r.runned_reps
    np.testing.assert_array_equal(loaded.params["SNR"], SNRS)
    assert loaded.params.unpacked_parameters == ["SNR"]
    for name in ("bit_errors", "ber", "num_skipped_reps"):
        assert loaded.get_result_values_list(name) == \
            r.results.get_result_values_list(name)
    ber = loaded["ber"][0]
    assert ber.get_confidence_interval(95.0) == \
        r.results["ber"][0].get_confidence_interval(95.0)


def test_per_key_path_is_not_ported():
    """The per-key path refuses what its contract does not cover: a
    runner without declared result types, and the default CUDA device on
    a machine without one (no silent CPU run)."""
    class PerKey(T.SimulationRunner):
        def _gen_simulation_kernel(self, current_parameters):
            return lambda streams: {}

    r = PerKey(read_command_line_args=False)
    r.update_progress_function_style = None
    with pytest.raises(RuntimeError, match="per-key path requires"):
        r.simulate()
    r.batch_result_types = {"bit_errors": T.Result.SUMTYPE}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            r.simulate()


def test_kernel_stream_seed_matches_jax():
    for base, unpack in ((1234, 0), (1234, 7), (2 ** 40 + 5, 3), (9, -1)):
        assert T.kernel_stream_seed(base, unpack) == \
            J.kernel_stream_seed(base, unpack)
