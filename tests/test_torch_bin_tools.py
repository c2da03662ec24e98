"""The port's ``bin/`` tools: the result-file tools against the JAX
package's, the API-docs generator and the test launcher, on the CPU.

* ``combine_results_torch.py`` and ``bin/combine_results.py`` combine the
  same values, built in each package, into the same parameter union and
  the same result values, under the same default name.
* ``split_into_partial_results_torch.py`` writes the files a port runner
  resumes from: each variation continues at the repetitions it ran and no
  repetition runs again. The setting is one where the JAX script's two
  formulas fail: fewer than 10 variations (it pads the index to two
  digits, the runner to the digit count of the number of variations) and
  chunks of several repetitions (it takes the resume point from the
  ``elapsed_time`` result's update count, one update a chunk).
* ``generate_api_docs_torch.py`` writes a heading for every port module,
  no ``import failed`` line, and leaves jax, the JAX package and the
  optional packages out of ``sys.modules`` (a fresh interpreter); the
  committed ``docs/api_torch.md`` is its output.
* ``py-physim-tpu-torch`` runs ``python -m pytest tests/test_torch_*.py
  -q`` from the repository root, with the caller's arguments after them.
"""

import glob
import importlib.util
import os
import pkgutil
import stat
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu import simulations as J  # noqa: E402
from pyphysim_tpu_torch import simulations as T  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "bin")


def _script(name):
    """A ``bin/`` script loaded as a module from its path (``bin/`` is no
    package)."""
    spec = importlib.util.spec_from_file_location(
        name.replace("-", "_"), os.path.join(BIN, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _results(package, snrs, seed):
    """A results object of ``package`` over ``SNR`` (unpacked) and a fixed
    ``M``: a SUMTYPE and a RATIOTYPE result a variation, its values drawn
    from ``seed``."""
    rng = np.random.default_rng(seed)
    res = package.SimulationResults()
    params = package.SimulationParameters()
    params.add("SNR", np.asarray(snrs, dtype=float))
    params.add("M", 4)
    params.set_unpack_parameter("SNR")
    res.set_parameters(params)
    for _ in snrs:
        errors = package.Result.create("bit_errors", package.Result.SUMTYPE,
                                       int(rng.integers(0, 1000)))
        ber = package.Result.create("ber", package.Result.RATIOTYPE,
                                    int(rng.integers(0, 100)), 1000)
        res.append_result(errors)
        res.append_result(ber)
    return res


def _combine(package, tool_main, folder, monkeypatch, argv_prefix):
    os.makedirs(folder)
    monkeypatch.chdir(folder)
    _results(package, [0.0, 5.0], 1).save_to_file("first.pickle")
    _results(package, [10.0, 15.0, 20.0], 2).save_to_file("second.pickle")
    monkeypatch.setattr(sys, "argv", argv_prefix + ["first.pickle",
                                                    "second.pickle"])
    tool_main()
    return package.SimulationResults.load_from_file(
        os.path.join(folder, "combined_results.pickle"))


def test_combine_results_matches_the_jax_tool(tmp_path, monkeypatch):
    jax_tool = _script("combine_results")
    port_tool = _script("combine_results_torch")
    want = _combine(J, jax_tool.main, tmp_path / "jax", monkeypatch,
                    ["combine_results.py"])
    got = _combine(T, port_tool.main, tmp_path / "torch", monkeypatch,
                   ["combine_results_torch.py"])
    np.testing.assert_array_equal(got.params["SNR"], want.params["SNR"])
    np.testing.assert_array_equal(got.params["SNR"],
                                  [0.0, 5.0, 10.0, 15.0, 20.0])
    assert got.params["M"] == want.params["M"] == 4
    assert got.params.unpacked_parameters == want.params.unpacked_parameters
    assert got.get_result_names() == want.get_result_names()
    for name in want.get_result_names():
        assert got.get_result_values_list(name) == \
            want.get_result_values_list(name)


def test_combine_results_takes_an_output_name(tmp_path):
    tool = _script("combine_results_torch")
    first, second = tmp_path / "a.pickle", tmp_path / "b.pickle"
    _results(T, [0.0], 3).save_to_file(str(first))
    _results(T, [5.0], 4).save_to_file(str(second))
    name = tool.main([str(first), str(second), str(tmp_path / "c.json")])
    assert name == str(tmp_path / "c.json")
    union = T.SimulationResults.load_from_file(name)
    np.testing.assert_array_equal(union.params["SNR"], [0.0, 5.0])


class CoinRunner(T.SimulationRunner):
    """A per-key runner on the CPU: attempt ``a`` flips 8 coins from its
    stream. Records the attempts each chunk ran."""

    def __init__(self, rep_max):
        super().__init__(read_command_line_args=False)
        self.device = "cpu"
        self.params.add("SNR", np.array([0.0, 1.0, 2.0]))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = rep_max
        self.batch_size = 4
        self.update_progress_function_style = None
        self.batch_result_types = {"heads": T.Result.SUMTYPE,
                                   "rate": T.Result.RATIOTYPE}
        self.attempts = []

    def _gen_simulation_kernel(self, current_parameters):
        index = current_parameters.unpack_index

        def kernel(streams):
            self.attempts.append((index, streams.attempts.tolist()))
            heads = (streams.uniform((8,)) < 0.5).sum(dim=-1)
            return {"heads": heads, "rate": (heads, 8.0)}

        return kernel


def test_split_results_resume_where_each_variation_stopped(tmp_path):
    tool = _script("split_into_partial_results_torch")
    first = CoinRunner(rep_max=10)
    first.set_results_filename(str(tmp_path / "coins_{SNR}"))
    first.simulate()
    results_file = first.results_filename + ".pickle"
    assert first.runned_reps == [10, 10, 10]
    saved = T.SimulationResults.load_from_file(results_file)
    # the JAX script's resume point: one elapsed_time update a chunk
    assert [r.num_updates for r in saved["elapsed_time"]] == [3, 3, 3]

    written = tool.main([results_file, "-o",
                         str(tmp_path / "partial_results")])
    resumed = CoinRunner(rep_max=16)
    resumed.set_results_filename(str(tmp_path / "coins_{SNR}"))
    base = tool.results_base_name(results_file)
    for i, (name, var) in enumerate(zip(
            written, resumed.params.get_unpacked_params_list())):
        # the name the runner looks for; the JAX script's two-digit index
        # names another file
        assert name == resumed._get_partial_results_filename(var)
        assert os.path.basename(name) == f"{base}_unpack_{i}.pickle"
        assert f"_unpack_{i:02d}." not in name
        partial = T.SimulationResults.load_from_file(name)
        assert partial.current_rep == 10

    resumed.simulate()      # checks each file's parameters as it loads it
    assert resumed.runned_reps == [16, 16, 16]
    for index in range(3):
        ran = sorted(a for i, chunk in resumed.attempts if i == index
                     for a in chunk)
        assert ran == list(range(10, 16)), (index, ran)
    fresh = CoinRunner(rep_max=16)
    fresh.simulate()
    for name in ("heads", "rate"):
        assert resumed.results.get_result_values_list(name) == \
            fresh.results.get_result_values_list(name)


def test_split_refuses_a_file_without_its_repetitions(tmp_path):
    tool = _script("split_into_partial_results_torch")
    path = tmp_path / "bare.pickle"
    _results(T, [0.0, 5.0], 5).save_to_file(str(path))
    with pytest.raises(ValueError, match="repetitions"):
        tool.main([str(path), "-o", str(tmp_path / "out")])
    assert tool.results_base_name("a/b/res_1.5") == "res_1.5"
    assert tool.results_base_name("res_[0_2].pickle") == "res_[0_2]"


def test_api_docs_cover_every_module_in_a_fresh_interpreter(tmp_path):
    import pyphysim_tpu_torch
    out = tmp_path / "api_torch.md"
    path = os.path.join(BIN, "generate_api_docs_torch.py")
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('g', {path!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            f"mod.main({str(out)!r})\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton', 'pyphysim_tpu', 'zmq', 'IPython', "
            "'ipywidgets', 'matplotlib', 'configobj')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    text = out.read_text()
    assert "import failed" not in text
    modules = [m.name for m in pkgutil.walk_packages(
        pyphysim_tpu_torch.__path__, "pyphysim_tpu_torch.")]
    headings = {line[4:-1] for line in text.splitlines()
                if line.startswith("## `")}
    assert headings == set(modules)
    with open(os.path.join(REPO, "docs", "api_torch.md")) as f:
        assert f.read() == text


def test_api_docs_never_write_the_jax_reference():
    tool = _script("generate_api_docs_torch")
    with pytest.raises(ValueError, match="api_torch.md"):
        tool.main(os.path.join(REPO, "docs", "api.md"))


def test_test_launcher_runs_the_port_tests_from_the_root(tmp_path):
    launcher = os.path.join(BIN, "py-physim-tpu-torch")
    assert stat.S_IMODE(os.stat(launcher).st_mode) == 0o755
    fake = tmp_path / "python"
    fake.write_text('#!/bin/sh\necho "$PWD"\nfor a in "$@"; do echo "$a"; '
                    'done\n')
    fake.chmod(0o755)
    env = dict(os.environ, PATH=f"{tmp_path}:{os.environ['PATH']}")
    proc = subprocess.run([launcher, "-x", "-k", "fir"], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    tests = sorted(os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "tests", "test_torch_*.py")))
    assert os.path.realpath(lines[0]) == os.path.realpath(REPO)
    assert lines[1:3] == ["-m", "pytest"]
    assert sorted(lines[3:3 + len(tests)]) == tests
    assert lines[3 + len(tests):] == ["-q", "-x", "-k", "fir"]
