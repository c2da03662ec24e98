"""The port's IA result tools against the JAX tools, on the CPU.

The port's IA apps write small result files (``simulate_ia_torch`` with
four solvers, ``simulate_greedy_ia_torch`` with its partial results);
each file goes to the JAX package through the JSON format both packages
share, and the port's tool on the port's files must give the JAX tool's
output on the JAX files: the same tikz files
(``ia_results_plots_torch.make_plots``), the same printed statistics
tables (``greedy_statistics_torch``) and the same partial-results audit
(``check_greedy_partial_results_torch``), character for character.
"""

import io
import os
import shutil
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

APPS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "apps")

IA_CONFIG = """[Scenario]
SNR = [5 15]
M = 4
modulator = PSK
NSymbs = 30
K = 3
Nr = 2
Nt = 2
Ns = 1
[IA Algorithm]
max_iterations = 5,10
initialize_with = random
[General]
max_bit_errors = 3000
unpacked_parameters = SNR, max_iterations, initialize_with
rep_max = 2
"""

GREEDY_CONFIG = """[Grid]
cell_radius = 1.0
num_cells = 3
num_clusters = 1
[Scenario]
NSymbs = 30
SNR = [10 20]
M = 4
modulator = PSK
Nr = 2
Nt = 2
Ns = 2
N0 = -116.4
scenario = Random, NoPathLoss
[IA Algorithm]
max_iterations = 10
initialize_with = random
stream_sel_method = none, greedy
[General]
rep_max = 2
max_bit_errors = 3000
unpacked_parameters = SNR, stream_sel_method, scenario, initialize_with
"""


def _to_jax_pickles(src_dir, dst_dir):
    """Every port result pickle under ``src_dir`` saved as a JAX package
    pickle at the same relative path under ``dst_dir`` (through JSON)."""
    from pyphysim_tpu.simulations.results import \
        SimulationResults as JResults
    from pyphysim_tpu_torch.simulations.results import SimulationResults
    for root, _, files in os.walk(src_dir):
        for name in files:
            if not name.endswith(".pickle"):
                continue
            rel = os.path.relpath(os.path.join(root, name), src_dir)
            out = os.path.join(dst_dir, rel)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            port = SimulationResults.load_from_file(os.path.join(root, name))
            JResults.from_json(port.to_json()).save_to_file(out)


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with redirect_stdout(buf):
        value = fn(*args, **kwargs)
    return buf.getvalue(), value


def _quiet(runner):
    runner.update_progress_function_style = None


def test_ia_results_plots_equal_the_jax_tool(tmp_path, monkeypatch):
    from apps.ia import ia_results_plots as J
    from apps.ia import ia_results_plots_torch as T
    from apps.ia.simulate_ia_torch import main_simulate
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    (port_dir / "ia_config_file.txt").write_text(IA_CONFIG)
    monkeypatch.chdir(port_dir)
    _printed(main_simulate, ["Closed Form", "Alt Min", "Max SINR", "MMSE"],
             "ia_config_file.txt", read_command_line_args=False,
             device="cpu", setup=_quiet)
    _to_jax_pickles(str(port_dir), str(jax_dir))
    names = {}
    for pkg, folder in ((T, port_dir), (J, jax_dir)):
        out = folder / "plots"
        out.mkdir()
        names[pkg] = pkg.make_plots(
            str(folder), 10, templates_dir=APPS, out_dir=str(out),
            base_name="4-PSK_2x2_(1)_MaxIter_[5_(5)_10]",
            base_name_no_iter="4-PSK_2x2_(1)")
    for port_file, jax_file in zip(names[T], names[J]):
        assert os.path.basename(port_file) == os.path.basename(jax_file)
        text = open(port_file).read()
        assert text == open(jax_file).read()
        assert "MAXITER" not in text and text.count("\\addplot") >= 3
    from pyphysim_tpu_torch.simulations.results import SimulationResults
    alt_min = SimulationResults.load_from_file(str(
        port_dir / "ia_alt_min_results_4-PSK_2x2_(1)_MaxIter_[5_(5)_10]"
        ".pickle"))
    assert list(T.get_num_runned_reps(alt_min, {"max_iterations": 5})) == \
        [2, 2]
    with pytest.raises(ValueError):
        T.make_plots(str(port_dir), 10)


def test_greedy_tools_equal_the_jax_tools(tmp_path, monkeypatch):
    from apps.ia import check_greedy_partial_results as JC
    from apps.ia import check_greedy_partial_results_torch as TC
    from apps.ia import greedy_statistics as JS
    from apps.ia import greedy_statistics_torch as TS
    from apps.ia.simulate_greedy_ia_torch import IAStreamSelSimulationRunner
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    (port_dir / "greedy_config_file.txt").write_text(GREEDY_CONFIG)
    monkeypatch.chdir(port_dir)
    runner = IAStreamSelSimulationRunner("greedy_config_file.txt",
                                         read_command_line_args=False,
                                         device="cpu")
    _quiet(runner)
    runner.set_results_filename(
        "greedy_IA_stream_sel_results_{SNR}_{M}-{modulator}_{Nr}x{Nt}"
        "_({Ns})_MaxIter_{max_iterations}_({initialize_with})")
    _printed(runner.simulate)
    _to_jax_pickles(str(port_dir), str(jax_dir))
    shutil.copy(port_dir / "greedy_config_file.txt", jax_dir)

    outputs = {}
    for stats, check, folder in ((TS, TC, port_dir), (JS, JC, jax_dir)):
        monkeypatch.chdir(folder)
        results = stats.get_result_from_file("greedy_config_file.txt")
        table_text, _ = _printed(stats.print_all, results, Ns=[2, 2, 2])
        pickles = sorted(f for f in os.listdir(folder)
                         if f.endswith(".pickle"))
        audit_text, partials = _printed(check.check_partials, pickles[0])
        outputs[stats] = (table_text, audit_text, len(partials), results)
    port, jax = outputs[TS], outputs[JS]
    assert port[:3] == jax[:3]
    assert port[2] == 8                  # 2 SNR x 2 methods x 2 scenarios
    assert "SNR: 10" in port[0] and "%" in port[0]
    stats = port[3].get_result_values_list(
        "stream_statistics",
        fixed_params={"stream_sel_method": "greedy",
                      "scenario": "NoPathLoss"})
    table = TS.get_pretty_statistic_table(stats[0], Ns=[2, 2, 2])
    assert table == JS.get_pretty_statistic_table(stats[0], Ns=[2, 2, 2])
    assert len(table) == 8 and np.isclose(sum(v for _, v in table), 100.0)
