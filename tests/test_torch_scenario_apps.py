"""The port's scenario, drawing and tooling apps against the JAX apps, on
the CPU.

* ``simulate_metis_scenario2_torch.simulate`` on the JAX app's seeds (its
  ``RandomState`` drops): equal AP counts, SINR and capacity within 1e-4
  relative (the JAX path loss is float32, the port's float64); the room
  and AP geometry helpers equal.
* ``simulate_metis_ps7_torch.simulate``: the SINR map within 1e-4 dB.
* ``waterfilling_tikz_draw_torch``: ``gen_latex_code`` / ``draw_wf`` text
  identical to the JAX app's on the same inputs; ``main``'s water level
  within 1e-12 relative of the JAX app's host solution.
* ``plot_ofdm_PSD_torch``: the OFDM signal within 1e-5 of the JAX app's;
  without matplotlib it prints the mean power, as the JAX app does.
* ``test_ia_feasibility_torch``: the port's host solvers against the JAX
  package's on the same channel and initial precoders (the solvers are
  numpy in both): costs within 1e-6 absolute, capacities within 1e-6
  relative.
* ``configobj_usage_example_torch``: the validated parameters the JAX
  example prints.
* ``testing_multiprocessing_progressbar_torch``: spawned workers count to
  the total.
"""

import io
import os
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


# -- METIS scenarios ---------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(num_users=50, num_rooms_per_side=6, ap_decimation=1, seed=1),
    dict(num_users=50, num_rooms_per_side=6, ap_decimation=4, seed=1),
    dict(num_users=100),
    dict(num_users=300, ap_decimation=9, seed=2),
    dict(num_users=2000, seed=3)])
def test_metis_scenario2_matches_the_jax_app(kw):
    from apps.metis_scenarios import simulate_metis_scenario2 as J
    from apps.metis_scenarios import simulate_metis_scenario2_torch as T
    j_sinr, j_cap, j_tx, j_aps = J.simulate(**kw)
    sinr, cap, tx, aps = T.simulate(**kw, device="cpu")
    assert (tx, aps) == (j_tx, j_aps)
    assert sinr.dtype == torch.float64 and sinr.shape == j_sinr.shape
    assert np.allclose(10 ** (sinr.numpy() / 10), 10 ** (j_sinr / 10),
                       rtol=1e-4, atol=0)
    assert np.allclose(cap.numpy(), j_cap, rtol=1e-4, atol=0)
    assert bool((cap >= 0).all())


def test_metis_scenario2_geometry_helpers():
    from apps.metis_scenarios import simulate_metis_scenario2 as J
    from apps.metis_scenarios import simulate_metis_scenario2_torch as T
    rooms = T.calc_room_positions_square(10.0, 36)
    assert np.array_equal(rooms, J.calc_room_positions_square(10.0, 36))
    grid = rooms.reshape(6, 6)
    for dec in (1, 2, 4, 9):
        assert np.array_equal(T.get_ap_positions(grid, dec),
                              J.get_ap_positions(grid, dec))
    users = T.drop_users(40, 6, 10.0, 5)
    aps = T.get_ap_positions(grid, 2)
    want = J.calc_num_walls(10.0, users, aps)
    assert np.array_equal(T.calc_num_walls(10.0, users, aps).numpy(), want)
    got = T.calc_num_walls(10.0, torch.as_tensor(users), torch.as_tensor(aps))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


def test_metis_scenario2_main(capsys):
    from apps.metis_scenarios import simulate_metis_scenario2_torch as T
    T.main(["--users", "30", "--rooms", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "30 users, 8 APs (decimation 2)" in out and "SINR (dB)" in out


def test_metis_ps7_matches_the_jax_app(tmp_path, monkeypatch, capsys):
    from apps.metis_scenarios import simulate_metis_ps7 as J
    from apps.metis_scenarios import simulate_metis_ps7_torch as T
    j_sinr, j_xs, j_ys = J.simulate(num_rooms_per_side=3, grid_points=25)
    sinr, xs, ys = T.simulate(num_rooms_per_side=3, grid_points=25,
                              device="cpu")
    assert np.array_equal(xs, j_xs) and np.array_equal(ys, j_ys)
    assert sinr.shape == (25, 25)
    assert np.max(np.abs(sinr.numpy() - j_sinr)) < 1e-4
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    T.main(["--device", "cpu"])
    assert (tmp_path / "metis_ps7_sinr.png").exists()
    assert "SINR map (60, 60)" in capsys.readouterr().out


# -- waterfilling drawing ----------------------------------------------------


@pytest.mark.parametrize("gains, level, noise, length", [
    ([0.9, 0.5, 0.1], 1.7, 0.1, 0.8), ([0.9, 0.5], 0.7, 1.0, 0.8),
    ([[2.0], [0.3], [0.05], [1.1]], 0.4, 0.01, 1.25)])
def test_waterfilling_text_equals_the_jax_app(gains, level, noise, length,
                                              tmp_path):
    from apps import waterfilling_tikz_draw as J
    from apps import waterfilling_tikz_draw_torch as T
    gains = np.array(gains)
    want = J.gen_latex_code(gains, level, noise, length)
    assert T.gen_latex_code(gains, level, noise, length) == want
    assert T.gen_latex_code(torch.as_tensor(gains), level, noise,
                            length) == want
    J.draw_wf(gains, level, noise, length, filename=str(tmp_path / "j.tex"))
    T.draw_wf(gains, level, noise, length, filename=str(tmp_path / "t.tex"))
    assert (tmp_path / "t.tex").read_text() == (tmp_path / "j.tex").read_text()


def test_waterfilling_main_solves_on_the_device(tmp_path, capsys):
    from apps import waterfilling_tikz_draw_torch as T
    from pyphysim_tpu.comm import waterfilling
    out = tmp_path / "wf.tex"
    T.main(["--out", str(out), "--device", "cpu"])
    level = float(re.search(r"Water level: (\S+)",
                            capsys.readouterr().out).group(1))
    _, mu = waterfilling.doWF(
        np.array([9.32904521e-13, 2.63321084e-13, 5.06505202e-14]), 0.2512,
        2.5119e-14)
    assert np.isclose(level, mu, rtol=1e-12, atol=0)
    assert out.read_text().startswith("\\documentclass")


# -- OFDM PSD ----------------------------------------------------------------


def test_plot_ofdm_psd_signal_and_fallback(tmp_path, monkeypatch):
    from apps.ofdm import plot_ofdm_PSD as J
    from apps.ofdm import plot_ofdm_PSD_torch as T
    from pyphysim_tpu.modulators.ofdm import OFDM
    bits = np.random.RandomState(0).randint(0, 2, 2496)
    want = np.asarray(OFDM(64, 16, 52).modulate((2 * bits - 1).astype(
        complex)))
    ofdm, signal = T.ofdm_signal("cpu")
    assert ofdm.fft_size == 64 and signal.shape == want.shape
    assert np.allclose(signal.numpy(), want, atol=1e-5)
    # without matplotlib both print the mean power
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["plot_ofdm_PSD.py"])
    for name in ("matplotlib", "matplotlib.mlab", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    outs = []
    for run in (J.main, lambda: T.main(["--device", "cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            run()
        outs.append(float(re.search(r"mean \|x\|\^2 = (\S+)",
                                    buf.getvalue()).group(1)))
    assert np.isclose(outs[1], outs[0], rtol=1e-5)


def test_plot_ofdm_psd_writes_the_plot(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    from apps.ofdm import plot_ofdm_PSD_torch as T
    out = tmp_path / "psd.png"
    T.main(["--out", str(out), "--device", "cpu"])
    assert out.exists()


# -- IA feasibility ----------------------------------------------------------


def test_ia_feasibility_matches_the_jax_solvers():
    from apps.ia import test_ia_feasibility_torch as T
    from pyphysim_tpu.channels.multiuser import \
        MultiUserChannelMatrix as JChannel
    from pyphysim_tpu.ia import algorithms as JA
    out = T.run(seed=3, device="cpu")
    channel = T.make_channel(3, "cpu")
    j_channel = JChannel()
    j_channel.init_from_channel_matrix(channel.big_H.numpy(), T.NR, T.NT,
                                       T.K)
    j_channel.noise_var = channel.noise_var
    assert out["iterations"] == {"Alt Min": 400, "MMSE": 100,
                                 "Max SINR": 100}
    for i, (name, _, iterations) in enumerate(T.SOLVERS):
        cls = {"Alt Min": JA.AlternatingMinIASolver, "MMSE": JA.MMSEIASolver,
               "Max SINR": JA.MaxSinrIASolver}[name]
        solver = cls(j_channel)
        solver.set_precoder_seed(3 + i)
        solver.randomizeF(T.NS)
        solver.max_iterations = iterations
        assert solver.solve(T.NS) == out["iterations"][name]
        capacity = float(np.sum(np.log2(np.hstack(
            [1.0 + np.asarray(s) for s in solver.calc_SINR()]))))
        assert np.isclose(out["capacity"][name], capacity, rtol=1e-6,
                          atol=0), name
        if name == "Alt Min":
            assert abs(out["cost"] - solver.get_cost()) < 1e-6
    assert out["cost"] < 1e-2                     # aligned: ~0 leakage
    assert out["capacity"]["Alt Min"] > 20


def test_ia_feasibility_main(capsys):
    from apps.ia import test_ia_feasibility_torch as T
    out = T.main(["--device", "cpu", "--seed", "1"])
    text = capsys.readouterr().out
    assert "Final cost (Alt Min leakage)" in text
    for name in ("Alt Min", "MMSE", "Max SINR"):
        assert f"Sum Capacity ({name}):" in text
        assert np.isfinite(out["capacity"][name])


# -- configobj example and the progressbar demo -----------------------------


def test_configobj_example_prints_the_jax_parameters(tmp_path, monkeypatch):
    from apps import configobj_usage_example as J
    from apps import configobj_usage_example_torch as T
    monkeypatch.chdir(tmp_path)
    outs = []
    for folder, run in (("j", lambda: J.main()),
                        ("t", lambda: T.main(["cfg.txt", "--device",
                                              "cpu"]))):
        os.makedirs(folder)
        monkeypatch.chdir(tmp_path / folder)
        monkeypatch.setattr(sys, "argv", ["example", "cfg.txt"])
        buf = io.StringIO()
        with redirect_stdout(buf):
            run()
        outs.append(buf.getvalue())
        monkeypatch.chdir(tmp_path)
    port_lines = outs[1].splitlines()
    assert port_lines[-1].startswith("Linear SNRs on cpu: [1.0, ")
    assert port_lines[:-1] == outs[0].splitlines()
    assert (tmp_path / "t" / "cfg.txt").read_text() == \
        (tmp_path / "j" / "cfg.txt").read_text()


def test_multiprocessing_progressbar_counts_every_worker():
    from apps.testing_multiprocessing_progressbar_torch import run
    assert run(num_process=2, rep_max=150, device="cpu") == 300
