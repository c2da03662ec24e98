"""The port's MIMO / multiuser apps against the JAX apps, on the CPU.

* ``apps/simple_precoded_srs_torch.py``: the nine links' Jakes states
  injected into both apps (the JAX app's channels through a subclass that
  hands them out in construction order); every link's plain and SIC
  estimation MSE within 0.05 dB.
* ``apps/ia/simulate_ia_torch.py`` (closed form and Max-SINR) and
  ``apps/ia/simulate_greedy_ia_torch.py`` (no selection and greedy, both
  scenarios): the same channel matrices and unit noise in both apps (the
  port's ``channel_draws``; the JAX app's channel methods replaced in the
  test), the same precoder seeds, data streams and user drops. The host
  solvers are numpy in both packages, so the sum capacities agree to
  rtol 1e-5 (float32 channel products) and the BER to 1e-3 (a symbol on a
  decision boundary may flip).
* Bad settings raise as in the JAX apps.
"""

import os
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

IA_CONFIG = """[Scenario]
SNR = [10 20]
M = 4
modulator = PSK
NSymbs = 40
K = 3
Nr = 2
Nt = 2
Ns = 1
[IA Algorithm]
max_iterations = 5,60
initialize_with = random
[General]
max_bit_errors = 100000
unpacked_parameters = SNR, max_iterations, initialize_with
rep_max = 2
"""

GREEDY_CONFIG = """[Grid]
cell_radius = 1.0
num_cells = 3
num_clusters = 1
[Scenario]
NSymbs = 40
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
max_bit_errors = 100000
unpacked_parameters = SNR, stream_sel_method, scenario, initialize_with
"""


def _crandn(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _draws(seed, rows, cols, nsymbs):
    """The next repetition's channel matrix and unit noise, from a seeded
    numpy stream (one stream per app run)."""
    rng = np.random.default_rng(seed)
    return lambda: (_crandn(rng, rows, cols), _crandn(rng, rows, nsymbs))


def _inject_jax(runner, draw):
    """The JAX app's channel takes ``draw()``'s matrix and noise."""
    ch = runner.multiUserChannel
    noise = {}

    def randomize(Nr, Nt, K, key=None):
        H, noise["unit"] = draw()
        ch.init_from_channel_matrix(H, Nr, Nt, K)

    def corrupt_data(data, key=None):
        nv, ch.noise_var = ch.noise_var, None
        try:
            clean = type(ch).corrupt_data(ch, data)
        finally:
            ch.noise_var = nv
        unit = np.split(noise["unit"], np.cumsum(ch.Nr)[:-1])
        return [np.asarray(c) + u * np.float32(np.sqrt(nv))
                for c, u in zip(clean, unit)]

    ch.randomize, ch.corrupt_data = randomize, corrupt_data


def _values(runner, name):
    return np.array([float(v) for v in
                     runner.results.get_result_values_list(name)])


def _assert_same_results(mine, theirs):
    np.testing.assert_allclose(_values(mine, "sum_capacity"),
                               _values(theirs, "sum_capacity"), rtol=1e-5)
    np.testing.assert_allclose(_values(mine, "ber"), _values(theirs, "ber"),
                               atol=1e-3)
    assert mine.runned_reps == theirs.runned_reps


def test_srs_app_matches_the_jax_app(monkeypatch):
    import apps.simple_precoded_srs as japp
    import apps.simple_precoded_srs_torch as app
    from pyphysim_tpu.channels import fading as J_fading
    from pyphysim_tpu_torch.channels import jakes_state_from_numpy
    states = []

    class Injected(J_fading.TdlChannel):
        def _ensure_state(self):
            if self._state is None:
                self._state = self.init_state(
                    jax.random.PRNGKey(100 + len(states)))
                states.append(self._state)
            return self._state

    want = []
    score = japp.estimation_error_dB
    monkeypatch.setattr(japp, "TdlChannel", Injected)
    monkeypatch.setattr(japp, "estimation_error_dB",
                        lambda H, Hest: want.append(score(H, Hest))
                        or want[-1])
    japp.main()
    assert len(states) == 9 and len(want) == 18
    state = jakes_state_from_numpy(states, device="cpu")
    state = type(state)(*(v.reshape((3, 3) + v.shape[1:]) for v in state))
    got = app.run("cpu", state)
    np.testing.assert_allclose([v for k in got for v in got[k]], want,
                               atol=0.05)
    # the direct links gain nothing from SIC, the cross links do
    for (an, ue), (plain, sic) in got.items():
        assert (plain == sic) if an == ue else (sic < plain)


def test_srs_app_default_run_prints_every_link(capsys, monkeypatch):
    import apps.simple_precoded_srs_torch as app
    monkeypatch.setattr(sys, "argv", ["x", "--device", "cpu"])
    app.main()
    out = capsys.readouterr().out
    assert out.count("(direct)") == 3 and out.count("(cross)") == 6
    # as in the JAX app, every link starts from the seed-0 state: the run
    # is the run of those states given explicitly
    ch = app.channel("cpu")
    one = ch.init_state(torch.Generator().manual_seed(0))
    given = type(one)(*(v.expand((3, 3) + v.shape) for v in one))
    assert app.run("cpu") == app.run("cpu", given)


def test_simulate_ia_app_matches_the_jax_app(tmp_path, monkeypatch):
    import apps.ia.simulate_ia as japp
    import apps.ia.simulate_ia_torch as app
    for sub in ("jax", "torch"):     # each app its own result files
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "ia_config_file.txt").write_text(IA_CONFIG)
    monkeypatch.chdir(tmp_path / "jax")
    algorithms = ["Closed Form", "Max SINR"]

    def run_jax(runners):
        """The JAX app's runners, one after the other (no progress
        server)."""
        for i, r in enumerate(runners):
            r.ia_solver.set_precoder_seed(11)
            r.update_progress_function_style = None
            _inject_jax(r, _draws(i, 6, 6, 40))
            r.simulate()

    monkeypatch.setattr(japp, "simulate_do_what_i_mean", run_jax)
    theirs = japp.main_simulate(algorithms, "ia_config_file.txt",
                                read_command_line_args=False)
    monkeypatch.chdir(tmp_path / "torch")
    counter = iter(range(len(algorithms)))

    def setup(r):
        r.ia_solver.set_precoder_seed(11)
        r.update_progress_function_style = None
        r.channel_draws = _draws(next(counter), 6, 6, 40)

    mine = app.main_simulate(algorithms, "ia_config_file.txt",
                             read_command_line_args=False, device="cpu",
                             setup=setup)
    assert [type(r).__name__ for r in mine] == \
        [type(r).__name__ for r in theirs]
    for m, t in zip(mine, theirs):
        _assert_same_results(m, t)
        assert m.results_filename == t.results_filename
        caps = _values(m, "sum_capacity")
        assert np.all(np.isfinite(caps)) and np.all(caps > 0)
    assert len(_values(mine[1], "ber")) == 4        # 2 SNR x 2 iterations


def test_simulate_greedy_ia_app_matches_the_jax_app(tmp_path, monkeypatch):
    import apps.ia.simulate_greedy_ia as japp
    import apps.ia.simulate_greedy_ia_torch as app
    for sub in ("jax", "torch"):     # each app its own result files
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "greedy_config_file.txt").write_text(GREEDY_CONFIG)

    def run(module, inject, **kw):
        monkeypatch.chdir(tmp_path / ("torch" if kw else "jax"))
        r = module.IAStreamSelSimulationRunner(
            "greedy_config_file.txt", read_command_line_args=False, **kw)
        r.update_progress_function_style = None
        r.ia_solver.set_precoder_seed(5)
        r.data_RS = np.random.RandomState(6)
        inject(r, _draws(3, 6, 6, 40))
        np.random.seed(8)                          # the users' drops
        r.simulate()
        return r

    theirs = run(japp, _inject_jax)
    mine = run(app, lambda r, d: setattr(r, "channel_draws", d),
               device="cpu")
    _assert_same_results(mine, theirs)
    for m, t in zip(mine.results.get_result_values_list("stream_statistics"),
                    theirs.results.get_result_values_list(
                        "stream_statistics")):
        np.testing.assert_array_equal(m, t)


def test_bad_settings_raise_as_in_the_jax_apps(tmp_path, monkeypatch):
    import apps.ia.simulate_greedy_ia as japp
    import apps.ia.simulate_greedy_ia_torch as app
    import apps.ia.simulate_ia_torch as ia_app
    import apps.simple_precoded_srs_torch as srs_app
    monkeypatch.chdir(tmp_path)
    (tmp_path / "greedy_config_file.txt").write_text(GREEDY_CONFIG)
    for module, kw in ((app, {"device": "cpu"}), (japp, {})):
        r = module.IAStreamSelSimulationRunner(
            "greedy_config_file.txt", read_command_line_args=False, **kw)
        params = {"scenario": "NoPathLoss", "max_iterations": 10,
                  "stream_sel_method": "bogus"}
        with pytest.raises(ValueError, match="stream selection"):
            r._on_simulate_current_params_start(params)
        with pytest.raises(RuntimeError, match="Invalid scenario"):
            r._create_users_channels_according_to_scenario(
                {"Nr": 2, "Nt": 2, "num_cells": 3, "scenario": "bogus"})
    with pytest.raises(RuntimeError, match="cuda"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        ia_app.MaxSINRSimulationRunner("none", read_command_line_args=False)
    with pytest.raises(RuntimeError, match="cuda"):
        srs_app.run()


def test_point_in_cell_matches_the_jax_package():
    """The users' drops of the greedy app's 'Random' scenario test points
    against the cells' polygons: the port's numpy even-odd rule against
    the JAX package's matplotlib path, on random points around rotated
    shapes."""
    from pyphysim_tpu.cell import shapes as J_shapes
    from pyphysim_tpu_torch.cell import shapes
    rng = np.random.default_rng(4)
    for make in (lambda m: m.Hexagon(0.3 + 0.2j, 1.0, 17.0),
                 lambda m: m.Rectangle(-1 - 0.5j, 1.5 + 1j, 30.0),
                 lambda m: m.Circle(0.1j, 1.2)):
        mine, theirs = make(shapes), make(J_shapes)
        np.testing.assert_allclose(mine.vertices, theirs.vertices)
        points = rng.uniform(-2, 2, 2000) + 1j * rng.uniform(-2, 2, 2000)
        got = [mine.is_point_inside_shape(p) for p in points]
        assert got == [theirs.is_point_inside_shape(p) for p in points]
        assert 0 < sum(got) < len(got)
