"""The comp_BD scenario app of the port
(``apps/comp_BD/simulate_comp_torch.py``) on the CPU: its user drops and
path loss against the JAX app's, the bulk engine's chunk invariance, the
bulk engine against the host engine draw for draw, the non-square
configuration, and the physics of bench.py's stage at a pinned seed.

Tolerances and why:

* drops and path loss: the same numpy code on the same Philox stream, so
  equal bit for bit;
* chunk invariance: every draw is keyed by its absolute attempt and every
  operation works draw by draw, so bit for bit;
* host engine against bulk engine: both draw attempt ``a`` alike (the host
  engine's 1-based repetition ``a`` is the bulk engine's attempt ``a``);
  the host solvers are numpy, the bulk ones batched torch, so a stream
  count may flip where two candidates of a selecting metric nearly tie (at
  most one draw in twelve); elsewhere the symbol and bit error counts are
  equal and the SINR sums agree to 1e-3;
* ``ser_capacity < ser_None``: strict, at the runner's pinned base seed,
  over 256 repetitions (bench.py's strict inequality, ADVICE.md:5).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from apps.comp_BD.simulate_comp import \
    BDSimulationRunner as JRunner  # noqa: E402
from apps.comp_BD.simulate_comp_torch import (CONFIG_DIR,  # noqa: E402
                                              METRICS, BDSimulationRunner,
                                              draw_attempts)
from pyphysim_tpu_torch.ops.streams import AttemptStreams  # noqa: E402

COMP_BD_SER_CAPACITY = (0.0015, 0.03)     # bench.py:550
COMP_BD_SER_NONE = (0.025, 0.15)          # bench.py:551


def runner(engine="device", metrics=None, reps=8, batch=8, config=None,
           method="Random"):
    r = BDSimulationRunner(read_command_line_args=False, engine=engine,
                           metrics=metrics, device="cpu",
                           default_config_file=config)
    r.params.add("SNR", np.array([20.0]))
    r.params.add("Pe_dBm", np.array([10.0]))
    r.params.add("user_positioning_method", method)
    r.rep_max, r.batch_size = reps, batch
    r.update_progress_function_style = None
    return r


def point(r):
    return r.params.get_unpacked_params_list()[0]


@pytest.mark.parametrize("method", ["Random", "Symmetric Far Away"])
def test_drops_and_path_loss_equal_the_jax_app(method):
    r = runner(method=method)
    j = JRunner(read_command_line_args=False, engine="host")
    for obj in (r, j):
        obj.params.add("user_positioning_method", method)
        obj.base_seed = 77
    j.params.set_unpack_parameter("SNR")
    r.params.set_unpack_parameter("SNR")
    for p, jp in zip(r.params.get_unpacked_params_list()[:2],
                     j.params.get_unpacked_params_list()[:2]):
        assert p.unpack_index == jp.unpack_index
        for start, n in ((0, 5), (3, 1), (1000, 7)):
            np.testing.assert_array_equal(
                r._positions_for_attempts(p, start, n),
                j._positions_for_attempts(jp, start, n))
            for a, b in zip(r._scenario_pathloss(p, start, n),
                            j._scenario_pathloss(jp, start, n)):
                np.testing.assert_array_equal(a, b)
        assert r._transmit_power(20.0) == j._transmit_power(20.0)
    assert r.noise_var == j.noise_var
    assert r.metrics == j.metrics == METRICS


def test_bulk_chunks_are_invariant():
    r = runner()
    bulk = r._gen_bulk_kernel(point(r))
    whole, part = bulk(0, 8), bulk(4, 4)
    assert set(whole) == set(part)
    for name, v in whole.items():
        pairs = zip(v, part[name]) if isinstance(v, tuple) else \
            [(v, part[name])]
        for a, b in pairs:
            assert torch.equal(a[4:], b), name


def test_draws_follow_the_salt_layout():
    """The five draws of an attempt are the split streams' in the
    documented order, and the path loss only scales them."""
    r = runner()
    c = r._point(point(r))
    streams = AttemptStreams.from_range(c["seed"], 3, 2, "cpu")
    ones = (torch.ones(2, 3, 3), torch.ones(2, 3))
    d = draw_attempts(streams, *ones, 2, 2, 1, 10, 4, 0.01, 1e-3)
    kH, kE, kD, kX, kN = streams.split(5)
    assert torch.equal(d["data"], kD.integers(4, (3, 2, 10)))
    from pyphysim_tpu_torch.utils.misc import randn_c
    assert torch.equal(d["noise"],
                       randn_c(kN, 6, 10) * float(np.sqrt(1e-3)))
    assert torch.equal(d["H"][:, :2, 2:4], randn_c(kH, 3, 3, 2, 2)[:, 0, 1])
    spl = torch.full((2, 3, 3), 0.5)
    d2 = draw_attempts(streams, spl, ones[1], 2, 2, 1, 10, 4, 0.01, 1e-3)
    assert torch.equal(d2["H"], d["H"] * 0.5)
    with pytest.raises(ValueError, match="power of two"):
        draw_attempts(streams, *ones, 2, 2, 1, 10, 6, 0.01, 1e-3)


def test_host_engine_matches_the_bulk_engine_draw_for_draw():
    r = runner()
    p = point(r)
    out = r._gen_bulk_kernel(p)(1, 12)
    h = runner(engine="host")
    flips = 0
    for a in range(1, 13):
        h.serial_attempt = a
        res = h._run_simulation(p)
        assert bool(out["__valid__"][a - 1])
        for m in METRICS:
            ser = res[f"ser_{m}"][0]
            if ser._total != float(out[f"ser_{m}"][1][a - 1]):
                flips += 1
                assert m in ("capacity", "effec_throughput"), (a, m)
                continue
            assert ser._value == int(out[f"ser_{m}"][0][a - 1]), (a, m)
            assert res[f"ber_{m}"][0]._value == \
                int(out[f"ber_{m}"][0][a - 1]), (a, m)
            sinr = res[f"sinr_{m}"][0]
            assert sinr._total == float(out[f"sinr_{m}"][1][a - 1])
            assert sinr._value == pytest.approx(
                float(out[f"sinr_{m}"][0][a - 1]), rel=1e-3), (a, m)
    assert flips <= 1


def test_bench_stage_physics_at_a_pinned_seed():
    """bench.py's stage (metrics None / capacity / Whitening) at 256
    repetitions: the SERs inside bench.py's bands and the stream sacrifice
    strictly better than none."""
    r = runner(metrics=["None", "capacity", "Whitening"], reps=256,
               batch=128)
    r.simulate()
    sers = {m: float(r.results.get_result_values_list(f"ser_{m}")[0])
            for m in r.metrics}
    assert COMP_BD_SER_CAPACITY[0] < sers["capacity"] < \
        COMP_BD_SER_CAPACITY[1]
    assert COMP_BD_SER_NONE[0] < sers["None"] < COMP_BD_SER_NONE[1]
    assert sers["capacity"] < sers["None"]
    assert 0.0 < sers["Whitening"] < COMP_BD_SER_NONE[1]
    assert r.runned_reps == [256] and r.chunks_dispatched == 2


def test_nonsquare_config_runs_every_metric():
    r = runner(reps=16, batch=16, config=os.path.join(
        CONFIG_DIR, "bd_config_file_nonsquare.txt"))
    assert (r.params["Nr"], r.params["Nt"]) == (2, 3)
    r.simulate()
    for m in METRICS:
        ser = float(r.results.get_result_values_list(f"ser_{m}")[0])
        sinr = float(r.results.get_result_values_list(f"sinr_{m}")[0])
        assert 0.0 <= ser < 0.5 and np.isfinite(sinr) and sinr > 0, m


def test_bad_settings_raise():
    with pytest.raises(ValueError, match="engine"):
        BDSimulationRunner(read_command_line_args=False, engine="gpu",
                           device="cpu")
    with pytest.raises(ValueError, match="unknown metrics"):
        BDSimulationRunner(read_command_line_args=False, metrics=["bogus"],
                           device="cpu")
    r = runner()
    r.params.add("Nt", 1)
    with pytest.raises(ValueError, match="Nt >= Nr"):
        r._gen_bulk_kernel(point(r))
    r = runner()
    r.params.add("M", 6)
    with pytest.raises(ValueError, match="power of two"):
        r._gen_bulk_kernel(point(r))
    assert runner(engine="host")._gen_bulk_kernel(point(r)) is None
