"""The plain reference against the port's CPU routes on the same seeds at
a tiny size, and the engine's replay against the runner."""

import numpy as np
import pytest
import torch

from perfbench.harness import cells
from perfbench.reference import engine, flagship
from perfbench.reference.profiles import raw_profile


def _mc(cfg, tile):
    from pyphysim_tpu_torch.channels import (JakesSampleGenerator,
                                             TdlChannel, TdlChannelProfile)
    from pyphysim_tpu_torch.modulators import OFDM
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl
    p, d = raw_profile(cfg["channel"])
    jakes = JakesSampleGenerator(Fd=cfg["doppler_hz"],
                                 Ts=1 / cfg["bandwidth_hz"],
                                 L=cfg["jakes_rays"], device="cpu")
    return MonteCarloOfdmTdl(OFDM(512, 52, 300, device="cpu"),
                             TdlChannel(jakes, TdlChannelProfile(p, d)),
                             M=16, tile=tile, device="cpu")


@pytest.mark.parametrize("config", ["ofdm16qam_cost259tu",
                                    "ofdm16qam_exp250ns"])
@pytest.mark.parametrize("snr_db", [0.0, 20.0])
def test_bulk_reference_equals_the_ports_cpu_route(config, snr_db):
    cfg = cells.config(config)
    mc = _mc(cfg, 16)
    seed, start = 1234567, 2 ** 32 + 3
    prog = mc.prng_reference(3, 2, seed, mc.amp(10 ** (snr_db / 10)), start)
    ref = flagship.bulk_counts(cfg, 16, 2, seed, snr_db, start, 3, "cpu")
    assert prog.sum(1).tolist() == ref.tolist()
    assert ref.sum() > 0


@pytest.mark.parametrize("snr_db", [0.0, 10.0, 20.0])
def test_perkey_reference_equals_the_ports_cpu_route(snr_db):
    from pyphysim_tpu_torch.chain import ChainStep
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    cfg = cells.config("ofdm16qam_cost259tu")
    chain = ChainStep(1200, 512, 52, 300, block_static=True, device="cpu")
    streams = AttemptStreams.from_range(987654, 2 ** 32 - 2, 5, "cpu")
    prog = chain.step(streams, 10 ** (snr_db / 10))
    ref = flagship.perkey_counts(cfg, 1200, 987654, snr_db,
                                 streams.attempts)
    assert prog.tolist() == ref.tolist()


def test_reference_geometry_matches_the_programs_profile():
    from pyphysim_tpu_torch.channels import COST259_TUx
    geo = flagship.Geometry.from_config(cells.config("ofdm16qam_cost259tu"))
    prof = COST259_TUx.get_discretize_profile(1 / 20e6)
    assert geo.delays.tolist() == prof.tap_delays.astype(int).tolist()
    np.testing.assert_allclose(geo.powers, prof.tap_powers_linear,
                               rtol=1e-12)
    exp = flagship.Geometry.from_config(cells.config("ofdm16qam_exp250ns"))
    assert (exp.taps, exp.rays) == (51, 32)


def test_kernel_stream_seed_is_the_runners():
    from pyphysim_tpu_torch.simulations import kernel_stream_seed
    for base, u in [(0, 0), (2 ** 31 - 1, 6), (123456789, 3)]:
        assert engine.kernel_stream_seed(base, u) == \
            kernel_stream_seed(base, u)


@pytest.mark.parametrize("cell", ["tu.bulk", "tu.perkey"])
def test_engine_replay_agrees_with_the_runner(cell):
    from perfbench.tests.tiny import run_tiny
    res = run_tiny(cell)
    assert res["compare"]["engine_faults"]["value"] == 0
    assert res["compare"]["count_gap_max"]["value"] == 0
    assert res["correct"]


def test_engine_replay_catches_a_wrong_stop():
    counts = np.full(32, 400)
    calls = [(0, 32, counts)]        # 12,800 errors: the point ends
    ok = engine.replay_bulk(calls, 4096, 32, 10000, 8)
    assert ok["ok"] and ok["reps"] == 32 and ok["bit_errors"] == 12800
    late = engine.replay_bulk(calls + [(32, 32, counts)], 4096, 32, 10000, 8)
    assert not late["ok"]
    early = engine.replay_bulk([(0, 32, np.full(32, 10))], 4096, 32, 10000, 8)
    assert not early["ok"]


def test_engine_replay_without_a_stop_rule():
    """No stop rule: whole chunks until rep_max, the last one's surplus
    not accepted; a missing or an extra call is a mismatch."""
    counts = np.full(32, 400)
    calls = [(0, 32, counts), (32, 32, counts), (64, 32, counts)]
    ok = engine.replay_bulk(calls, 70, 32, None, 8)
    assert ok["ok"] and ok["reps"] == 70 and ok["bit_errors"] == 400 * 70
    assert not engine.replay_bulk(calls[:2], 70, 32, None, 8)["ok"]
    assert not engine.replay_bulk(calls + [(96, 32, counts)], 70, 32, None,
                                  8)["ok"]
    keyed = [(0, 32, counts), (32, 32, counts), (64, 6, counts[:6])]
    ok = engine.replay_perkey(keyed, 70, 32, None, 8)
    assert ok["ok"] and ok["reps"] == 70
    assert not engine.replay_perkey(keyed[:2], 70, 32, None, 8)["ok"]
