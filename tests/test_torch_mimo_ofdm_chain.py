"""The MIMO-OFDM per-key step (``pyphysim_tpu_torch/mimo_chain.py``) and
its detector (``ops/mimo_detect.py``), held to the benchmark's plain
float64 reference (``perfbench/reference/mimo_ofdm.py``), which imports
nothing of the port.

On the CPU, at a small OFDM (FFT 64, CP 16, 48 used, 4 OFDM symbols a
subframe, EVA at a 3.84 MHz sampling rate, whose span of 11 samples the
prefix covers): the step's counts equal the reference's at 2 x 2 and
4 x 4 on seeded streams; the detector's plain route against
``torch.linalg.solve`` in float64; zero forcing in place of MMSE fails the
comparison at 0 dB; the same attempts in one call and in two give the same
counts. The ``cuda``-marked tests hold, on the card, the replayed MIMO step
to its eager step bit for bit, the detector kernel to its plain route, and
``ChainStep``'s replay (whose capture the MIMO step now shares) to its
eager step and launch counters."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from apps.mimo.mimo_ofdm_tdl_torch import (EVA_DELAYS_S,  # noqa: E402
                                           EVA_POWERS_DB,
                                           MimoOfdmTdlSimulationRunner,
                                           eva_channel)
from perfbench.reference import mimo_ofdm  # noqa: E402
from pyphysim_tpu_torch import tracing  # noqa: E402
from pyphysim_tpu_torch.chain import ChainStep  # noqa: E402
from pyphysim_tpu_torch.mimo_chain import MimoChainStep  # noqa: E402
from pyphysim_tpu_torch.ops import fir  # noqa: E402
from pyphysim_tpu_torch.ops.mimo_detect import (mimo_mmse,  # noqa: E402
                                                mimo_mmse_reference)
from pyphysim_tpu_torch.ops.streams import (AttemptStreams,  # noqa: E402
                                            philox_draw)

FFT, CP, USED, NB = 64, 16, 48, 4
RATE = 3.84e6
SEED = 2 ** 31 + 4321
START = 2 ** 32 - 3      # the attempts cross 2**32


def _config(nt, nr):
    """The benchmark configuration's keys at the small OFDM."""
    return {"num_tx": nt, "num_rx": nr, "detector": "mmse",
            "modulation": {"name": "QAM", "M": 16},
            "ofdm": {"fft_size": FFT, "cp_size": CP, "num_used": USED},
            "bandwidth_hz": RATE, "doppler_hz": 70.0, "jakes_rays": 16,
            "channel": {"profile": "table", "name": "EVA",
                        "tap_powers_dB": EVA_POWERS_DB.tolist(),
                        "tap_delays_s": EVA_DELAYS_S.tolist()}}


def _step(nt, nr, device="cpu", **kw):
    return MimoChainStep(nt, nr, 16, USED * NB, FFT, CP, USED,
                         eva_channel(nr, nt, bandwidth_hz=RATE,
                                     device=device), device=device, **kw)


def _snr(db):
    return 10 ** (db / 10)


@pytest.mark.parametrize("nt,nr", [(2, 2), (4, 4)])
@pytest.mark.parametrize("snr_db", [0.0, 20.0, 40.0])
def test_step_counts_equal_the_reference(nt, nr, snr_db):
    """Tolerance: the port's CPU route computes in float32 and the
    reference in float64, so a decision within float32 rounding (~1e-7
    relative) of a slicer boundary could flip, moving one attempt's count
    by at most 4 bits; at these 16 attempts none does, and the check
    allows one such flip in all."""
    step = _step(nt, nr)
    streams = AttemptStreams.from_range(SEED, START, 16, "cpu")
    prog = step.step(streams, _snr(snr_db))
    ref = mimo_ofdm.perkey_counts(_config(nt, nr), USED * NB, SEED, snr_db,
                                  streams.attempts)
    assert prog.shape == (16,) and prog.dtype == torch.int64
    assert int((prog - ref).abs().sum()) <= 4, (prog.tolist(), ref.tolist())
    assert int(ref.sum()) > 0
    assert step.bits_per_attempt == nt * USED * NB * 4


def test_zero_forcing_fails_the_comparison_at_0_db():
    """The MMSE regulariser is what the reference holds the step to: the
    detector run on the step's own received values and channel with it
    dropped (zero forcing) moves the counts by far more than the tolerance
    above, while with it the detector gives the step's counts."""
    step = _step(4, 4)
    streams = AttemptStreams.from_range(SEED, START, 16, "cpu")
    ref = mimo_ofdm.perkey_counts(_config(4, 4), USED * NB, SEED, 0.0,
                                  streams.attempts)
    data, state, noise = step.draw(*streams.split(3))
    out = step.forward(data, state, noise, 1.0)
    s2 = torch.tensor((USED + CP) / FFT)
    mmse = mimo_mmse(out.response, out.received, data, s2)
    zf = mimo_mmse(out.response, out.received, data, s2 * 0)
    assert torch.equal(mmse, out.bit_errors)
    assert int((mmse - ref).abs().sum()) <= 4
    assert int((zf - ref).abs().sum()) > 0.05 * int(ref.sum())


def test_the_same_attempts_in_one_call_and_in_two():
    step = _step(2, 2)
    whole = step.step(AttemptStreams.from_range(SEED, 100, 12, "cpu"), 10.0)
    parts = torch.cat([
        step.step(AttemptStreams.from_range(SEED, 100, 5, "cpu"), 10.0),
        step.step(AttemptStreams.from_range(SEED, 105, 7, "cpu"), 10.0)])
    assert torch.equal(whole, parts)


def _detection_case(nt, nr, n, S, snr, seed):
    """Random Rayleigh H, sent 16-QAM layers with Blast's split, y = H x
    + n, in the detector's layout."""
    from pyphysim_tpu_torch.modulators import QAM
    g = torch.Generator().manual_seed(seed)

    def cn(*shape):
        return torch.complex(torch.randn(shape, generator=g),
                             torch.randn(shape, generator=g)) * math.sqrt(.5)
    h = cn(n, nr, nt, S)
    sent = torch.randint(0, 16, (n, nt, S), generator=g)
    x = QAM(16, device="cpu").modulate(sent) / math.sqrt(nt)
    y = torch.einsum("nrts,nts->nrs", h, x) + cn(n, nr, S) / math.sqrt(snr)
    return h, y, sent


@pytest.mark.parametrize("nt,nr", [(2, 2), (4, 4), (2, 4), (3, 2)])
def test_detector_plain_route_against_a_float64_solve(nt, nr):
    """The plain route's float32 LDL^H against Blast's filter by
    ``torch.linalg.solve`` in float64, on the same decisions. Tolerance:
    float32 rounding moves an estimate by ~1e-7 relative, more on an
    ill-conditioned H (its condition number times that), so a few of
    the 12,288 decisions near a boundary may flip: at most 0.1 % of the
    bits, 4 bits a flip."""
    from pyphysim_tpu_torch.modulators import QAM
    n, S, snr = 4, 768, 100.0
    h, y, sent = _detection_case(nt, nr, n, S, snr, seed=nt * 10 + nr)
    s2 = (USED + CP) / (FFT * snr)
    got = mimo_mmse(h, y, sent, torch.tensor(s2, dtype=torch.float32))
    hm = h.permute(0, 3, 1, 2).to(torch.complex128)       # (n, S, Nr, Nt)
    hh = hm.mH
    eye = torch.eye(nt, dtype=torch.complex128)
    est = torch.linalg.solve(hh @ hm + s2 * eye,
                             hh @ y.permute(0, 2, 1)[..., None]
                             .to(torch.complex128))[..., 0] * math.sqrt(nt)
    decided = QAM(16, device="cpu").demodulate_hard(est)   # (n, S, Nt)
    bits = (decided ^ sent.permute(0, 2, 1)).to(torch.int64)
    want = sum(((bits >> k) & 1).sum(dim=(1, 2)) for k in range(4))
    assert int(want.sum()) > 0
    assert int((got - want).abs().sum()) <= max(4, 0.001 * n * S * nt * 4)


def test_detector_rejects_what_it_cannot_take():
    h, y, sent = _detection_case(2, 2, 1, 8, 10.0, seed=1)
    s2 = torch.tensor(0.1)
    with pytest.raises(ValueError, match="do not match"):
        mimo_mmse(h, y[:, :1], sent, s2)
    with pytest.raises(ValueError, match="square QAM"):
        mimo_mmse(h, y, sent, s2, M=8)
    h3, y3, sent3 = _detection_case(3, 3, 1, 8, 10.0, seed=1)
    with pytest.raises(ValueError, match="one of"):
        mimo_mmse(h3, y3, sent3, s2)
    with pytest.raises(ValueError, match="one device"):
        mimo_mmse(h, y, sent, torch.tensor([0.1]))
    with pytest.raises(ValueError, match="antennas"):
        MimoChainStep(2, 2, 16, USED, FFT, CP, USED,
                      eva_channel(2, 4, bandwidth_hz=RATE, device="cpu"),
                      device="cpu")


def test_the_plain_route_counts_its_calls():
    h, y, sent = _detection_case(2, 2, 2, 16, 10.0, seed=2)
    before = (mimo_mmse.reference_count, mimo_mmse.launch_count)
    assert torch.equal(mimo_mmse(h, y, sent, torch.tensor(0.1)),
                       mimo_mmse_reference(h, y, sent, torch.tensor(0.1)))
    assert (mimo_mmse.reference_count - before[0],
            mimo_mmse.launch_count - before[1]) == (2, 0)


def test_response_at_chosen_bins_is_the_full_response_there():
    step = _step(2, 2)
    streams = AttemptStreams.from_range(SEED, 0, 3, "cpu")
    state = step.channel.init_state(streams)
    ir, _ = step.channel._block_response(state, NB * (FFT + CP), FFT + CP)
    bins = step.ofdm.get_used_subcarrier_indexes() % FFT
    assert torch.allclose(ir.get_freq_response(FFT, bins=bins),
                          ir.get_freq_response(FFT)[..., bins],
                          rtol=1e-5, atol=1e-6)


def test_eager_step_records_the_channel_and_detect_spans():
    """The eager step's channel and detection are recorded inside its one
    ``chain.forward``, after its one ``chain.draw``: no span of their
    own."""
    from torch.profiler import ProfilerActivity, profile
    step = _step(2, 2)
    streams = AttemptStreams.from_range(SEED, 0, 2, "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        step.step(streams, 10.0)
    assert [r.name for r in tracing.spans()] == ["chain.draw",
                                                 "chain.forward"]


def test_the_app_runner_sweeps_through_the_step():
    runner = MimoOfdmTdlSimulationRunner(device="cpu",
                                         read_command_line_args=False)
    assert (runner.chain.num_tx, runner.chain.num_rx,
            runner.chain.bits_per_attempt) == (4, 4, 268800)
    runner = MimoOfdmTdlSimulationRunner(device="cpu",
                                         read_command_line_args=False,
                                         chain=_step(2, 2))
    runner.params.add("SNR", np.array([0.0, 30.0]))
    runner.rep_max, runner.batch_size = 8, 8
    runner.batch_stop_criterion = None
    runner.update_progress_function_style = None
    runner.simulate()
    errors = runner.results.get_result_values_list("bit_errors")
    assert list(runner.runned_reps) == [8, 8]
    assert errors[0] > errors[1]
    assert runner.chunks_dispatched == 2


# -- on the card ------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _launches(fn):
    """``fn()``'s fill, block_fir and mimo_mmse launches."""
    counters = (philox_draw, fir.block_fir, mimo_mmse)
    before = [c.launch_count for c in counters]
    fn()
    return tuple(c.launch_count - b for c, b in zip(counters, before))


def _full_step(**kw):
    return MimoChainStep(4, 4, 16, 1200 * 14, 2048, 144, 1200,
                         eva_channel(4, 4, device="cuda"), device="cuda",
                         **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("signal", [None, torch.bfloat16])
def test_replayed_mimo_step_is_the_eager_step(signal):
    """4 x 4 at LTE 20 MHz: captured once an attempt count, replayed
    across seeds, SNRs and attempts across 2**32; bit for bit the eager
    step's counts (the same kernels and ops in the same order)."""
    _needs_card()
    step = _full_step(signal_dtype=signal)
    for n in (32, 8):
        step.step(AttemptStreams.from_range(1, 0, n, "cuda"), 10.0)
        for seed in (2 ** 31 + 11, 12):
            for snr_db in (0.0, 30.0):
                s = AttemptStreams.from_range(seed, 2 ** 32 - n // 2, n,
                                              "cuda")
                got = step.step(s, _snr(snr_db))
                assert torch.equal(got, step.step_eager(s, _snr(snr_db)))
    assert len(step._graphs) == 2


@pytest.mark.cuda
def test_mimo_launch_counters_advance_per_replay_as_eagerly():
    _needs_card()
    step = _full_step()
    s = AttemptStreams.from_range(4, 0, 32, "cuda")
    eager = _launches(lambda: step.step_eager(s, 10.0))
    assert eager == (3, 1, 1)
    for _ in range(3):             # the capture, then two replays
        assert _launches(lambda: step.step(s, 10.0)) == eager


@pytest.mark.cuda
@pytest.mark.parametrize("nt,nr", [(4, 4), (2, 2), (2, 4), (3, 2)])
def test_detector_kernel_is_its_plain_route(nt, nr):
    """Bit for bit: the two round the same float32 operations in the same
    order (the kernel contracts no multiply-add)."""
    _needs_card()
    n, S = 8, 16800
    h, y, sent = _detection_case(nt, nr, n, S, 1000.0, seed=nt + 7 * nr)
    s2 = torch.tensor((1200 + 144) / (2048 * 1000.0))
    want = mimo_mmse_reference(h, y, sent, s2)
    before = mimo_mmse.launch_count
    got = mimo_mmse(h.cuda(), y.cuda(), sent.cuda(), s2.cuda()).cpu()
    assert mimo_mmse.launch_count == before + 1
    assert int(want.sum()) > 0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_chain_step_replay_is_unchanged_by_the_shared_capture():
    """``ChainStep`` replays through the capture it now shares with the
    MIMO step: its counts equal its eager step's bit for bit, and a
    replay advances the fill and block_fir counters as eagerly and
    the detector's not at all."""
    _needs_card()
    step = ChainStep(9600, 512, 52, 300, block_static=True, device="cuda")
    s = AttemptStreams.from_range(5, 0, 32, "cuda")
    eager = _launches(lambda: step.step_eager(s, 10.0))
    assert eager == (3, 1, 0)
    for _ in range(3):
        assert _launches(lambda: step.step(s, 10.0)) == eager
    for seed in (2 ** 31 + 3, 77):
        s = AttemptStreams.from_range(seed, 2 ** 32 - 16, 32, "cuda")
        assert torch.equal(step.step(s, 10.0), step.step_eager(s, 10.0))
