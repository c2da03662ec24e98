"""The 4-layer PUSCH per-key step (``pyphysim_tpu_torch/pusch_chain.py``),
its layered DMRS estimator, its SC-FDMA equalizer and its decision
(``ops/mimo_detect.py`` ``sc_mmse_eq``, ``sc_decide``), held to the
benchmark's plain float64 reference (``perfbench/reference/pusch.py``),
which imports nothing of the port.

On the CPU, at a small subframe (FFT 128, CP 9, 72 used subcarriers, a
Zadoff-Chu root of length 71, 2 layers x 2 antennas, a 3-tap profile at
1.92 MHz whose span the prefix covers): the step's estimate, equalized
symbols and counts against the reference at 0 and 20 dB; the bf16 signal
path fails those tolerances; the transform precoding is the orthonormal
DFT of TS 36.211 §5.3.3 and comes back through the chain; the cyclic
shifts and cover codes separate the layers' pilots; the plain equalizer
against a float64 solve; the decision against ``QAM.demodulate_hard``;
the same attempts in one call and in two; the step through the app
runner. The ``cuda``-marked tests hold, on the card, the replayed step to
its eager step bit for bit and the two kernels to their plain versions."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from apps.mimo.mimo_ofdm_tdl_torch import \
    MimoOfdmTdlSimulationRunner  # noqa: E402
from apps.mimo.pusch_etu70_torch import (COVER_CODES,  # noqa: E402
                                         CYCLIC_SHIFTS, pusch_step)
from perfbench.reference import pusch  # noqa: E402
from pyphysim_tpu_torch.channels import (JakesSampleGenerator,  # noqa: E402
                                         TdlChannel, TdlChannelProfile)
from pyphysim_tpu_torch.modulators import QAM  # noqa: E402
from pyphysim_tpu_torch.ops import fir  # noqa: E402
from pyphysim_tpu_torch.ops.mimo_detect import (  # noqa: E402
    sc_decide, sc_decide_reference, sc_mmse_eq, sc_mmse_eq_reference)
from pyphysim_tpu_torch.ops.streams import (AttemptStreams,  # noqa: E402
                                            philox_draw)
from pyphysim_tpu_torch.pusch_chain import PuschChainStep  # noqa: E402
from pyphysim_tpu_torch.reference_signals import (  # noqa: E402
    CazacBasedWithOCCChannelEstimator, DmrsUeSequence,
    LayeredOCCChannelEstimator, RootSequence)

FFT, CP, USED = 128, 9, 72
RATE = 15e3 * FFT
DELAYS_S, POWERS_DB = [0.0, 5e-7, 1.6e-6], [0.0, -1.0, -3.0]
KEEP = 8
SEED = 2 ** 31 + 4321
START = 2 ** 32 - 3      # the attempts cross 2**32


def _config(nt=2, nr=2, shifts=(0, 6), covers=((1, 1), (1, 1)),
            doppler=70.0, delays=DELAYS_S, powers=POWERS_DB):
    """The benchmark configuration's keys at the small subframe."""
    return {"num_tx": nt, "num_rx": nr, "detector": "mmse",
            "modulation": {"name": "QAM", "M": 16},
            "ofdm": {"fft_size": FFT, "cp_size": CP, "num_used": USED,
                     "symbols_per_subframe": 14},
            "bandwidth_hz": RATE, "doppler_hz": doppler, "jakes_rays": 16,
            "channel": {"profile": "table", "name": "short",
                        "tap_powers_dB": list(powers),
                        "tap_delays_s": list(delays)},
            "dmrs": {"root_index": 25, "symbols": [3, 10],
                     "cyclic_shifts": list(shifts),
                     "cover_codes": [list(c) for c in covers],
                     "taps_to_keep": KEEP}}


def _step(cfg, device="cpu", **kw):
    jakes = JakesSampleGenerator(Fd=cfg["doppler_hz"], Ts=1.0 / RATE, L=16,
                                 device=device)
    ch = cfg["channel"]
    channel = TdlChannel(jakes, TdlChannelProfile(
        np.array(ch["tap_powers_dB"]), np.array(ch["tap_delays_s"]), "x"))
    channel.set_num_antennas(cfg["num_rx"], cfg["num_tx"])
    d = cfg["dmrs"]
    return PuschChainStep(cfg["num_tx"], cfg["num_rx"], 16, 12 * USED, FFT,
                          CP, USED, channel, d["root_index"],
                          d["cyclic_shifts"], d["cover_codes"],
                          taps_to_keep=d["taps_to_keep"], device=device, **kw)


def _snr(db):
    return 10 ** (db / 10)


def _rel(got, want):
    """The largest gap over the largest value of the float64 reference."""
    want = want.to(torch.complex128)
    return float((got.to(torch.complex128) - want).abs().max() /
                 want.abs().max())


# Tolerances of the step against the float64 reference, relative to the
# reference's largest value. The estimate: a few float32 FFTs of 72
# points and the OFDM's of 128 round to ~1e-7 relative each (2.7e-7 seen),
# so 1e-5. The equalized W y: the solve multiplies the rounding of H and y
# by the condition number of H^H H + s2 I, which the regulariser bounds by
# ~(|H|^2 + s2) / s2: ~1e2 at 20 dB on these channels (6.5e-6 seen), so
# 1e-4. The counts: float32 rounding can move a decision at a slicer
# boundary, 4 bits a flip; the cell's limits hold the share.
EST_TOL, EQ_TOL = 1e-5, 1e-4


def _limits():
    from perfbench.harness import cells
    return cells.workload("etu4x4.pusch")["limits"]


def _compare(step, cfg, snr_db, n=8):
    streams = AttemptStreams.from_range(SEED, START, n, "cpu")
    data, state, noise = step.draw(*streams.split(3))
    out = step.forward(data, state, noise, _snr(snr_db))
    ref = pusch.subframes(cfg, 12 * USED, SEED, snr_db, streams.attempts)
    return out, ref


@pytest.mark.parametrize("snr_db", [0.0, 20.0])
def test_step_equals_the_reference(snr_db):
    cfg = _config()
    step = _step(cfg)
    out, ref = _compare(step, cfg, snr_db)
    assert out.estimate.shape == (8, 2, 2, USED)
    assert out.equalized.shape == (8, 2, 12, USED)
    assert _rel(out.estimate, ref["estimate"]) <= EST_TOL
    assert _rel(out.equalized, ref["equalized"]) <= EQ_TOL
    gap = (out.bit_errors - ref["bit_errors"]).abs()
    limits = _limits()
    assert int(gap.sum()) <= limits["count_gap_share"] * 8 * \
        step.bits_per_attempt + limits["count_gap_max"]
    assert int(gap.max()) <= limits["count_gap_max"]
    assert int(ref["bit_errors"].sum()) > 0
    assert step.bits_per_attempt == 2 * 12 * USED * 4


def test_bf16_signal_fails_the_tolerances():
    """The bf16 signal path rounds the transmitted and received symbols
    to 8 bits of mantissa (~4e-3 relative): the estimate's tolerance
    above catches it."""
    cfg = _config()
    out, ref = _compare(_step(cfg, signal_dtype=torch.bfloat16), cfg, 20.0)
    assert _rel(out.estimate, ref["estimate"]) > EST_TOL
    assert _rel(out.equalized, ref["equalized"]) > EQ_TOL


def test_transform_precoding_is_the_orthonormal_dft():
    """TS 36.211 §5.3.3's z(k) = sum_i x(i) exp(-2 pi j i k / M) /
    sqrt(M) is ``torch.fft.fft(norm="ortho")``, and the receiver's
    ``ifft(norm="ortho")`` undoes it, at the small and the full
    allocation."""
    g = torch.Generator().manual_seed(3)
    for M in (USED, 1200):
        x = torch.complex(torch.randn(4, M, generator=g, dtype=torch.float64),
                          torch.randn(4, M, generator=g, dtype=torch.float64))
        i = torch.arange(M, dtype=torch.float64)
        dft = torch.polar(torch.ones(M, M, dtype=torch.float64),
                          -2 * math.pi * torch.outer(i, i) / M) / math.sqrt(M)
        z = torch.fft.fft(x, norm="ortho")
        assert torch.allclose(z, x @ dft.T, atol=1e-10)
        assert torch.allclose(torch.fft.ifft(z, norm="ortho"), x, atol=1e-12)


def test_the_chain_gives_back_the_sent_symbols():
    """A static flat channel at 80 dB: the de-spread symbols are the sent
    16-QAM points (the spreading, the pilots' positions, the estimate and
    the equalizer line up; the MMSE gain is 1 to ~1e-8 there)."""
    cfg = _config(doppler=0.0, delays=[0.0], powers=[0.0])
    step = _step(cfg)
    streams = AttemptStreams.from_range(SEED, 0, 4, "cpu")
    data, state, noise = step.draw(*streams.split(3))
    out = step.forward(data, state, noise, _snr(80.0))
    sent = step.qam.modulate(data).reshape(4, 2, 12, USED)
    assert float((out.symbols - sent).abs().max()) < 1e-3
    assert int(out.bit_errors.sum()) == 0


def _pilots(nt, shifts, covers, size=USED):
    root = RootSequence(25, size)
    return [DmrsUeSequence(root, c, np.array(cc))
            for c, cc in zip(shifts, covers)]


def test_cyclic_shifts_and_cover_codes_separate_the_layers():
    """Four layers' pilots on the same subcarriers and symbols, through
    a noiseless flat channel: each layer's estimate is its own channel,
    the others' pilots removed by the cyclic shift (0, 6, 3, 9: delays
    a quarter of the allocation apart, outside the kept 0..8) or by the
    cover code (layers 0, 1 against 2, 3)."""
    seqs = _pilots(4, CYCLIC_SHIFTS, COVER_CODES)
    g = torch.Generator().manual_seed(11)
    h = torch.complex(torch.randn(3, 4, 4, generator=g),
                      torch.randn(3, 4, 4, generator=g)).numpy()
    # received (batch, Nr, slots, K): sum over layers of h[:, r, l] w s
    sent = np.stack([s.seq_array() for s in seqs])        # (L, slots, K)
    rx = np.einsum("brl,lsk->brsk", h, sent)
    est = LayeredOCCChannelEstimator(seqs)
    for got in (est.estimate_channel_freq_domain(rx, KEEP),
                est.estimate_channel_freq_domain(
                    torch.as_tensor(rx.astype(np.complex64)), KEEP).numpy()):
        assert got.shape == (3, 4, 4, USED)
        np.testing.assert_allclose(got, np.broadcast_to(
            h[..., None], got.shape), atol=1e-5)


def test_the_layered_estimator_is_the_per_layer_estimators():
    """One call over the layers equals each layer's
    ``CazacBasedWithOCCChannelEstimator``: numpy bit for bit, tensors
    within float32 rounding; the step's estimate is this estimator's on
    the step's pilot symbols."""
    seqs = _pilots(4, CYCLIC_SHIFTS, COVER_CODES)
    rng = np.random.default_rng(5)
    rx = (rng.standard_normal((3, 2, 2, USED)) +
          1j * rng.standard_normal((3, 2, 2, USED))).astype(np.complex64)
    est = LayeredOCCChannelEstimator(seqs)
    assert est.num_layers == 4 and est.cover_codes.shape == (4, 2)
    got = est.estimate_channel_freq_domain(rx, KEEP)
    got_t = est.estimate_channel_freq_domain(torch.as_tensor(rx), KEEP)
    for layer, seq in enumerate(seqs):
        one = CazacBasedWithOCCChannelEstimator(seq)
        np.testing.assert_array_equal(
            got[..., layer, :], one.estimate_channel_freq_domain(rx, KEEP))
        want_t = one.estimate_channel_freq_domain(torch.as_tensor(rx), KEEP)
        assert torch.allclose(got_t[..., layer, :], want_t, atol=1e-6)
    with pytest.raises(ValueError, match="share"):
        LayeredOCCChannelEstimator([seqs[0], DmrsUeSequence(
            RootSequence(25, 36), 0, np.array([1, 1]))])


def test_the_tensor_route_keeps_its_constants_on_the_device():
    """The conjugate sequences and cover codes are made once a device:
    a second call reuses the same tensors (what a graph capture needs)."""
    est = LayeredOCCChannelEstimator(_pilots(2, (0, 6), ((1, 1), (1, 1))))
    rx = torch.zeros(1, 2, USED, dtype=torch.complex64)
    est.estimate_channel_freq_domain(rx, KEEP)
    made = dict(est._constants._made)
    est.estimate_channel_freq_domain(rx, KEEP)
    assert len(made) == 2 and all(
        est._constants._made[k] is v for k, v in made.items())


def _equalizer_case(nt, nr, n, K, ns, snr, seed):
    g = torch.Generator().manual_seed(seed)

    def cn(*shape):
        return torch.complex(torch.randn(shape, generator=g),
                             torch.randn(shape, generator=g)) * math.sqrt(.5)
    return cn(n, nr, nt, K), cn(n, nr, ns, K), \
        torch.tensor(1.0 / snr, dtype=torch.float32)


@pytest.mark.parametrize("nt,nr", [(2, 2), (4, 4)])
def test_equalizer_plain_route_against_a_float64_solve(nt, nr):
    """W = (H^H H + s2 I)^-1 H^H by ``torch.linalg.solve`` in float64:
    x = W y on the data symbols and the gains Re (W H)_tt. Tolerance:
    float32 rounding times the regularised system's condition number,
    at most ~(|H|^2 + s2) / s2 = ~1e3 at this SNR: 1e-3 of the largest
    value."""
    n, K, ns = 3, 96, 5
    data = (0, 2, 3)
    h, y, s2 = _equalizer_case(nt, nr, n, K, ns, 100.0, nt * 7 + nr)
    x, gain = sc_mmse_eq(h, y, s2, data)
    assert x.shape == (n, nt, 3, K) and gain.shape == (n, nt, K)
    hk = h.permute(0, 3, 1, 2).to(torch.complex128)        # (n, K, Nr, Nt)
    eye = torch.eye(nt, dtype=torch.complex128)
    w = torch.linalg.solve(hk.mH @ hk + float(s2) * eye, hk.mH)
    want_g = torch.diagonal(w @ hk, dim1=-2, dim2=-1).real.permute(0, 2, 1)
    yd = y[:, :, list(data)].permute(0, 3, 1, 2).to(torch.complex128)
    want_x = (w @ yd).permute(0, 2, 3, 1)
    assert _rel(x, want_x) < 1e-3
    assert float((gain.double() - want_g).abs().max()) < 1e-4


def test_equalizer_rejects_what_it_cannot_take():
    h, y, s2 = _equalizer_case(2, 2, 1, 8, 4, 10.0, seed=1)
    with pytest.raises(ValueError, match="does not match"):
        sc_mmse_eq(h, y[:, :1], s2, (0, 1))
    with pytest.raises(ValueError, match="increase"):
        sc_mmse_eq(h, y, s2, (1, 0))
    with pytest.raises(ValueError, match="increase"):
        sc_mmse_eq(h, y, s2, (0, 4))
    h3, y3, _ = _equalizer_case(3, 3, 1, 8, 4, 10.0, seed=1)
    with pytest.raises(ValueError, match="one of"):
        sc_mmse_eq(h3, y3, s2, (0,))
    with pytest.raises(ValueError, match="one device"):
        sc_mmse_eq(h, y, torch.tensor([0.1]), (0,))
    with pytest.raises(ValueError, match="data REs"):
        cfg = _config()
        _step(cfg).__class__(2, 2, 16, 14 * USED, FFT, CP, USED,
                             _step(cfg).channel, 25, (0, 6),
                             ((1, 1), (1, 1)), device="cpu")


def test_the_decision_is_the_qam_slicer_on_the_unbiased_symbols():
    """``sc_decide`` counts what ``QAM.demodulate_hard`` and
    ``count_bit_errors`` count on the symbols divided by their layer's
    mean gain, bit for bit; its plain route counts its calls."""
    from pyphysim_tpu_torch.utils.misc import count_bit_errors
    g = torch.Generator().manual_seed(9)
    n, nt, S = 3, 4, 600
    symbols = torch.complex(torch.randn(n, nt, 2, 300, generator=g),
                            torch.randn(n, nt, 2, 300, generator=g))
    mu = torch.rand(n, nt, generator=g) * 0.5 + 0.5
    sent = torch.randint(0, 16, (n, nt, S), generator=g)
    before = sc_decide.reference_count
    got = sc_decide(symbols, mu, sent)
    assert sc_decide.reference_count == before + 1
    unbiased = symbols.reshape(n, nt, S) / mu[..., None]
    want = count_bit_errors(sent, QAM(16, device="cpu").demodulate_hard(
        unbiased), axis=(1, 2))
    assert torch.equal(got, want) and int(want.sum()) > 0
    with pytest.raises(ValueError, match="do not match"):
        sc_decide(symbols, mu[:, :2], sent)
    with pytest.raises(ValueError, match="square QAM"):
        sc_decide(symbols, mu, sent, M=8)


def test_the_plain_route_counts_its_calls():
    h, y, s2 = _equalizer_case(2, 2, 2, 16, 3, 10.0, seed=2)
    before = (sc_mmse_eq.reference_count, sc_mmse_eq.launch_count)
    a = sc_mmse_eq(h, y, s2, (0, 2))
    b = sc_mmse_eq_reference(h, y, s2, (0, 2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (sc_mmse_eq.reference_count - before[0],
            sc_mmse_eq.launch_count - before[1]) == (2, 0)


def test_the_same_attempts_in_one_call_and_in_two():
    step = _step(_config())
    whole = step.step(AttemptStreams.from_range(SEED, 100, 12, "cpu"), 10.0)
    parts = torch.cat([
        step.step(AttemptStreams.from_range(SEED, 100, 5, "cpu"), 10.0),
        step.step(AttemptStreams.from_range(SEED, 105, 7, "cpu"), 10.0)])
    assert torch.equal(whole, parts)


def test_the_app_runner_sweeps_through_the_step():
    step = pusch_step("cpu")
    assert (step.num_tx, step.num_rx, step.bits_per_attempt,
            step.noise_length) == (4, 4, 230400, 14 * 2192 + 154)
    assert step.data_symbols == (0, 1, 2, 4, 5, 6, 7, 8, 9, 11, 12, 13)
    runner = MimoOfdmTdlSimulationRunner(device="cpu",
                                         read_command_line_args=False,
                                         chain=_step(_config()))
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
    counters = (philox_draw, fir.block_fir, sc_mmse_eq, sc_decide)
    before = [c.launch_count for c in counters]
    fn()
    return tuple(c.launch_count - b for c, b in zip(counters, before))


@pytest.mark.cuda
@pytest.mark.parametrize("signal", [None, torch.bfloat16])
def test_replayed_pusch_step_is_the_eager_step(signal):
    """4 x 4 at 20 MHz: captured once an attempt count, replayed across
    seeds, SNRs and attempts across 2**32; bit for bit the eager step's
    counts (the same kernels and ops in the same order), with the
    launches of the eager step a replay: the fill 3 times, block_fir, the
    equalizer and the decision once each."""
    _needs_card()
    step = pusch_step("cuda", signal_dtype=signal)
    for n in (32, 8):
        step.step(AttemptStreams.from_range(1, 0, n, "cuda"), 10.0)
        for seed in (2 ** 31 + 11, 12):
            for snr_db in (0.0, 30.0):
                s = AttemptStreams.from_range(seed, 2 ** 32 - n // 2, n,
                                              "cuda")
                got = step.step(s, _snr(snr_db))
                assert torch.equal(got, step.step_eager(s, _snr(snr_db)))
    assert len(step._graphs) == 2
    s = AttemptStreams.from_range(4, 0, 32, "cuda")
    assert _launches(lambda: step.step(s, 10.0)) == \
        _launches(lambda: step.step_eager(s, 10.0)) == (3, 1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("nt,nr", [(4, 4), (2, 2)])
def test_equalizer_kernel_is_its_plain_route(nt, nr):
    """Bit for bit: the two round the same float32 operations in the
    same order (the kernel contracts no multiply-add)."""
    _needs_card()
    n, K, ns = 8, 1200, 14
    data = (0, 1, 2, 4, 5, 6, 7, 8, 9, 11, 12, 13)
    h, y, s2 = _equalizer_case(nt, nr, n, K, ns, 1000.0, seed=nt + 7 * nr)
    want = sc_mmse_eq_reference(h, y, s2, data)
    before = sc_mmse_eq.launch_count
    got = sc_mmse_eq(h.cuda(), y.cuda(), s2.cuda(), data)
    assert sc_mmse_eq.launch_count == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_decision_kernel_is_its_plain_route():
    """Bit for bit: the same float32 division and slicer."""
    _needs_card()
    g = torch.Generator().manual_seed(13)
    n, nt, S = 32, 4, 14400
    symbols = torch.complex(torch.randn(n, nt, S, generator=g),
                            torch.randn(n, nt, S, generator=g))
    mu = torch.rand(n, nt, generator=g) * 0.5 + 0.5
    sent = torch.randint(0, 16, (n, nt, S), generator=g)
    want = sc_decide_reference(symbols, mu, sent)
    before = sc_decide.launch_count
    got = sc_decide(symbols.cuda(), mu.cuda(), sent.cuda()).cpu()
    assert sc_decide.launch_count == before + 1
    assert torch.equal(got, want) and int(want.sum()) > 0
