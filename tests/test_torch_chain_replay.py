"""The chain step's two routes (``pyphysim_tpu_torch/chain.py``): on the
CPU the step launched op by op; on a CUDA device one replay of a captured
CUDA graph, whose draws read their seed and salts from device words and
whose ``forward`` reads the noise amplitude from a device scalar.

On the CPU: draws keyed by one-element device words expanded to the rows
(stride 0) equal the int-keyed draws; ``forward`` with the amplitude as a
float32 tensor equals the float-scalar arithmetic it replaced, bit for
bit; the CPU step is the eager one and returns tensors later calls leave
alone. The ``cuda``-marked tests hold the replayed counts to the eager
step's bit for bit across seeds, SNRs and attempt counts, and check the
graphs kept, the launch counters, the spans and the returned tensors."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu_torch import tracing  # noqa: E402
from pyphysim_tpu_torch.chain import GRAPHS_KEPT, ChainStep  # noqa: E402
from pyphysim_tpu_torch.ops import fir  # noqa: E402
from pyphysim_tpu_torch.ops.philox import philox4x32_10_int  # noqa: E402
from pyphysim_tpu_torch.ops.streams import (AttemptStreams,  # noqa: E402
                                            child_salts, pack_words,
                                            philox_draw)
from pyphysim_tpu_torch.utils.misc import (count_bit_errors,  # noqa: E402
                                           randn_c, round_bf16)

SNR = 10 ** 1.5
VARIANTS = {"per_sample": (False, False), "block_static": (True, False),
            "fused": (True, True)}
SIGNALS = {"complex64": None, "bfloat16": torch.bfloat16}


def _words(seed, salt, device="cpu"):
    """A seed and a salt as one-element int64 tensors (views of one
    buffer, as a captured step keeps them)."""
    buf = torch.tensor([seed, salt], dtype=torch.int64, device=device)
    return buf[0], buf[1]


@pytest.mark.parametrize("n", [1, 5, 32])
@pytest.mark.parametrize("kind", ["bits", "uniform", "normal", "integers"])
def test_device_word_keys_draw_what_int_keys_draw(kind, n):
    seed, salt = 0xDEADBEEF, 0x12345678
    attempts = torch.arange(2 ** 32 - 2, 2 ** 32 - 2 + n, dtype=torch.int64)
    by_int = AttemptStreams(seed, attempts, salt)
    w_seed, w_salt = _words(seed, salt)
    by_word = AttemptStreams(w_seed, attempts, w_salt)

    def draw(s):
        if kind == "integers":
            return s.integers(16, (3, 7))
        return getattr(s, kind)((3, 7))
    want, got = draw(by_int), draw(by_word)
    assert got.shape == (n, 3, 7) and got.dtype == want.dtype
    assert torch.equal(got, want)


def test_a_word_key_is_read_with_stride_zero():
    seed, salt = _words(7, 9)
    s = AttemptStreams(seed, torch.arange(4), salt)
    k0, k1 = s.seed.expand(4), s.salt.expand(4)
    n, _, packed = pack_words((k0, 0), (k1, 0), (s.attempts, 0),
                              (s.attempts, 32))
    assert n == 4 and [p[1] for p in packed[:2]] == [0, 0]
    assert packed[0][0].data_ptr() == seed.data_ptr()
    assert packed[1][0].data_ptr() == salt.data_ptr()
    # a write to the word re-keys the next draw
    before = s.bits(5)
    seed.fill_(8)
    assert torch.equal(s.bits(5), AttemptStreams(8, s.attempts, 9).bits(5))
    assert not torch.equal(s.bits(5), before)


def test_key_words_are_checked():
    a = torch.arange(3)
    with pytest.raises(ValueError, match="one int64"):
        AttemptStreams(torch.tensor([1, 2]), a)
    with pytest.raises(ValueError, match="one int64"):
        AttemptStreams(torch.tensor(1, dtype=torch.int32), a)
    s = AttemptStreams(torch.tensor(1), a)
    assert s.seed.shape == (1,) and s.salt == 0
    with pytest.raises(TypeError, match="host ints"):
        s.split(2)


def test_split_salts_are_the_cached_philox_words():
    seed, salt = 0x1234, 0x77
    base = philox4x32_10_int(salt, 0x5EED, 0, 0, seed, 0x57A17)[0]
    want = tuple((base + 0x9E3779B9 * (i + 1)) & 0xFFFFFFFF
                 for i in range(3))
    assert child_salts(seed, salt, 3) == want
    parts = AttemptStreams(seed, torch.arange(2), salt).split(3)
    assert tuple(p.salt for p in parts) == want
    assert all(p.seed == seed for p in parts)


def _scalar_forward(step, data, state, noise, snr_linear):
    """The chain's ``forward`` as it scaled the noise by a python float
    before the amplitude became a device tensor."""
    bf16 = step.signal_dtype is not None
    rnd = round_bf16 if bf16 else (lambda x: x)
    tx = rnd(step.qam.modulate(data))
    if step.fop is not None:
        rx, ir, _ = step.fop.corrupt_and_demodulate(state, tx)
        gain = step.fop.noise_gain
    else:
        sig = rnd(step.ofdm.modulate(tx))
        rx, ir, _ = step.channel.corrupt_data(state, sig,
                                              block_size=step.block_size)
        gain = 1.0
    if bf16:
        amp = float(round_bf16(torch.tensor(np.sqrt(
            np.float32(1.0) / np.float32(snr_linear)) * np.float32(gain))))
        rx = rnd(rnd(rx) + rnd(rnd(noise) * amp))
    else:
        rx = rx + noise * (math.sqrt(1.0 / float(snr_linear)) * gain)
    if step.fop is None:
        rx = rnd(step.ofdm.demodulate(rx[..., :sig.shape[-1]]))
    eq = step.equalizer.equalize_data(rx, ir)
    decided = step.qam.demodulate_hard(eq)
    return count_bit_errors(data, decided, axis=-1), eq, rx


@pytest.mark.parametrize("signal", sorted(SIGNALS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_with_a_tensor_amplitude_is_the_scalar_arithmetic(
        variant, signal):
    block_static, fused = VARIANTS[variant]
    step = ChainStep(300 * 2, 512, 52, 300, block_static=block_static,
                     fused=fused, signal_dtype=SIGNALS[signal], device="cpu")
    streams = AttemptStreams.from_range(31, 4, 6, "cpu")
    data, state, noise = step.draw(*streams.split(3))
    for snr in (0.5, SNR, 1e4):
        out = step.forward(data, state, noise, snr)
        want = _scalar_forward(step, data, state, noise, snr)
        for got, w in zip(out, want):
            assert torch.equal(got, w)
        amp = torch.tensor(step.noise_amplitude(snr), dtype=torch.float32)
        scaled = step.forward_scaled(data, state, noise, amp)
        assert all(torch.equal(a, b) for a, b in zip(scaled, out))


def test_noise_amplitude():
    step = ChainStep(600, 512, 52, 300, device="cpu")
    assert step.noise_amplitude(4.0) == 0.5
    fused = ChainStep(600, 512, 52, 300, block_static=True, fused=True,
                      device="cpu")
    assert fused.noise_amplitude(4.0) == 0.5 * fused.fop.noise_gain
    bf16 = ChainStep(600, 512, 52, 300, signal_dtype="bfloat16",
                     device="cpu")
    amp = bf16.noise_amplitude(SNR)
    assert amp == float(round_bf16(torch.tensor(amp)))
    assert abs(amp - SNR ** -0.5) < 2 ** -8 * SNR ** -0.5


def test_cpu_step_is_eager_and_its_counts_are_fresh():
    step = ChainStep(96 * 2, 128, 44, 96, block_static=True, device="cpu")
    first_streams = AttemptStreams.from_range(5, 0, 4, "cpu")
    first = step.step(first_streams, SNR)
    kept = first.clone()
    second = step.step(AttemptStreams.from_range(6, 0, 4, "cpu"), 2.0)
    assert not step._graphs
    assert torch.equal(first, kept)
    assert first.data_ptr() != second.data_ptr()
    assert torch.equal(step.step_eager(first_streams, SNR), kept)


# -- on the card ------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _counts(fn):
    """``fn()``'s fill and block_fir launches."""
    fills, firs = philox_draw.launch_count, fir.block_fir.launch_count
    fn()
    return (philox_draw.launch_count - fills,
            fir.block_fir.launch_count - firs)


@pytest.mark.cuda
@pytest.mark.parametrize("signal", sorted(SIGNALS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_replayed_counts_are_the_eager_counts(variant, signal):
    """Captured once an attempt count, then replayed across two seeds and
    two SNRs in turn: every replay's counts equal the eager step's on the
    same streams, so the buffers re-key."""
    _needs_card()
    block_static, fused = VARIANTS[variant]
    step = ChainStep(300 * 4, 512, 52, 300, block_static=block_static,
                     fused=fused, signal_dtype=SIGNALS[signal], device="cuda")
    for n in (32, 8, 256):
        step.step(AttemptStreams.from_range(1, 0, n, "cuda"), SNR)
        for seed in (2 ** 31 + 11, 12):
            for snr in (10 ** 0.5, 10 ** 2.5):
                for start in (0, 2 ** 32 - n // 2):
                    s = AttemptStreams.from_range(seed, start, n, "cuda")
                    got = step.step(s, snr)
                    want = step.step_eager(s, snr)
                    assert torch.equal(got, want), (n, seed, snr, start)
    assert len(step._graphs) == 3


@pytest.mark.cuda
def test_a_second_count_captures_once_and_the_first_keeps_replaying():
    _needs_card()
    step = ChainStep(1200, 512, 52, 300, block_static=True, device="cuda")
    s32 = AttemptStreams.from_range(3, 0, 32, "cuda")
    s8 = AttemptStreams.from_range(3, 32, 8, "cuda")
    step.step(s32, SNR)
    g32 = step._graphs[(32, s32.attempts.device)]
    step.step(s8, SNR)
    g8 = step._graphs[(8, s8.attempts.device)]
    for _ in range(3):
        assert torch.equal(step.step(s32, SNR), step.step_eager(s32, SNR))
        assert torch.equal(step.step(s8, SNR), step.step_eager(s8, SNR))
    assert list(step._graphs.values()) == [g32, g8]
    for k in range(GRAPHS_KEPT):
        step.step(AttemptStreams.from_range(3, 0, 40 + k, "cuda"), SNR)
    assert len(step._graphs) == GRAPHS_KEPT
    assert (32, s32.attempts.device) not in step._graphs


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_launch_counters_advance_per_replay_as_eagerly(variant):
    _needs_card()
    block_static, fused = VARIANTS[variant]
    step = ChainStep(1200, 512, 52, 300, block_static=block_static,
                     fused=fused, device="cuda")
    s = AttemptStreams.from_range(4, 0, 32, "cuda")
    eager = _counts(lambda: step.step_eager(s, SNR))
    assert eager[0] == 3 and eager[1] == int(block_static and not fused)
    assert _counts(lambda: step.step(s, SNR)) == eager     # the capture
    for _ in range(2):
        assert _counts(lambda: step.step(s, SNR)) == eager


@pytest.mark.cuda
def test_a_returned_tensor_survives_the_next_replay():
    _needs_card()
    step = ChainStep(1200, 512, 52, 300, block_static=True, device="cuda")
    s = AttemptStreams.from_range(5, 0, 32, "cuda")
    step.step(s, SNR)
    first = step.step(s, 2.0)
    kept = first.clone()
    later = [step.step(AttemptStreams.from_range(5, 32 * k, 32, "cuda"),
                       SNR) for k in range(1, 4)]
    torch.cuda.synchronize()
    assert torch.equal(first, kept)
    assert len({t.data_ptr() for t in [first] + later}) == 4


@pytest.mark.cuda
def test_a_replayed_step_records_its_spans():
    _needs_card()
    from torch.profiler import ProfilerActivity, profile
    step = ChainStep(1200, 512, 52, 300, block_static=True, device="cuda")
    s = AttemptStreams.from_range(6, 0, 32, "cuda")
    step.step(s, SNR)
    with profile(activities=[ProfilerActivity.CPU]):
        step.step(s, SNR)
        step.step(s, 2.0)
    recs = tracing.spans()
    names = [r.name for r in recs]
    assert names.count("chain.replay") == names.count("chain.forward") == 2
    assert names.count("chain.draw") == 2
    for r in recs:
        if r.name == "chain.replay":
            assert recs[r.parent].name == "chain.forward"


@pytest.mark.cuda
def test_a_stream_keyed_by_device_words_draws_on_the_card():
    _needs_card()
    seed, salt = _words(0xCAFE, 0xF00D, "cuda")
    a = torch.arange(2 ** 32 - 3, 2 ** 32 + 61, dtype=torch.int64,
                     device="cuda")
    by_word = AttemptStreams(seed, a, salt)
    by_int = AttemptStreams(0xCAFE, a, 0xF00D)
    for kind in ("bits", "uniform", "normal"):
        got = getattr(by_word, kind)((5, 33))
        want = getattr(by_int, kind)((5, 33))
        assert torch.equal(got, want), kind
    assert torch.equal(randn_c(by_word, 9), randn_c(by_int, 9))
