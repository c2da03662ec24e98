"""The flagship forward step: 16-QAM -> OFDM -> TDL (Jakes, COST259-TU) ->
AWGN -> one-tap equalizer -> hard demodulation -> bit-error count.

Counterpart of ``__graft_entry__._make_chain_step`` (the step that
``bench.py`` times as ``value_time_domain`` and ``value_xla_fused``), with
three variants: the per-sample time-domain channel, the block-static one
(the channel held over each OFDM symbol; its block convolution runs through
``channels.fading.BLOCK_CONV_IMPL``, the ``block_fir`` CUDA kernel by
default), and the fused path (``ops/fused_ofdm_tdl.py``, block-static).

It is split in two so that the tests can feed both packages the same
inputs:

  * :meth:`ChainStep.forward` is pure: batched data symbols, a Jakes
    state, unit-variance complex noise and the SNR in; per-attempt
    bit-error counts (and the receiver's intermediate values) out;
  * :meth:`ChainStep.step` draws those inputs from per-attempt streams
    (``ops/streams.py``) and returns the bit-error counts: the
    ``kernel(streams)`` of the runner's per-key path.

On a CUDA device ``step`` replays one captured CUDA graph of the whole
step (the three draws and ``forward``: ~50 launches, each of which the
host would otherwise issue in turn while the card waits): one graph for
each number of attempts, captured after the first call at that number
runs op by op (:meth:`ChainStep.step_eager`, which fills the caches the
capture needs: FFT plans, DFT matrices, the kernels' tables). The call's
attempts, its seed and salts (device words the fill kernel reads) and the
noise amplitude are written into the graph's buffers before each replay;
the counts come back as a fresh tensor. The graph holds the same
hand-written kernels and ops as the eager step, so the counts are the
same bit for bit. On the CPU ``step`` is ``step_eager``. The capture and
the replay serve any per-key step that has ``draw``, ``forward_scaled``
and ``noise_amplitude`` (:class:`ReplayedStep`): the MIMO-OFDM step of
``mimo_chain.py`` and the PUSCH step of ``pusch_chain.py`` replay the same
way.

``signal_dtype=torch.bfloat16`` is the reference's bf16 signal path, which
``bench.py`` times. Torch has no complex bf16 and ``torch.fft`` no bf16, so
the signal stays complex64 holding bf16 values: it is rounded to bf16
(``utils.misc.round_bf16``) wherever the JAX step's value is bf16 (the
symbols, the OFDM modulate and demodulate outputs, the channel output, the
noise, its amplitude, their product and the noisy sum; on the fused route
the output of ``corrupt_and_demodulate``), and computed in float32 in
between. The equalizer runs in float32 on those values, as the JAX step
promotes it. The noise is the float32 draw rounded: the JAX package's
moment correction of its bf16 sampler has no counterpart here.
"""

from __future__ import annotations

import contextlib
import math
from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._device import DeviceLike, require_cuda
from .channels import COST259_TUx, JakesSampleGenerator, TdlChannel
from .modulators import OFDM, QAM, OfdmOneTapEqualizer
from .ops.fir import block_fir
from .ops.fused_ofdm_tdl import FusedOfdmTdl
from .ops.mimo_detect import sc_decide
from .ops.qam import qam_map
from .ops.streams import AttemptStreams, philox_draw
from .tracing import span
from .utils.misc import randn_c, random_symbols, round_bf16

__all__ = ["ChainOutput", "ChainStep", "ReplayedStep"]

BANDWIDTH = 20e6       # Ts = 50 ns
DOPPLER_HZ = 30.0
JAKES_RAYS = 16
# captured steps a ReplayedStep keeps (one an attempt count and device),
# the least recently replayed dropped first
GRAPHS_KEPT = 8


def _signal_dtype(dtype) -> Optional[torch.dtype]:
    """None (complex64) or bfloat16, given as ``torch.bfloat16`` or its
    name."""
    if dtype is None:
        return None
    if dtype is torch.bfloat16 or dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"signal_dtype must be None, torch.bfloat16 or "
                     f"'bfloat16', got {dtype!r}")


class ChainOutput(NamedTuple):
    """Per-attempt results of one step (leading dimension = attempts)."""
    bit_errors: torch.Tensor   # (n,) int64
    equalized: torch.Tensor    # (n, num_symbols) complex64
    received: torch.Tensor     # (n, num_symbols) complex64, demodulated


class ReplayedStep:
    """:meth:`step` and :meth:`step_eager` of a per-key step: one call of
    ``n`` attempts draws its inputs from three sub-streams (``draw``) and
    runs ``forward_scaled`` on them, the noise scaled by
    ``noise_amplitude(snr_linear)``; on a CUDA device one replay of the
    step's graph at ``n`` attempts (the module docstring). A subclass
    calls ``ReplayedStep.__init__`` and defines ``draw``,
    ``forward_scaled``, ``noise_amplitude`` and ``forward``;
    ``counted_kernels`` are the kernel wrappers whose ``launch_count`` a
    replay advances as many times as the captured step launched each."""

    counted_kernels = (philox_draw, block_fir)

    def __init__(self) -> None:
        self._graphs: "OrderedDict[tuple, _StepGraph]" = OrderedDict()

    def step(self, streams, snr_linear: float) -> torch.Tensor:
        """(n,) bit-error counts of the attempts of ``streams`` (an
        ``AttemptStreams``): data, channel state and noise each from its
        own sub-stream, as the JAX step splits its key in three. On a
        CUDA device one replay of the step's graph at ``n`` attempts (the
        module docstring); a fresh tensor, which later calls leave
        alone."""
        dev = streams.attempts.device
        if dev.type != "cuda" or streams.n == 0:
            return self.step_eager(streams, snr_linear)
        key = (streams.n, dev)
        graph = self._graphs.get(key)
        if graph is None:
            out = self.step_eager(streams, snr_linear)
            self._graphs[key] = _StepGraph(self, streams.n, dev)
            if len(self._graphs) > GRAPHS_KEPT:
                # its last replay may still run: let it end before the
                # graph and its memory go
                torch.cuda.current_stream(dev).synchronize()
                self._graphs.popitem(last=False)
            return out
        self._graphs.move_to_end(key)
        with span("chain.draw"):
            graph.load(self, streams, snr_linear)
        with span("chain.forward"):
            with span("chain.replay"):
                graph.replay()
            return graph.bit_errors.clone()

    def step_eager(self, streams, snr_linear: float) -> torch.Tensor:
        """:meth:`step` launched op by op: the CPU's route, and the first
        call at each attempt count on a CUDA device."""
        with span("chain.draw"):
            data, state, noise = self.draw(*streams.split(3))
        with span("chain.forward"):
            return self.forward(data, state, noise, snr_linear).bit_errors


class ChainStep(ReplayedStep):
    """The flagship chain at one geometry. Arguments as
    ``_make_chain_step`` (``precision`` has no counterpart: the port's
    transforms are ``torch.fft`` in float32); ``signal_dtype`` is None
    (complex64) or bfloat16 (the module docstring says where it rounds),
    ``fused`` requires ``block_static``. On the card the symbol map
    (``ops/qam.py`` ``qam_map``) and the decision with its bit count
    (``ops/mimo_detect.py`` ``sc_decide``, with a unit gain) are one kernel
    launch each."""

    counted_kernels = ReplayedStep.counted_kernels + (qam_map, sc_decide)

    def __init__(self, num_symbols: int, fft_size: int, cp_size: int,
                 num_used: int, block_static: bool = False,
                 signal_dtype=None, fused: bool = False,
                 device: DeviceLike = "cuda") -> None:
        self.signal_dtype = _signal_dtype(signal_dtype)
        if fused and not block_static:
            raise ValueError("the fused path implies block-static evolution")
        if num_symbols % num_used != 0:
            raise ValueError("num_symbols must be a multiple of num_used")
        self.device = require_cuda(device)
        self.num_symbols = int(num_symbols)
        self.qam = QAM(16, device=self.device)
        self.ofdm = OFDM(fft_size, cp_size, num_used, device=self.device)
        self.jakes = JakesSampleGenerator(Fd=DOPPLER_HZ, Ts=1.0 / BANDWIDTH,
                                          L=JAKES_RAYS, device=self.device)
        self.channel = TdlChannel(self.jakes, COST259_TUx)
        self.block_size: Optional[int] = (
            self.ofdm.samples_per_symbol if block_static else None)
        self.equalizer = OfdmOneTapEqualizer(self.ofdm)
        self.fop = FusedOfdmTdl(self.ofdm, self.channel) if fused else None
        # (n, 1) float32 ones by (n, device): the decision's gain, by which
        # it divides exactly; made by the first, eager call at n, so a
        # capture only reads it
        self._unit_gain: dict = {}
        ReplayedStep.__init__(self)

    @property
    def noise_length(self) -> int:
        """Noise samples per attempt: post-demodulation (one per symbol)
        on the fused path, else the channel output's length."""
        if self.fop is not None:
            return self.num_symbols
        n_ofdm = self.num_symbols // self.ofdm.num_used_subcarriers
        return n_ofdm * self.ofdm.samples_per_symbol + \
            self.channel.num_taps_with_padding - 1

    def noise_amplitude(self, snr_linear: float) -> float:
        """What ``forward`` scales the unit noise by: ``sqrt(1 / snr)``,
        times ``noise_gain`` on the fused path; on the bf16 path the JAX
        step's amplitude, ``sqrt(1 / snr)`` in float32 times the gain,
        cast to bf16 (a python float holds it exactly)."""
        gain = self.fop.noise_gain if self.fop is not None else 1.0
        if self.signal_dtype is not None:
            return float(round_bf16(torch.tensor(np.sqrt(
                np.float32(1.0) / np.float32(snr_linear)) *
                np.float32(gain))))
        return math.sqrt(1.0 / float(snr_linear)) * gain

    def forward(self, data: torch.Tensor, channel_state, noise: torch.Tensor,
                snr_linear: float) -> ChainOutput:
        """``data`` (n, num_symbols) ints in [0, 16), ``channel_state`` a
        Jakes state with batch (n,), ``noise`` (n, noise_length) CN(0, 1)
        complex64 (scaled here by :meth:`noise_amplitude`)."""
        amp = torch.full((), self.noise_amplitude(snr_linear),
                         dtype=torch.float32, device=noise.device)
        return self.forward_scaled(data, channel_state, noise, amp)

    def forward_scaled(self, data: torch.Tensor, channel_state,
                       noise: torch.Tensor, amp: torch.Tensor) -> ChainOutput:
        """:meth:`forward` with the noise amplitude as a float32 0-dim
        tensor on the noise's device (:meth:`noise_amplitude`'s value),
        which a captured step reads from its buffer."""
        bf16 = self.signal_dtype is not None
        # identity on the complex64 path
        rnd = round_bf16 if bf16 else (lambda x: x)
        tx = rnd(self.qam.modulate(data))
        if self.fop is not None:
            rx, ir, _ = self.fop.corrupt_and_demodulate(channel_state, tx)
        else:
            sig = rnd(self.ofdm.modulate(tx))
            rx, ir, _ = self.channel.corrupt_data(
                channel_state, sig, block_size=self.block_size)
        if bf16:
            rx = rnd(rnd(rx) + rnd(rnd(noise) * amp))
        else:
            rx = rx + noise * amp
        if self.fop is None:
            rx = rnd(self.ofdm.demodulate(rx[..., :sig.shape[-1]]))
        eq = self.equalizer.equalize_data(rx, ir)
        key = (eq.shape[0], eq.device)
        if key not in self._unit_gain:
            self._unit_gain[key] = torch.ones(key[0], 1, device=eq.device)
        errors = sc_decide(eq[:, None], self._unit_gain[key], data[:, None],
                           self.qam.M)
        return ChainOutput(errors, eq, rx)

    def draw(self, s_data, s_channel, s_noise):
        """The inputs of ``forward`` from the step's three sub-streams:
        the data symbols, the channel state and the unit noise."""
        return (random_symbols(s_data, self.num_symbols, self.qam.K),
                self.channel.init_state(s_channel),
                randn_c(s_noise, self.noise_length))

    @property
    def bits_per_attempt(self) -> int:
        return self.num_symbols * self.qam.K


class _StepGraph:
    """One captured step of a :class:`ReplayedStep` at ``n`` attempts on
    one CUDA device: its ``draw`` and ``forward_scaled``, whatever they
    launch. What changes between calls lives in static device buffers,
    written before each replay and never baked into the capture: the
    attempts, the key words (the seed, then the data, channel and noise
    salts: each draw reads its seed and salt there, stride 0 over the
    rows) and the noise amplitude. The launch counters of the step's
    ``counted_kernels`` advance by what the capture counted at each
    replay. Raises if the capture fails."""

    def __init__(self, chain: ReplayedStep, n: int, device: torch.device):
        self.attempts = torch.zeros(n, dtype=torch.int64, device=device)
        self.words = torch.zeros(4, dtype=torch.int64, device=device)
        self.amp = torch.zeros((), dtype=torch.float32, device=device)
        self.written: Optional[Tuple] = None   # (seed, salt, snr)
        streams = [AttemptStreams(self.words[0], self.attempts,
                                  self.words[i]) for i in (1, 2, 3)]
        self.graph = torch.cuda.CUDAGraph()
        self.counted = chain.counted_kernels
        counted = [fn.launch_count for fn in self.counted]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(side):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.bit_errors = chain.forward_scaled(
                        *chain.draw(*streams), self.amp).bit_errors
                except BaseException:
                    with contextlib.suppress(Exception):
                        self.graph.capture_end()
                    raise
                self.graph.capture_end()
            torch.cuda.current_stream(device).wait_stream(side)
            # the capture launched nothing: what it counted, each replay
            # launches
            self.launches = [fn.launch_count - c
                             for fn, c in zip(self.counted, counted)]
        finally:
            for fn, c in zip(self.counted, counted):
                fn.launch_count = c

    def load(self, chain: ReplayedStep, streams, snr_linear: float) -> None:
        """Write the call's attempts, and its key words and amplitude
        where they differ from the last call's."""
        self.attempts.copy_(streams.attempts)
        written = (streams.seed, streams.salt, snr_linear)
        if written != self.written:
            words = [streams.seed] + [s.salt for s in streams.split(3)]
            for i, w in enumerate(words):
                self.words[i].fill_(w)
            self.amp.fill_(chain.noise_amplitude(snr_linear))
            self.written = written

    def replay(self) -> None:
        self.graph.replay()
        for fn, k in zip(self.counted, self.launches):
            fn.launch_count += k
