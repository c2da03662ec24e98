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

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ._device import DeviceLike, require_cuda
from .channels import COST259_TUx, JakesSampleGenerator, TdlChannel
from .modulators import OFDM, QAM, OfdmOneTapEqualizer
from .ops.fused_ofdm_tdl import FusedOfdmTdl
from .tracing import span
from .utils.misc import (count_bit_errors, randn_c, random_symbols,
                         round_bf16)

__all__ = ["ChainOutput", "ChainStep"]

BANDWIDTH = 20e6       # Ts = 50 ns
DOPPLER_HZ = 30.0
JAKES_RAYS = 16


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


class ChainStep:
    """The flagship chain at one geometry. Arguments as
    ``_make_chain_step`` (``precision`` has no counterpart: the port's
    transforms are ``torch.fft`` in float32); ``signal_dtype`` is None
    (complex64) or bfloat16 (the module docstring says where it rounds),
    ``fused`` requires ``block_static``."""

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

    @property
    def noise_length(self) -> int:
        """Noise samples per attempt: post-demodulation (one per symbol)
        on the fused path, else the channel output's length."""
        if self.fop is not None:
            return self.num_symbols
        n_ofdm = self.num_symbols // self.ofdm.num_used_subcarriers
        return n_ofdm * self.ofdm.samples_per_symbol + \
            self.channel.num_taps_with_padding - 1

    def forward(self, data: torch.Tensor, channel_state, noise: torch.Tensor,
                snr_linear: float) -> ChainOutput:
        """``data`` (n, num_symbols) ints in [0, 16), ``channel_state`` a
        Jakes state with batch (n,), ``noise`` (n, noise_length) CN(0, 1)
        complex64 (scaled here: by ``sqrt(1 / snr)`` in the time domain,
        times ``noise_gain`` on the fused path)."""
        bf16 = self.signal_dtype is not None
        # identity on the complex64 path
        rnd = round_bf16 if bf16 else (lambda x: x)
        tx = rnd(self.qam.modulate(data))
        if self.fop is not None:
            rx, ir, _ = self.fop.corrupt_and_demodulate(channel_state, tx)
            gain = self.fop.noise_gain
        else:
            sig = rnd(self.ofdm.modulate(tx))
            rx, ir, _ = self.channel.corrupt_data(
                channel_state, sig, block_size=self.block_size)
            gain = 1.0
        if bf16:
            # the JAX step's amplitude: sqrt(1 / snr) in float32, times
            # the gain, cast to bf16 (a python float holds it exactly)
            amp = float(round_bf16(torch.tensor(np.sqrt(
                np.float32(1.0) / np.float32(snr_linear)) * np.float32(gain))))
            rx = rnd(rnd(rx) + rnd(rnd(noise) * amp))
        else:
            rx = rx + noise * (math.sqrt(1.0 / float(snr_linear)) * gain)
        if self.fop is None:
            rx = rnd(self.ofdm.demodulate(rx[..., :sig.shape[-1]]))
        eq = self.equalizer.equalize_data(rx, ir)
        decided = self.qam.demodulate_hard(eq)
        return ChainOutput(count_bit_errors(data, decided, axis=-1), eq, rx)

    def step(self, streams, snr_linear: float) -> torch.Tensor:
        """(n,) bit-error counts of the attempts of ``streams`` (an
        ``AttemptStreams``): data, channel state and noise each from its
        own sub-stream, as the JAX step splits its key in three."""
        with span("chain.draw"):
            s_data, s_channel, s_noise = streams.split(3)
            data = random_symbols(s_data, self.num_symbols, self.qam.K)
            state = self.channel.init_state(s_channel)
            noise = randn_c(s_noise, self.noise_length)
        with span("chain.forward"):
            return self.forward(data, state, noise, snr_linear).bit_errors

    @property
    def bits_per_attempt(self) -> int:
        return self.num_symbols * self.qam.K
