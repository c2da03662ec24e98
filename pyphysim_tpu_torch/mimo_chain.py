"""The MIMO-OFDM per-key step: Nt layers of QAM, spatially multiplexed
(``mimo.Blast``) -> per-antenna OFDM -> Nr x Nt TDL (Jakes, the channel
held over each OFDM symbol) -> AWGN on each receive antenna -> per-antenna
OFDM demodulation -> per-resource-element MMSE detection with perfect CSI
-> hard decisions -> bit-error count.

The step has :class:`~pyphysim_tpu_torch.chain.ChainStep`'s contract:
:meth:`MimoChainStep.draw` takes the inputs from three sub-streams (data,
channel state, noise, in that order, so attempt ``a``'s counts depend only
on (seed, unpack index, a)), :meth:`MimoChainStep.forward` /
:meth:`MimoChainStep.forward_scaled` are pure, and ``step`` /
``step_eager`` come from :class:`~pyphysim_tpu_torch.chain.ReplayedStep`:
on a CUDA device each call after the first at an attempt count is one
replay of the step's captured CUDA graph.

Per attempt, with ``S = num_symbols`` resource elements (REs) a layer:

  * ``data`` (Nt, S) indices in [0, M) from the data sub-stream, layer t's
    symbols in row t; QAM, then Blast's 1/sqrt(Nt) split;
  * OFDM modulation of each transmit antenna's row
    (``modulators/ofdm.py``: IFFT scaled by ``sqrt(fft^2 / (used +
    cp))``, cyclic prefix);
  * the Nr x Nt block-static channel from the channel sub-stream (one
    Jakes state a link and tap, evaluated once an OFDM symbol, so the
    state advances by a symbol's samples each symbol) through
    ``block_fir``'s MIMO route (``tdl_filter_block_fft_mimo``: one launch
    over the Nr x Nt links, then a sum over the transmit antennas);
  * time-domain noise CN(0, 1 / SNR) on each receive antenna, from the
    noise sub-stream;
  * OFDM demodulation of each receive antenna (FFT divided by the same
    scale) and the per-RE channel ``H[r, t]`` on the used subcarriers
    (``TdlImpulseResponse.get_freq_response`` at those bins), the
    receiver's perfect CSI;
  * ``ops/mimo_detect.py`` :func:`mimo_mmse`: per RE Blast's MMSE filter
    ``(H^H H + s2 I)^-1 H^H`` times sqrt(Nt), QAM hard decisions, and the
    bit errors against ``data``, summed over the attempt's REs and layers.

The MMSE regulariser ``s2`` is the noise variance on one subcarrier after
demodulation, in H's units. Where the cyclic prefix covers the channel's
span, subcarrier k of receive antenna r is ``Y_r[k] = sum_t H_rt[k] X_t[k]
+ N_r[k]``, ``X_t = s_t / sqrt(Nt)``; the FFT of ``fft`` samples of
variance ``1 / SNR`` has variance ``fft / SNR``, and the division by
``sqrt(fft^2 / (used + cp))`` leaves ``s2 = (used + cp) / (fft * SNR)``.

``signal_dtype=torch.bfloat16`` is the bf16 signal path, rounded at
``ChainStep``'s points: the symbols after the split, the OFDM modulate and
demodulate outputs, the channel output, the noise, its scaled value and
the noisy sum; the channel response and the detector stay float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ._device import DeviceLike, require_cuda
from .chain import ReplayedStep, _signal_dtype
from .channels import TdlChannel
from .channels.fading import tdl_filter_block_fft_mimo
from .modulators import OFDM, QAM
from .ops.mimo_detect import mimo_mmse
from .utils.misc import randn_c, random_symbols, round_bf16

__all__ = ["MimoChainOutput", "MimoChainStep"]


class MimoChainOutput(NamedTuple):
    """Per-attempt results of one step (leading dimension = attempts)."""
    bit_errors: torch.Tensor   # (n,) int64, summed over layers and REs
    received: torch.Tensor     # (n, Nr, S) complex64, demodulated
    response: torch.Tensor     # (n, Nr, Nt, S) complex64, per-RE channel


class MimoChainStep(ReplayedStep):
    """``num_tx`` layers of ``M``-QAM over ``num_tx`` x ``num_rx``
    antennas, ``num_symbols`` REs a layer (a whole number of OFDM symbols
    of ``num_used`` subcarriers), through ``channel``: a
    :class:`~pyphysim_tpu_torch.channels.TdlChannel` on a Jakes generator,
    made MIMO with ``set_num_antennas(num_rx, num_tx)``. ``signal_dtype``
    is None (complex64) or bfloat16 (the module docstring)."""

    def __init__(self, num_tx: int, num_rx: int, M: int, num_symbols: int,
                 fft_size: int, cp_size: int, num_used: int,
                 channel: TdlChannel, signal_dtype=None,
                 device: DeviceLike = "cuda") -> None:
        self.device = require_cuda(device)
        self.signal_dtype = _signal_dtype(signal_dtype)
        if not channel.mimo or (channel.num_rx_antennas,
                                channel.num_tx_antennas) != (num_rx, num_tx):
            raise ValueError(f"the channel must be set to {num_rx} x "
                             f"{num_tx} antennas (set_num_antennas)")
        if channel.switched_direction:
            raise ValueError("the step sends from the Nt side")
        if num_symbols % num_used != 0:
            raise ValueError("num_symbols must be a multiple of num_used")
        self.num_tx, self.num_rx = int(num_tx), int(num_rx)
        self.num_symbols = int(num_symbols)
        self.qam = QAM(M, device=self.device)
        self.ofdm = OFDM(fft_size, cp_size, num_used, device=self.device)
        self.channel = channel
        self.block_size = self.ofdm.samples_per_symbol
        self._bins = self.ofdm.get_used_subcarrier_indexes() % fft_size
        # Blast's power split, and s2 over 1 / SNR (the module docstring)
        self._split = 1.0 / math.sqrt(self.num_tx)
        self._var_scale = (num_used + cp_size) / fft_size
        ReplayedStep.__init__(self)

    @property
    def num_ofdm_symbols(self) -> int:
        return self.num_symbols // self.ofdm.num_used_subcarriers

    @property
    def noise_length(self) -> int:
        """Noise samples per attempt and receive antenna: the channel
        output's length."""
        return self.num_ofdm_symbols * self.block_size + \
            self.channel.num_taps_with_padding - 1

    def noise_amplitude(self, snr_linear: float) -> float:
        """What ``forward`` scales the unit noise by: ``sqrt(1 / snr)``;
        on the bf16 path ``sqrt(1 / snr)`` in float32 cast to bf16."""
        if self.signal_dtype is not None:
            return float(round_bf16(torch.tensor(np.sqrt(
                np.float32(1.0) / np.float32(snr_linear)))))
        return math.sqrt(1.0 / float(snr_linear))

    def forward(self, data: torch.Tensor, channel_state, noise: torch.Tensor,
                snr_linear: float) -> MimoChainOutput:
        """``data`` (n, Nt, num_symbols) ints in [0, M), ``channel_state``
        a Jakes state with batch (n,) and shape (T, Nr, Nt), ``noise``
        (n, Nr, noise_length) CN(0, 1) complex64 (scaled here by
        :meth:`noise_amplitude`)."""
        amp = torch.full((), self.noise_amplitude(snr_linear),
                         dtype=torch.float32, device=noise.device)
        return self.forward_scaled(data, channel_state, noise, amp)

    def forward_scaled(self, data: torch.Tensor, channel_state,
                       noise: torch.Tensor,
                       amp: torch.Tensor) -> MimoChainOutput:
        """:meth:`forward` with the noise amplitude as a float32 0-dim
        tensor on the noise's device, which a captured step reads from its
        buffer."""
        bf16 = self.signal_dtype is not None
        rnd = round_bf16 if bf16 else (lambda x: x)
        n, nr, nt = data.shape[0], self.num_rx, self.num_tx
        tx = rnd(self.qam.modulate(data) * self._split)     # (n, Nt, S)
        sig = rnd(self.ofdm.modulate(tx))                   # (n, Nt, N)
        length = sig.shape[-1]
        ir, _ = self.channel._block_response(channel_state, length,
                                             self.block_size)
        rx = tdl_filter_block_fft_mimo(ir, sig, self.block_size)
        h = ir.get_freq_response(self.ofdm.fft_size, bins=self._bins)
        if bf16:
            rx = rnd(rnd(rx) + rnd(rnd(noise) * amp))
        else:
            rx = rx + noise * amp
        rx = rnd(self.ofdm.demodulate(rx[..., :length]))    # (n, Nr, S)
        h = h.reshape(n, nr, nt, self.num_symbols)
        errors = mimo_mmse(h, rx, data, amp * amp * self._var_scale,
                           self.qam.M)
        return MimoChainOutput(errors, rx, h)

    def draw(self, s_data, s_channel, s_noise):
        """The inputs of ``forward`` from the step's three sub-streams:
        the layers' symbols, the channel state and the unit noise."""
        data = random_symbols(s_data, self.num_tx * self.num_symbols,
                              self.qam.K)
        return (data.reshape(-1, self.num_tx, self.num_symbols),
                self.channel.init_state(s_channel),
                randn_c(s_noise, self.num_rx, self.noise_length))

    @property
    def bits_per_attempt(self) -> int:
        return self.num_tx * self.num_symbols * self.qam.K
