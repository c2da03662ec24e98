"""Fused OFDM-over-TDL path (block-static SISO).

Counterpart of ``pyphysim_tpu/ops/fused_ofdm_tdl.py`` ``FusedOfdmTdl``:
the chain ``IDFT -> +CP -> block convolution -> overlap-add -> strip CP ->
DFT`` collapses to ``(data @ M) x H @ N`` in ``mode="spectrum"`` and, one
step further, to a per-bin product with the channel's frequency response
in ``mode="diag"``. Both are exact when ``cp_size >= span - 1`` (the
convolution tail of a symbol lands inside the next symbol's cyclic prefix,
which the receiver discards) and the circular length covers
``samples_per_symbol + span - 1``.

``M`` (used, L) maps data bins to the convolution spectrum of the
CP-prefixed symbol; ``N`` (L, used) maps the product spectrum to the
demodulated used bins. Both are built in float64 on the host and cached as
complex64 per device. The products are plain ``torch.matmul``, as the JAX
package left them to XLA; callers comparing on the card turn TF32 off.

Noise: the receiver's rows are orthogonal with norm
``sqrt(fft_size / power_scale)`` (:attr:`FusedOfdmTdl.noise_gain`), so
time-domain AWGN of std ``sigma`` is exactly AWGN of std
``sigma * noise_gain`` added to the fused output.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .sparse_dft import sparse_dft

__all__ = ["FusedOfdmTdl"]


class FusedOfdmTdl:
    """Precomputed fused transforms for one (OFDM, TdlChannel) pair;
    ``mode`` is ``"diag"`` (the default, one (T, used) product per
    symbol) or ``"spectrum"`` (the explicit matrix pair, for
    cross-checks)."""

    def __init__(self, ofdm, channel, mode: str = "diag") -> None:
        if mode not in ("diag", "spectrum"):
            raise ValueError(f"unknown fused mode {mode!r}")
        self._ofdm = ofdm
        self._channel = channel
        self._mode = mode
        self._tap_idx = channel.channel_profile.tap_delays.astype(int)
        self._span = int(self._tap_idx[-1]) + 1
        if ofdm.cp_size < self._span - 1:
            raise ValueError(
                "Fused OFDM-TDL path requires cp_size >= channel span - 1 "
                f"({ofdm.cp_size} < {self._span - 1}): with a shorter CP "
                "the convolution tail leaks into retained samples and the "
                "time-domain chain must be used")
        spb = ofdm.samples_per_symbol
        self._L = ((spb + self._span - 1 + 127) // 128) * 128
        self._cache: dict = {}

    @property
    def mode(self) -> str:
        return self._mode

    def _matrices(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(M, N) as complex64 on ``device``, built once in float64."""
        key = ("MN", torch.device(device))
        if key not in self._cache:
            o, L = self._ofdm, self._L
            n, cp = o.fft_size, o.cp_size
            spb = o.samples_per_symbol
            bins = o.get_used_subcarrier_indexes() % n
            ps = o._calculate_power_scale()
            t = np.arange(spb)
            # TX: data bin -> sample t of the CP-prefixed symbol (IDFT
            # index (t - cp) mod n) -> convolution spectrum at L bins
            idft = np.exp(2j * np.pi / n * np.outer(bins, (t - cp) % n)) \
                * (math.sqrt(ps) / n)                       # (used, spb)
            f_conv = np.exp(-2j * np.pi / L * np.outer(t, np.arange(L)))
            M = idft @ f_conv                               # (used, L)
            # RX: convolution spectrum -> retained samples cp .. spb - 1
            # -> demodulated used bins
            m = np.arange(n)
            ifft = np.exp(2j * np.pi / L *
                          np.outer(np.arange(L), cp + m)) / L  # (L, n)
            dft = np.exp(-2j * np.pi / n * np.outer(m, bins)) \
                / math.sqrt(ps)                             # (n, used)
            N = ifft @ dft                                  # (L, used)
            self._cache[key] = tuple(
                torch.tensor(a.astype(np.complex64), device=device)
                for a in (M, N))
        return self._cache[key]

    @property
    def noise_gain(self) -> float:
        """Std multiplier making post-fusion AWGN exactly equivalent to
        time-domain AWGN: the row norm of the receiver transform."""
        o = self._ofdm
        return math.sqrt(o.fft_size / o._calculate_power_scale())

    def corrupt_and_demodulate(self, state, data: torch.Tensor):
        """``data``: ``batch + (n_sym * num_used,)`` modulated symbols.
        Returns ``(rx_data, ir_block, new_state)``: ``rx_data`` (same
        shape) is the NOISELESS demodulated receiver data (add noise
        scaled by :attr:`noise_gain`, then equalize with ``ir_block``)."""
        o = self._ofdm
        used = o.num_used_subcarriers
        batch = data.shape[:-1]
        n_sym = data.shape[-1] // used
        x = data.to(torch.complex64).reshape(batch + (n_sym, used))
        ir_block, state = self._channel._generate_strided_impulse_response(
            state, n_sym, stride=o.samples_per_symbol)
        taps_t = ir_block.tap_values_sparse.transpose(-1, -2)  # (.., nb, T)
        if self._mode == "diag":
            w = sparse_dft(self._tap_idx, o.get_used_subcarrier_indexes() %
                           o.fft_size, o.fft_size, x.device)   # (T, used)
            rx = x * (taps_t @ w)
        else:
            M, N = self._matrices(x.device)
            H = taps_t @ sparse_dft(self._tap_idx, range(self._L), self._L,
                                    x.device)                  # (.., nb, L)
            rx = ((x @ M) * H) @ N
        return rx.reshape(batch + (n_sym * used,)), ir_block, state
