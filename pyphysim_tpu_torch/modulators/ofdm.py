"""OFDM modulation/demodulation on ``torch.fft`` in complex64, and the
one-tap equalizer.

Counterpart of ``OFDM`` and ``OfdmOneTapEqualizer`` of
``pyphysim_tpu/modulators/ofdm.py``. ``OFDM`` has:
  * the same subcarrier mapping (used subcarriers centered on the spectrum,
    DC skipped, guard bands at the edges; data order is the
    negative-frequency bins first, then the positive ones),
  * the power scale ``fft_size^2 / (num_used + cp)`` applied at the IFFT,
  * cyclic prefix add/remove.

Inputs of shape (..., n) process each leading index as an independent
stream. The JAX package computes the transform as a pruned matmul-DFT on
real pairs; here it is ``torch.fft`` on complex64, which gives the same
values to float32 rounding.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, require_cuda
from ..ops.sparse_dft import sparse_dft

__all__ = ["OFDM", "OfdmOneTapEqualizer"]


class OFDM:
    """OFDM modulator: subcarrier mapping + IFFT + cyclic prefix."""

    def __init__(self, fft_size: int, cp_size: int,
                 num_used_subcarriers: Optional[int] = None,
                 device: DeviceLike = "cuda") -> None:
        self.device = require_cuda(device)
        self.set_parameters(fft_size, cp_size, num_used_subcarriers)

    def set_parameters(self, fft_size: int, cp_size: int,
                       num_used_subcarriers: Optional[int] = None) -> None:
        """(Re)set the OFDM parameters, validating them."""
        if num_used_subcarriers is None:
            num_used_subcarriers = fft_size
        if num_used_subcarriers > fft_size:
            raise ValueError(
                "Number of used subcarriers cannot be greater than the "
                "OFDM fft_size")
        if num_used_subcarriers % 2 != 0 or num_used_subcarriers < 2:
            raise ValueError("Number of used subcarriers must be a "
                             "multiple of 2")
        if cp_size < 0 or cp_size > fft_size:
            raise ValueError(
                "cp_size must be nonnegative and at most equal to fft_size")
        self.fft_size = int(fft_size)
        self.cp_size = int(cp_size)
        self.num_used_subcarriers = int(num_used_subcarriers)
        self._used_idx = torch.as_tensor(self.get_used_subcarrier_indexes(),
                                         device=self.device)

    # -- layout helpers ----------------------------------------------------

    def _get_used_subcarrier_numbers(self) -> np.ndarray:
        """Used subcarrier 'numbers': positive then negative frequencies,
        DC (0) never used."""
        half = self.num_used_subcarriers // 2
        return np.hstack([np.arange(1, half + 1), np.arange(-half, 0)])

    def get_used_subcarrier_indexes(self) -> np.ndarray:
        """Used subcarrier FFT-bin indexes in the order data is mapped:
        negative-frequency bins (fft_size - half .. fft_size - 1) first,
        then positive bins (1 .. half)."""
        numbers = self._get_used_subcarrier_numbers()
        half = self.num_used_subcarriers // 2
        return np.hstack([self.fft_size + numbers[half:], numbers[:half]])

    def _calc_zeropad(self, input_data_size: int):
        """(zeropad, num_ofdm_symbols) for a given payload size."""
        used = self.num_used_subcarriers
        num_symbols = (input_data_size + used - 1) // used
        return num_symbols * used - input_data_size, num_symbols

    def _calculate_power_scale(self) -> float:
        return (float(self.fft_size) ** 2 /
                (float(self.num_used_subcarriers) + self.cp_size))

    @property
    def samples_per_symbol(self) -> int:
        """Output samples per OFDM symbol (fft_size + cp)."""
        return self.fft_size + self.cp_size

    # -- modulate / demodulate --------------------------------------------

    def modulate(self, input_signal: torch.Tensor) -> torch.Tensor:
        """OFDM-modulate a stream of complex data symbols.

        Input shape (..., n), zero-padded to a multiple of
        ``num_used_subcarriers``. Output shape
        (..., n_ofdm_symbols * (fft_size + cp_size)), complex64.
        """
        x = torch.as_tensor(input_signal).to(self.device, torch.complex64)
        pad, n_sym = self._calc_zeropad(x.shape[-1])
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        batch = x.shape[:-1]
        x = x.reshape(batch + (n_sym, self.num_used_subcarriers))
        # index_add, not assignment: with num_used == fft_size the map hits
        # bin fft_size/2 twice, and the JAX matmul-DFT sums both symbols
        spectrum = x.new_zeros(batch + (n_sym, self.fft_size))
        spectrum.index_add_(-1, self._used_idx, x)
        td = torch.fft.ifft(spectrum) * math.sqrt(
            self._calculate_power_scale())
        if self.cp_size:
            td = torch.cat([td[..., -self.cp_size:], td], dim=-1)
        return td.reshape(batch + (n_sym * self.samples_per_symbol,))

    def demodulate(self, received_signal: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`modulate` (CP strip -> FFT -> unmap).

        Input length must be a multiple of ``fft_size + cp_size``; any
        zero-padding added by modulate is NOT removed.
        """
        y = torch.as_tensor(received_signal).to(self.device, torch.complex64)
        spb = self.samples_per_symbol
        batch = y.shape[:-1]
        n_sym = y.shape[-1] // spb
        y = y[..., :n_sym * spb].reshape(batch + (n_sym, spb))
        freq = torch.fft.fft(y[..., self.cp_size:]) / math.sqrt(
            self._calculate_power_scale())
        data = freq[..., self._used_idx]
        return data.reshape(batch + (n_sym * self.num_used_subcarriers,))


class OfdmOneTapEqualizer:
    """Per-subcarrier division by the channel's mean frequency response
    over each OFDM symbol: the standard OFDM one-tap equalizer."""

    def __init__(self, ofdm_obj: OFDM) -> None:
        self._ofdm_obj = ofdm_obj

    def equalize_data(self, data: torch.Tensor,
                      impulse_response) -> torch.Tensor:
        """Equalize demodulated data (..., n_sym * num_used) with an
        impulse response whose taps are (..., T, num_samples): per-sample
        (``num_samples`` a multiple of n_sym) or block-static (one sample
        per OFDM symbol). The taps are averaged per OFDM symbol before the
        transform (the DFT is linear, so this equals the mean of the
        per-sample responses). Anything else that has
        ``get_freq_response(fft_size)`` -> (..., num_samples, fft_size)
        is averaged in the frequency domain."""
        o = self._ofdm_obj
        used = o.num_used_subcarriers
        batch = data.shape[:-1]
        n_sym = data.shape[-1] // used
        d = data.reshape(batch + (n_sym, used))
        if hasattr(impulse_response, "tap_values_sparse") and \
                impulse_response.num_samples % n_sym == 0:
            taps = impulse_response.tap_values_sparse       # (..., T, N)
            spb = taps.shape[-1] // n_sym
            taps_mean = taps.reshape(taps.shape[:-1] + (n_sym, spb)) \
                .mean(dim=-1)                                # (..., T, n_sym)
            w = sparse_dft(impulse_response.tap_indexes_sparse,
                           o.get_used_subcarrier_indexes() % o.fft_size,
                           o.fft_size, taps.device)          # (T, used)
            h = taps_mean.transpose(-1, -2).to(torch.complex64) @ w
        else:
            freq = impulse_response.get_freq_response(o.fft_size)
            fshape = freq.shape
            mean_freq = freq.reshape(
                fshape[:-2] + (n_sym, fshape[-2] // n_sym, fshape[-1])
            ).mean(dim=-2)
            half = used // 2
            h = torch.cat([mean_freq[..., o.fft_size - half:],
                           mean_freq[..., 1:half + 1]], dim=-1)
        return (d / h).reshape(batch + (n_sym * used,))
