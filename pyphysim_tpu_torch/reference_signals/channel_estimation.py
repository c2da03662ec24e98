"""CAZAC-based frequency-domain channel estimation.

Counterpart of ``pyphysim_tpu/reference_signals/channel_estimation.py``:
correlate the received reference signal with the conjugated user
sequence, go to the delay domain (IFFT), keep the first taps, and FFT back
(at ``size_multiplier`` times the subcarriers: the comb interpolation of
SRS).

The received signal is numpy (the host route, numpy's FFT, as the JAX
package) or a tensor (on its device, ``torch.fft`` where the JAX package
has its matmul DFT; complex64 in, complex64 out).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["CazacBasedChannelEstimator",
           "CazacBasedWithOCCChannelEstimator"]


class CazacBasedChannelEstimator:
    """Channel estimator for CAZAC reference sequences (SRS/DMRS)."""

    def __init__(self, ue_ref_seq, size_multiplier: int = 2) -> None:
        # accept UeSequence objects or plain arrays
        self._normalized_ref_seq = getattr(ue_ref_seq, "normalized", False)
        if hasattr(ue_ref_seq, "seq_array"):
            ue_ref_seq = ue_ref_seq.seq_array()
        self._ue_ref_sequence = np.asarray(ue_ref_seq)
        self._size_multiplier = int(size_multiplier)

    @property
    def ue_ref_seq(self) -> np.ndarray:
        return self._ue_ref_sequence

    def estimate_channel_freq_domain(self, received_signal,
                                     num_taps_to_keep: int):
        """Estimate the channel frequency response.

        ``received_signal``: (..., Nsc) — the reference signal after the
        channel, possibly with leading receive-antenna or batch axes.
        Returns the response at ``size_multiplier * Nsc`` subcarriers.
        """
        r = self._ue_ref_sequence
        n_out = self._size_multiplier * r.size
        if isinstance(received_signal, torch.Tensor):
            rc = torch.as_tensor(np.conj(r).astype(np.complex64),
                                 device=received_signal.device)
            y = torch.fft.ifft(received_signal.to(torch.complex64) * rc)
            tilde_H = torch.fft.fft(y[..., :num_taps_to_keep + 1], n=n_out)
        else:
            y = np.fft.ifft(np.conj(r) * np.asarray(received_signal),
                            r.size, axis=-1)
            tilde_H = np.fft.fft(y[..., :num_taps_to_keep + 1], n_out,
                                 axis=-1)
        if self._normalized_ref_seq:
            tilde_H = tilde_H * r.size
        return tilde_H


class CazacBasedWithOCCChannelEstimator(CazacBasedChannelEstimator):
    """CAZAC estimation with an Orthogonal Cover Code: average the
    (cover-code-decoded) slots before the standard estimation."""

    def __init__(self, ue_ref_seq) -> None:
        cover_code = ue_ref_seq.cover_code
        seq = ue_ref_seq.seq_array()
        reference_seq = seq[0] * cover_code[0]
        super().__init__(reference_seq, size_multiplier=1)
        self._normalized_ref_seq = ue_ref_seq.normalized
        self._cover_code = np.asarray(cover_code)

    @property
    def cover_code(self) -> np.ndarray:
        return self._cover_code

    def estimate_channel_freq_domain(self, received_signal,
                                     num_taps_to_keep: int,
                                     extra_dimension: bool = True):
        """``received_signal``: (..., num_slots, Nsc) when
        ``extra_dimension`` — decoded with the cover code and averaged
        over slots, then estimated."""
        cc = self._cover_code
        if extra_dimension:
            if isinstance(received_signal, torch.Tensor):
                ccb = torch.as_tensor(cc.astype(np.float32),
                                      device=received_signal.device)
                received_signal = (received_signal *
                                   ccb[:, None]).mean(dim=-2)
            else:
                decoded = np.asarray(received_signal) * cc[..., :, np.newaxis]
                received_signal = decoded.mean(axis=-2)
        return super().estimate_channel_freq_domain(received_signal,
                                                    num_taps_to_keep)
