"""CAZAC-based frequency-domain channel estimation.

Counterpart of ``pyphysim_tpu/reference_signals/channel_estimation.py``:
correlate the received reference signal with the conjugated user
sequence, go to the delay domain (IFFT), keep the first taps, and FFT back
(at ``size_multiplier`` times the subcarriers: the comb interpolation of
SRS).

The received signal is numpy (the host route, numpy's FFT, as the JAX
package) or a tensor (on its device, ``torch.fft`` where the JAX package
has its matmul DFT; complex64 in, complex64 out). The tensor route's
constants (the conjugate sequences, the cover codes) are device tensors
made once a device, on the first call there: a CUDA graph capture holds
the route, which then copies nothing from the host.

:class:`LayeredOCCChannelEstimator` estimates several users' DMRS at once
(the layers of one user's spatial multiplexing, separated by cyclic shift
and cover code): the per-layer OCC estimates, batched over the layers.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["CazacBasedChannelEstimator",
           "CazacBasedWithOCCChannelEstimator",
           "LayeredOCCChannelEstimator"]


class _DeviceConstants:
    """Host arrays as tensors of a given dtype, made once a device."""

    def __init__(self) -> None:
        self._made: Dict[tuple, torch.Tensor] = {}

    def get(self, name: str, array: np.ndarray, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
        key = (name, device)
        out = self._made.get(key)
        if out is None:
            out = self._made[key] = torch.as_tensor(
                np.asarray(array), device=device).to(dtype)
        return out


def _estimate(decoded, rc, num_taps_to_keep: int, n_out: int):
    """``fft(ifft(decoded * rc)[..., :K + 1], n_out)`` on tensors."""
    y = torch.fft.ifft(decoded.to(torch.complex64) * rc)
    return torch.fft.fft(y[..., :num_taps_to_keep + 1], n=n_out)


class CazacBasedChannelEstimator:
    """Channel estimator for CAZAC reference sequences (SRS/DMRS)."""

    def __init__(self, ue_ref_seq, size_multiplier: int = 2) -> None:
        # accept UeSequence objects or plain arrays
        self._normalized_ref_seq = getattr(ue_ref_seq, "normalized", False)
        if hasattr(ue_ref_seq, "seq_array"):
            ue_ref_seq = ue_ref_seq.seq_array()
        self._ue_ref_sequence = np.asarray(ue_ref_seq)
        self._size_multiplier = int(size_multiplier)
        self._constants = _DeviceConstants()

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
            rc = self._constants.get("conj_ref", np.conj(r),
                                     torch.complex64, received_signal.device)
            tilde_H = _estimate(received_signal, rc, num_taps_to_keep, n_out)
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
                ccb = self._constants.get("cover_code", cc, torch.float32,
                                          received_signal.device)
                received_signal = (received_signal *
                                   ccb[:, None]).mean(dim=-2)
            else:
                decoded = np.asarray(received_signal) * cc[..., :, np.newaxis]
                received_signal = decoded.mean(axis=-2)
        return super().estimate_channel_freq_domain(received_signal,
                                                    num_taps_to_keep)


class LayeredOCCChannelEstimator:
    """The OCC estimates of several DMRS sequences in one call: layer
    ``l``'s estimate is :class:`CazacBasedWithOCCChannelEstimator`'s of
    ``ue_ref_seqs[l]`` on the same received slots. The sequences (each a
    ``DmrsUeSequence`` with a cover code) share their size, their number
    of slots and their normalisation."""

    def __init__(self, ue_ref_seqs: Sequence) -> None:
        layers = [CazacBasedWithOCCChannelEstimator(s) for s in ue_ref_seqs]
        if not layers:
            raise ValueError("at least one sequence is needed")
        if len({(e.ue_ref_seq.shape, e.cover_code.shape,
                 e._normalized_ref_seq) for e in layers}) != 1:
            raise ValueError("the sequences must share their size, slots "
                             "and normalisation")
        self._refs = np.stack([e.ue_ref_seq for e in layers])    # (L, Nsc)
        self._cover_codes = np.stack([e.cover_code for e in layers])
        self._normalized_ref_seq = layers[0]._normalized_ref_seq
        self._constants = _DeviceConstants()

    @property
    def num_layers(self) -> int:
        return self._refs.shape[0]

    @property
    def cover_codes(self) -> np.ndarray:
        """(layers, slots): each layer's cover code."""
        return self._cover_codes

    def estimate_channel_freq_domain(self, received_signal,
                                     num_taps_to_keep: int):
        """``received_signal`` (..., slots, Nsc) -> (..., layers, Nsc):
        each layer's slots decoded with its cover code and averaged, then
        estimated with its sequence."""
        n = self._refs.shape[-1]
        if isinstance(received_signal, torch.Tensor):
            dev = received_signal.device
            cc = self._constants.get("cover_codes", self._cover_codes,
                                     torch.float32, dev)
            rc = self._constants.get("conj_refs", np.conj(self._refs),
                                     torch.complex64, dev)
            decoded = (received_signal[..., None, :, :] *
                       cc[:, :, None]).mean(dim=-2)
            tilde_H = _estimate(decoded, rc, num_taps_to_keep, n)
        else:
            decoded = (np.asarray(received_signal)[..., None, :, :] *
                       self._cover_codes[:, :, None]).mean(axis=-2)
            y = np.fft.ifft(np.conj(self._refs) * decoded, n, axis=-1)
            tilde_H = np.fft.fft(y[..., :num_taps_to_keep + 1], n, axis=-1)
        if self._normalized_ref_seq:
            tilde_H = tilde_H * n
        return tilde_H
