"""MIMO encode / decode schemes on complex64 tensors.

Counterpart of ``pyphysim_tpu/mimo/mimo.py`` (Blast, MRT, MRC, SVDMimo,
GMDMimo, Alamouti and the post-processing SINR helpers). Every scheme is
batched over leading dimensions: channels are ``(..., Nr, Nt)`` and symbol
streams ``(..., n)``. Encode reshapes column-major (the stream index varies
fastest, ``_reshape_F``), so the decoded stream order is the JAX package's.

The small per-realization algebra goes to ``torch.linalg``: the MMSE filter
is a batched ``solve``, zero forcing a ``pinv``, ``SVDMimo`` an ``svd``.
``GMDMimo`` computes its geometric mean decomposition on the host in numpy,
one channel at a time, as the JAX class does.

A numpy channel is moved to the scheme's ``device`` and makes encode /
decode return numpy arrays (host convenience, as in the JAX package); a
tensor channel stays on its own device and the outputs are tensors there.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, require_cuda
from ..utils.conversion import linear2dB
from ..utils.misc import gmd, pinv

__all__ = ["MimoBase", "Blast", "MRT", "MRC", "SVDMimo", "GMDMimo",
           "Alamouti", "calc_post_processing_SINRs",
           "calc_post_processing_linear_SINRs"]


def _as_c(x, device=None) -> torch.Tensor:
    """``x`` as a complex tensor: a tensor keeps its device (a real one
    becomes complex64), anything else becomes complex64 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x if x.is_complex() else x.to(torch.complex64)
    return torch.as_tensor(np.asarray(x, dtype=np.complex64), device=device)


def _abs2(x: torch.Tensor) -> torch.Tensor:
    return x.real * x.real + x.imag * x.imag


def calc_post_processing_linear_SINRs(channel, W, G_H,
                                      noise_var: Optional[float] = None):
    """Post-processing SINR of every stream: the desired gain
    ``|diag(G_H H W)|^2`` over the coherent sum of the off-diagonal
    interference plus the noise amplified by ``G_H`` (``|G_H row|^2``
    times ``noise_var``). Batched over leading dims; real output."""
    channel = _as_c(channel)
    W = _as_c(W, channel.device)
    G_H = _as_c(G_H, channel.device)
    if noise_var is None:
        noise_var = 0.0
    eq = G_H @ (channel @ W)
    s = torch.diagonal(eq, dim1=-2, dim2=-1)
    i = eq.sum(dim=-1) - s
    N = noise_var * _abs2(G_H).sum(dim=-1)
    return _abs2(s) / (_abs2(i) + N)


def calc_post_processing_SINRs(channel, W, G_H,
                               noise_var: Optional[float] = None):
    """Post-processing SINRs in dB."""
    return linear2dB(
        calc_post_processing_linear_SINRs(channel, W, G_H, noise_var))


class MimoBase:
    """Base MIMO scheme holding the channel matrix."""

    def __init__(self, channel=None, device: DeviceLike = "cuda") -> None:
        self.device = require_cuda(device)
        self._channel: Optional[torch.Tensor] = None
        self._host_io = False
        if channel is not None:
            self.set_channel_matrix(channel)

    def set_channel_matrix(self, channel) -> None:
        self._host_io = isinstance(channel, np.ndarray)
        self._channel = _as_c(channel, self.device)

    @property
    def channel(self) -> Optional[torch.Tensor]:
        return self._channel

    @property
    def Nr(self) -> int:
        return self._channel.shape[-2]

    @property
    def Nt(self) -> int:
        return self._channel.shape[-1]

    def getNumberOfLayers(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def _data(self, x) -> torch.Tensor:
        return _as_c(x, self._channel.device)

    def _maybe_host(self, out):
        if self._host_io and isinstance(out, torch.Tensor):
            return out.cpu().numpy()
        return out

    # -- shared filters ------------------------------------------------------

    @staticmethod
    def _calcZeroForceFilter(channel: torch.Tensor) -> torch.Tensor:
        """Zero forcing: the pseudo-inverse of the channel, with the JAX
        package's cutoff (``utils.misc.pinv``)."""
        return pinv(channel)

    @staticmethod
    def _calcMMSEFilter(channel: torch.Tensor,
                        noise_var: float) -> torch.Tensor:
        """MMSE: ``(H^H H + s2 I)^-1 H^H`` by a batched solve."""
        h_h = channel.mH
        reg = h_h @ channel
        eye = torch.eye(reg.shape[-1], dtype=reg.dtype, device=reg.device)
        return torch.linalg.solve(reg + noise_var * eye, h_h)

    def encode(self, transmit_data):  # pragma: no cover - abstract
        raise NotImplementedError

    def decode(self, received_data):  # pragma: no cover - abstract
        raise NotImplementedError

    def calc_linear_SINRs(self, noise_var: float):
        """Post-processing SINRs (linear) of the scheme's streams, from its
        precoder and receive filter."""
        W = self._calc_precoder(self._channel)
        G_H = self._calc_receive_filter(self._channel, noise_var)
        return calc_post_processing_linear_SINRs(self._channel, W, G_H,
                                                 noise_var)

    def calc_SINRs(self, noise_var: float):
        """Post-processing SINRs in dB."""
        return linear2dB(self.calc_linear_SINRs(noise_var))


def _reshape_F(data: torch.Tensor, n_streams: int) -> torch.Tensor:
    """Column-major reshape of (..., n) to (..., n_streams, n/n_streams):
    the stream index varies fastest."""
    n = data.shape[-1]
    out = data.reshape(data.shape[:-1] + (n // n_streams, n_streams))
    return out.transpose(-1, -2)


def _flatten_F(data: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_reshape_F`."""
    s, m = data.shape[-2], data.shape[-1]
    return data.transpose(-1, -2).reshape(data.shape[:-2] + (s * m,))


def _check_multiple(data: torch.Tensor, n: int) -> None:
    if data.shape[-1] % n != 0:
        raise ValueError(
            "Input array number of elements must be a multiple of the "
            "number of transmit antennas")


class Blast(MimoBase):
    """Spatial multiplexing: Nt streams, a 1/sqrt(Nt) power split, and a
    zero-forcing (noise variance 0) or MMSE receive filter."""

    def __init__(self, channel=None, device: DeviceLike = "cuda") -> None:
        super().__init__(channel, device=device)
        self._noise_var = 0.0

    def set_noise_var(self, noise_var: Optional[float]) -> None:
        if noise_var is None:
            self._noise_var = 0.0
        elif noise_var >= 0:
            self._noise_var = float(noise_var)
        else:
            raise ValueError("Noise variance must be a non-negative value.")

    def getNumberOfLayers(self) -> int:
        return self.Nt

    @staticmethod
    def _calc_precoder(channel: torch.Tensor) -> torch.Tensor:
        nt = channel.shape[-1]
        return torch.eye(nt, dtype=channel.dtype, device=channel.device) * \
            (1.0 / math.sqrt(nt))

    @classmethod
    def _calc_receive_filter(cls, channel: torch.Tensor,
                             noise_var: Optional[float] = None
                             ) -> torch.Tensor:
        nt = channel.shape[-1]
        if noise_var is not None and noise_var > 0:
            g = cls._calcMMSEFilter(channel, noise_var)
        else:
            g = cls._calcZeroForceFilter(channel)
        return g * math.sqrt(nt)

    def encode(self, transmit_data):
        data = self._data(transmit_data)
        _check_multiple(data, self.getNumberOfLayers())
        out = _reshape_F(data, self.getNumberOfLayers()) * \
            (1.0 / math.sqrt(self.Nt))
        return self._maybe_host(out)

    def decode(self, received_data):
        g = self._calc_receive_filter(self._channel, self._noise_var)
        out = _flatten_F(g @ self._data(received_data))
        return self._maybe_host(out)


class MisoBase(MimoBase):
    """Base of the single-stream, single-receive-antenna schemes: a 1-D
    channel is one row."""

    def set_channel_matrix(self, channel) -> None:
        if channel.ndim == 1:
            channel = channel[None, :]
        super().set_channel_matrix(channel)

    def getNumberOfLayers(self) -> int:
        return 1


class MRT(MisoBase):
    """Maximum Ratio Transmission: phase-conjugate beamforming
    ``exp(-j angle(h)) / sqrt(Nt)``."""

    @staticmethod
    def _calc_precoder(channel: torch.Tensor) -> torch.Tensor:
        nt = channel.shape[-1]
        w = torch.polar(torch.ones_like(channel.real), -channel.angle())
        return w.transpose(-1, -2) * (1.0 / math.sqrt(nt))   # (..., Nt, 1)

    @staticmethod
    def _calc_receive_filter(channel: torch.Tensor, noise_var=None):
        nt = channel.shape[-1]
        return math.sqrt(nt) / channel.abs().sum(dim=(-2, -1))

    def encode(self, transmit_data):
        data = self._data(transmit_data)
        w = self._calc_precoder(self._channel)
        return self._maybe_host(w * data[..., None, :])     # (..., Nt, n)

    def decode(self, received_data):
        rx = self._data(received_data)
        if rx.dim() >= 2 and rx.shape[-2] == 1:
            rx = rx.reshape(rx.shape[:-2] + (rx.shape[-1],))
        g = self._calc_receive_filter(self._channel)
        return self._maybe_host(rx * g[..., None])


class MRC(Blast):
    """Maximum Ratio Combining: the Blast receive filter applied to an
    ``Nr x 1`` channel (a 1-D channel is one column)."""

    def set_channel_matrix(self, channel) -> None:
        if channel.ndim == 1:
            channel = channel[:, None]
        super().set_channel_matrix(channel)


class SVDMimo(Blast):
    """SVD precoding: ``W = V / sqrt(Nt)`` and
    ``G_H = diag(1/S) U^H sqrt(Nt)``."""

    @staticmethod
    def _calc_precoder(channel: torch.Tensor) -> torch.Tensor:
        nt = channel.shape[-1]
        _, _, v_h = torch.linalg.svd(channel, full_matrices=False)
        return v_h.mH * (1.0 / math.sqrt(nt))

    @classmethod
    def _calc_receive_filter(cls, channel: torch.Tensor,
                             noise_var: Optional[float] = None
                             ) -> torch.Tensor:
        nt = channel.shape[-1]
        u, s, _ = torch.linalg.svd(channel, full_matrices=False)
        return u.mH * (1.0 / s)[..., :, None] * math.sqrt(nt)

    def encode(self, transmit_data):
        data = self._data(transmit_data)
        _check_multiple(data, self.Nt)
        out = self._calc_precoder(self._channel) @ _reshape_F(data, self.Nt)
        return self._maybe_host(out)

    def decode(self, received_data):
        g = self._calc_receive_filter(self._channel)
        return self._maybe_host(_flatten_F(g @ self._data(received_data)))


class GMDMimo(Blast):
    """GMD precoding: an equal-diagonal R gives every stream the same SNR.
    The decomposition runs on the host (numpy), for one channel."""

    @staticmethod
    def _gmd(channel: torch.Tensor):
        h = channel.detach().cpu().numpy()
        return gmd(*np.linalg.svd(h))

    @classmethod
    def _calc_precoder(cls, channel: torch.Tensor) -> torch.Tensor:
        _, _, P = cls._gmd(channel)
        return _as_c(P / math.sqrt(channel.shape[-1])).to(channel.device)

    @classmethod
    def _calc_receive_filter(cls, channel: torch.Tensor,
                             noise_var: Optional[float] = None
                             ) -> torch.Tensor:
        Q, R, _ = cls._gmd(channel)
        channel_eq = _as_c(Q @ R).to(channel.device)
        return Blast._calc_receive_filter(channel_eq, noise_var)

    def encode(self, transmit_data):
        data = self._data(transmit_data)
        _check_multiple(data, self.Nt)
        out = self._calc_precoder(self._channel) @ _reshape_F(data, self.Nt)
        return self._maybe_host(out)

    def decode(self, received_data):
        g = self._calc_receive_filter(self._channel, self._noise_var)
        return self._maybe_host(_flatten_F(g @ self._data(received_data)))


class Alamouti(MimoBase):
    """Rate-1 2 x Nr space-time block code.

    Encode, pairwise with a sqrt(2) power split: ``[[x0, -x1*], [x1, x0*]]``.
    Decode: matched combining with ``||H||_F^2`` compensation, as even / odd
    slices over the whole stream (no per-codeword loop).
    """

    def set_channel_matrix(self, channel) -> None:
        if channel.ndim == 1:
            channel = channel[None, :]
        if channel.shape[-1] != 2:
            raise ValueError(
                "The number of transmit antennas must be equal to 2 for "
                "the Alamouti scheme")
        super().set_channel_matrix(channel)

    def getNumberOfLayers(self) -> int:
        return 1

    def calc_linear_SINRs(self, noise_var: float):
        """``||H||_F^2 / noise_var``."""
        return _abs2(self._channel).sum(dim=(-2, -1)) / noise_var

    @staticmethod
    def _encode(data: torch.Tensor) -> torch.Tensor:
        x0 = data[..., 0::2]                               # (..., m)
        x1 = data[..., 1::2]
        row0 = torch.stack([x0, -x1.conj()], dim=-1)       # (..., m, 2)
        row1 = torch.stack([x1, x0.conj()], dim=-1)
        enc = torch.stack([row0, row1], dim=-3)            # (..., 2, m, 2)
        return enc.reshape(data.shape[:-1] + (2, data.shape[-1]))

    def encode(self, transmit_data):
        data = self._data(transmit_data)
        if data.shape[-1] % 2 != 0:
            raise ValueError(
                "Input data length must be a multiple of 2 for the "
                "Alamouti scheme")
        return self._maybe_host(self._encode(data) * (1.0 / math.sqrt(2)))

    @staticmethod
    def _decode(rx: torch.Tensor, channel: torch.Tensor) -> torch.Tensor:
        h0 = channel[..., :, 0, None]                      # (..., Nr, 1)
        h1 = channel[..., :, 1, None]
        y0 = rx[..., :, 0::2]                              # (..., Nr, m)
        y1c = rx[..., :, 1::2].conj()
        # d0 = h0^H y0 + h1^T y1*;  d1 = h1^H y0 - h0^T y1*
        d0 = (h0.conj() * y0).sum(dim=-2) + (h1 * y1c).sum(dim=-2)
        d1 = (h1.conj() * y0).sum(dim=-2) + (-h0 * y1c).sum(dim=-2)
        out = torch.stack([d0, d1], dim=-1)                # (..., m, 2)
        out = out.reshape(d0.shape[:-1] + (2 * d0.shape[-1],))
        h2 = _abs2(channel).sum(dim=(-2, -1))
        return out * (1.0 / h2)[..., None]

    def decode(self, received_data):
        out = self._decode(self._data(received_data), self._channel) * \
            math.sqrt(2)
        return self._maybe_host(out)
