"""Multiuser channels: TDL interference grids and the flat-fading block
channel matrix.

Counterpart of ``pyphysim_tpu/channels/multiuser.py``.

:class:`MuChannel` / :class:`MuMimoChannel` are a (Krx x Ktx) grid of
independently fading TDL links (SISO, or Nr x Nt MIMO), each with its own
path loss; a receiver gets the sum over all transmitters. All links run in
ONE batched :class:`~.fading.TdlChannel` call, the port's counterpart of
the JAX package's single ``vmap`` over the links: the links are the last
batch axis, row-major over the (rx, tx) grid (link ``r * Ktx + t``). So
the states are ``batch + (links,)`` (``t0``) and ``batch + (links, L) +
shape + (1,)`` (Jakes phases), the per-link outputs ``batch + (links,) +
[(Nr,)] + (samples,)`` and the stacked impulse response's taps ``batch +
(links, T) + [(Nr, Nt)] + (samples,)``, where the JAX package puts the
link axis at position 1 of the taps. :meth:`MuChannel.
get_last_impulse_response` returns one link's response in either case.

:class:`MultiUserChannelMatrix` is the flat-fading MIMO interference
channel as ONE dense complex64
tensor ``big_H`` of shape (sum(Nr), sum(Nt)) with per-user antenna counts,
block ``(k, l)`` the link from transmitter ``l`` to receiver ``k``;
interference covariances (``calc_Q`` / ``calc_JP_Q``), per-stream Bkl
matrices and SINRs (Cadambe2008 eq. 28), post receive filters, and a
``torch.Generator`` each for the channel and the noise draws.
``MultiUserChannelMatrixExtInt`` adds external interference sources as
extra transmit-only users (extra columns of ``big_H``) with their
covariances at each receiver.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .._device import DeviceLike, require_cuda
from ..utils.misc import randn_c
from .fading import TdlChannel, TdlChannelProfile, TdlImpulseResponse
from .fading_generators import RayleighSampleGenerator

__all__ = ["MuChannel", "MuMimoChannel", "MultiUserChannelMatrix",
           "MultiUserChannelMatrixExtInt"]

IntArray = Union[int, np.ndarray]


def _host_like(out, like):
    """``out`` as numpy when ``like`` was numpy (or a list of numpy
    arrays), else as it is."""
    host = isinstance(like, np.ndarray) or (
        isinstance(like, (list, tuple)) and len(like) > 0 and
        isinstance(like[0], np.ndarray))
    if not host:
        return out
    if isinstance(out, list):
        return [o.cpu().numpy() for o in out]
    return out.cpu().numpy()


class MuChannel:
    """TDL multiuser (interference) channel: independently fading links on
    a (num_rx users x num_tx users) grid, one batched channel call for all
    of them (see the module docstring for the layouts). ``device`` places
    the default Rayleigh generator (a given generator brings its own; it is
    copied, not changed)."""

    def __init__(self, N: Union[int, Sequence[int]], fading_generator=None,
                 channel_profile: Optional[TdlChannelProfile] = None,
                 tap_powers_dB: Optional[np.ndarray] = None,
                 tap_delays: Optional[np.ndarray] = None,
                 Ts: Optional[float] = None,
                 device: DeviceLike = "cuda") -> None:
        num_rx, num_tx = N if isinstance(N, (tuple, list)) else (N, N)
        self._num_rx_users = int(num_rx)
        self._num_tx_users = int(num_tx)
        if fading_generator is None:
            fading_generator = RayleighSampleGenerator(device=device)
            if Ts is None and channel_profile is None and \
                    tap_delays is None:
                Ts = 1.0
        self._tdl = TdlChannel(fading_generator.get_similar_fading_generator(),
                               channel_profile=channel_profile,
                               tap_powers_dB=tap_powers_dB,
                               tap_delays=tap_delays, Ts=Ts)
        self._pathloss_matrix: Optional[np.ndarray] = None
        self._seed = 0
        self._states = None
        self._last_irs: Optional[TdlImpulseResponse] = None

    def __repr__(self) -> str:
        return (f"MuChannel with shape {self._num_rx_users}x"
                f"{self._num_tx_users}")

    # -- properties --------------------------------------------------------

    @property
    def num_rx_users(self) -> int:
        return self._num_rx_users

    @property
    def num_tx_users(self) -> int:
        return self._num_tx_users

    @property
    def num_links(self) -> int:
        return self._num_rx_users * self._num_tx_users

    @property
    def switched_direction(self) -> bool:
        return self._tdl.switched_direction

    @switched_direction.setter
    def switched_direction(self, value: bool) -> None:
        self._tdl.switched_direction = value

    @property
    def channel_profile(self) -> TdlChannelProfile:
        return self._tdl.channel_profile

    @property
    def num_taps(self) -> int:
        return self._tdl.num_taps

    @property
    def num_taps_with_padding(self) -> int:
        return self._tdl.num_taps_with_padding

    @property
    def num_tx_antennas(self) -> Optional[int]:
        return self._tdl.num_tx_antennas

    @property
    def num_rx_antennas(self) -> Optional[int]:
        return self._tdl.num_rx_antennas

    @property
    def device(self) -> torch.device:
        return self._tdl.device

    @property
    def pathloss_matrix(self) -> Optional[np.ndarray]:
        return self._pathloss_matrix

    def set_pathloss(self,
                     pathloss_matrix: Optional[np.ndarray] = None) -> None:
        """Per-link (rx, tx) linear path loss matrix, each value in (0, 1]
        (None: no path loss)."""
        if pathloss_matrix is not None:
            pl = np.asarray(pathloss_matrix, dtype=float)
            if pl.shape != (self._num_rx_users, self._num_tx_users):
                raise ValueError(f"pathloss_matrix must be "
                                 f"{self._num_rx_users}x{self._num_tx_users}")
            if not np.all((pl > 0) & (pl <= 1)):
                raise ValueError("Pathloss must be a positive value lower "
                                 "than or equal to 1")
        self._pathloss_matrix = pathloss_matrix

    # -- functional API ----------------------------------------------------

    def init_state(self, source):
        """The stacked link states from an explicit random source (a
        ``torch.Generator``, or an ``AttemptStreams`` for one set of links
        per attempt): links as the last batch axis."""
        return self._tdl.init_state(source, (self.num_links,))

    def _tile_signal(self, signal) -> torch.Tensor:
        """The transmitters' signals (a list, or a tensor with the
        transmitters on the axis before the per-user signal) repeated for
        each receiver, so link ``r * T + t`` reads transmitter ``t``."""
        user_dims = 2 if self._tdl.mimo else 1
        if isinstance(signal, (list, tuple)):
            sig = torch.stack([self._tdl._as_signal(s) for s in signal],
                              dim=-1 - user_dims)
        else:
            sig = self._tdl._as_signal(signal)
        lead = sig.shape[:-1 - user_dims]
        tiled = sig.unsqueeze(-2 - user_dims).expand(
            lead + (self._num_rx_users,) + sig.shape[-1 - user_dims:])
        return tiled.reshape(lead + (self.num_links,) +
                             sig.shape[-user_dims:])

    def _finalize_links(self, outs: torch.Tensor, irs: TdlImpulseResponse):
        """Apply the per-link path loss to the outputs and the responses,
        sum over transmitters; the per-receiver outputs and the responses."""
        R, T = self._num_rx_users, self._num_tx_users
        link_axis = outs.dim() - (3 if self._tdl.mimo else 2)
        if self._pathloss_matrix is not None:
            scale = torch.as_tensor(
                np.sqrt(np.asarray(self._pathloss_matrix, float)).ravel(),
                dtype=torch.float32, device=outs.device)
            outs = outs * scale.reshape(
                (-1,) + (1,) * (outs.dim() - link_axis - 1))
            tv = irs.tap_values_sparse
            irs = TdlImpulseResponse(
                tv * scale.reshape((-1,) + (1,) * (tv.dim() - link_axis - 1)),
                irs.channel_profile, irs.mimo)
        summed = outs.unflatten(link_axis, (R, T)).sum(dim=link_axis + 1)
        return [summed.select(link_axis, r) for r in range(R)], irs

    def corrupt_data(self, state_or_signal, signal=None):
        """Per-sample transmission over every link. ``signal``: the
        transmitters' signals, ``batch + (num_tx_users,) + [(Nt,)] +
        (n,)`` or a list of ``batch + [(Nt,)] + (n,)``. Functional form
        ``(states, signal) -> (outputs, irs, states)``: a list of the
        receivers' ``batch + [(Nr,)] + (n + D - 1,)`` outputs (summed over
        the transmitters), the stacked response and the new states;
        convenience form ``(signal) -> outputs`` (numpy in, numpy out).

        Per-sample Jakes fading holds every ray's phase before the ray sum:
        ``L x links x T [x Nr x Nt] x n`` float32 values an attempt, twice
        (cos and sin), 1.8e7 at K = 3, 16 rays, 16 taps and 8,000 samples.
        Size an attempts batch to the device's memory by that count."""
        if signal is None:
            out, self._last_irs, self._states = self._corrupt_impl(
                self._ensure_states(), state_or_signal)
            return _host_like(out, state_or_signal)
        return self._corrupt_impl(state_or_signal, signal)

    def _corrupt_impl(self, states, signal):
        outs, irs, states = self._tdl._corrupt_data_impl(
            states, self._tile_signal(signal), None)
        out, irs = self._finalize_links(outs, irs)
        return out, irs, states

    def corrupt_data_in_freq_domain(self, state_or_signal, signal=None,
                                    fft_size=None, carrier_indexes=None):
        """Block-static frequency-domain transmission over every link (the
        arguments of :meth:`TdlChannel.corrupt_data_in_freq_domain`, the
        signals and outputs of :meth:`corrupt_data`)."""
        if signal is None or isinstance(signal, int):
            if signal is not None:
                fft_size, carrier_indexes = signal, fft_size
            out, self._last_irs, self._states = self._corrupt_freq_impl(
                self._ensure_states(), state_or_signal, fft_size,
                carrier_indexes)
            return _host_like(out, state_or_signal)
        return self._corrupt_freq_impl(state_or_signal, signal, fft_size,
                                       carrier_indexes)

    def _corrupt_freq_impl(self, states, signal, fft_size, carrier_indexes):
        outs, irs, states = self._tdl._corrupt_freq_impl(
            states, self._tile_signal(signal), fft_size, carrier_indexes)
        out, irs = self._finalize_links(outs, irs)
        return out, irs, states

    # -- stateful convenience ---------------------------------------------

    def seed(self, seed: int) -> None:
        """Seed the link states of the stateful convenience API."""
        self._seed = int(seed)
        self._states = None

    def _ensure_states(self):
        if self._states is None:
            self._states = self.init_state(
                torch.Generator(device=self.device).manual_seed(self._seed))
        return self._states

    def get_last_impulse_response(self, rx_idx: int, tx_idx: int,
                                  irs: Optional[TdlImpulseResponse] = None
                                  ) -> TdlImpulseResponse:
        """The response of link (rx_idx, tx_idx): of the last stateful
        call, or of the stacked response ``irs`` a functional call
        returned."""
        irs = self._last_irs if irs is None else irs
        tv = irs.tap_values_sparse
        link_axis = tv.dim() - (5 if irs.mimo else 3)
        return TdlImpulseResponse(
            tv.select(link_axis, rx_idx * self._num_tx_users + tx_idx),
            irs.channel_profile, irs.mimo)


class MuMimoChannel(MuChannel):
    """:class:`MuChannel` whose links are (Nr x Nt) MIMO TDL channels."""

    def __init__(self, N: Union[int, Sequence[int]], num_rx_antennas: int,
                 num_tx_antennas: int, fading_generator=None,
                 channel_profile: Optional[TdlChannelProfile] = None,
                 tap_powers_dB: Optional[np.ndarray] = None,
                 tap_delays: Optional[np.ndarray] = None,
                 Ts: Optional[float] = None,
                 device: DeviceLike = "cuda") -> None:
        super().__init__(N, fading_generator, channel_profile,
                         tap_powers_dB, tap_delays, Ts, device)
        self._tdl.set_num_antennas(num_rx_antennas, num_tx_antennas)


class MultiUserChannelMatrix:
    """Flat-fading MIMO interference channel as one dense block matrix on
    ``device``. The channel and noise generators are seeded 0 and 1 until
    :meth:`set_channel_seed` / :meth:`set_noise_seed` say otherwise."""

    def __init__(self, device: DeviceLike = "cuda") -> None:
        self.device = require_cuda(device)
        self._big_H: Optional[torch.Tensor] = None
        self._Nr = np.array([], dtype=int)
        self._Nt = np.array([], dtype=int)
        self._K = 0
        self._pathloss_matrix: Optional[np.ndarray] = None
        self._W: Optional[List[torch.Tensor]] = None
        self.noise_var: Optional[float] = None
        self._last_noise: Optional[torch.Tensor] = None
        self._channel_gen = self._generator(0)
        self._noise_gen = self._generator(1)

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.complex64)
        return torch.as_tensor(np.asarray(x, dtype=np.complex64),
                               device=self.device)

    # -- seeding -----------------------------------------------------------

    def set_channel_seed(self, seed: Optional[int] = None) -> None:
        """Seed the channel generator; None draws a fresh random seed."""
        self._channel_gen = self._generator(seed)

    def set_noise_seed(self, seed: Optional[int] = None) -> None:
        """Seed the noise generator; None draws a fresh random seed."""
        self._noise_gen = self._generator(seed)

    def re_seed(self) -> None:
        """Fresh random seeds for both generators, so that parallel workers
        do not share streams."""
        self.set_channel_seed(None)
        self.set_noise_seed(None)

    # -- properties --------------------------------------------------------

    @property
    def K(self) -> int:
        return self._K

    @property
    def Nr(self) -> np.ndarray:
        return self._Nr

    @property
    def Nt(self) -> np.ndarray:
        return self._Nt

    @property
    def big_H(self) -> Optional[torch.Tensor]:
        return self._apply_pathloss(self._big_H)

    @property
    def H(self):
        """Block view: with uniform antenna counts a (K, K, Nr, Nt) tensor,
        otherwise a (K, K) object array of per-block tensors."""
        bh = self.big_H
        if bh is None:
            return None
        if len(set(self._Nr.tolist())) == 1 and \
                len(set(self._Nt.tolist())) == 1:
            K = self._K
            nr, nt = int(self._Nr[0]), int(self._Nt[0])
            return bh.reshape(K, nr, K, nt).transpose(1, 2)
        out = np.empty((self._K, self._K), dtype=object)
        for k in range(self._K):
            for l in range(self._K):
                out[k, l] = self.get_Hkl(k, l)
        return out

    @property
    def pathloss(self) -> Optional[np.ndarray]:
        return self._pathloss_matrix

    @property
    def last_noise(self) -> Optional[torch.Tensor]:
        return self._last_noise

    @property
    def W(self) -> Optional[List[torch.Tensor]]:
        return self._W

    @property
    def big_W(self) -> Optional[torch.Tensor]:
        """Block-diagonal stack of the per-user post receive filters."""
        if self._W is None:
            return None
        return torch.block_diag(*self._W)

    def set_post_filter(self, filters: Sequence) -> None:
        """Per-user post receive filters applied by ``corrupt_*_data``."""
        self._W = [self._tensor(f) for f in filters]

    # -- construction ------------------------------------------------------

    def _setup_counts(self, Nr: IntArray, Nt: IntArray, K: int) -> None:
        Nr = np.full(K, Nr, dtype=int) if np.isscalar(Nr) else \
            np.asarray(Nr, dtype=int)
        Nt = np.full(K, Nt, dtype=int) if np.isscalar(Nt) else \
            np.asarray(Nt, dtype=int)
        if Nr.size != K or Nt.size != K:
            raise ValueError("Nr and Nt must have a value for each of "
                             "the K users")
        self._Nr, self._Nt, self._K = Nr, Nt, int(K)
        self._rx_off = np.concatenate(([0], np.cumsum(Nr)))
        self._tx_off = np.concatenate(([0], np.cumsum(Nt)))

    def randomize(self, Nr: IntArray, Nt: IntArray, K: int,
                  generator: Optional[torch.Generator] = None) -> None:
        """Draw a new iid CN(0, 1) block channel from ``generator`` (the
        channel generator by default)."""
        self._setup_counts(Nr, Nt, K)
        gen = self._channel_gen if generator is None else generator
        self._big_H = randn_c(gen, int(self._Nr.sum()), int(self._Nt.sum()))

    def init_from_channel_matrix(self, channel_matrix, Nr: IntArray,
                                 Nt: IntArray, K: int) -> None:
        """Install a given (sum Nr, sum Nt) matrix."""
        self._setup_counts(Nr, Nt, K)
        cm = self._tensor(channel_matrix)
        if tuple(cm.shape[-2:]) != (int(self._Nr.sum()),
                                    int(self._Nt.sum())):
            raise ValueError(
                "Channel matrix dimensions must match sum(Nr) x sum(Nt)")
        self._big_H = cm

    # -- views -------------------------------------------------------------

    def _apply_pathloss(self, bh: Optional[torch.Tensor]
                        ) -> Optional[torch.Tensor]:
        if bh is None or self._pathloss_matrix is None:
            return bh
        scale = np.ones((int(self._Nr.sum()), int(self._Nt.sum())))
        for k in range(self._K):
            for l in range(self._K):
                scale[self._rx_off[k]:self._rx_off[k + 1],
                      self._tx_off[l]:self._tx_off[l + 1]] = \
                    math.sqrt(self._pathloss_matrix[k, l])
        return bh * torch.as_tensor(scale, dtype=torch.float32,
                                    device=bh.device)

    def get_Hkl(self, k: int, l: int) -> torch.Tensor:
        """Channel block from transmitter ``l`` to receiver ``k``."""
        return self.big_H[..., self._rx_off[k]:self._rx_off[k + 1],
                          self._tx_off[l]:self._tx_off[l + 1]]

    def get_Hk(self, k: int) -> torch.Tensor:
        """Channel from all transmitters to receiver ``k``."""
        return self.big_H[..., self._rx_off[k]:self._rx_off[k + 1], :]

    def set_pathloss(self,
                     pathloss_matrix: Optional[np.ndarray] = None) -> None:
        self._pathloss_matrix = pathloss_matrix

    # -- transmission ------------------------------------------------------

    def corrupt_concatenated_data(self, data,
                                  generator: Optional[torch.Generator] = None,
                                  noise=None):
        """``big_H @ data + noise`` (then the block-diagonal post filter,
        if one is set). ``data``: (sum Nt, n); numpy in, numpy out. The
        noise is drawn from ``generator`` (the noise generator by default),
        or is the given unit-variance ``noise`` (sum Nr, n), scaled by
        ``sqrt(noise_var)``, so that two runs can see the same noise."""
        out = self.big_H @ self._tensor(data)
        if self.noise_var is not None and self.noise_var > 0:
            gen = self._noise_gen if generator is None else generator
            unit = randn_c(gen, *out.shape) if noise is None \
                else self._tensor(noise)
            noise = unit * math.sqrt(self.noise_var)
            self._last_noise = noise
            out = out + noise
        else:
            self._last_noise = None
        if self._W is not None:
            out = self.big_W @ out
        return _host_like(out, data)

    def corrupt_data(self, data, generator: Optional[torch.Generator] = None,
                     noise=None):
        """Per-user variant: ``data`` a list of (Nt_k, n) arrays; returns a
        list of per-receiver outputs (after the post filter, if set)."""
        concat = torch.cat([self._tensor(d) for d in data], dim=-2)
        big_out = self.corrupt_concatenated_data(concat, generator, noise)
        out = [big_out[..., self._rx_off[k]:self._rx_off[k + 1], :]
               for k in range(self._K)]
        return _host_like(out, data)

    # -- covariances and SINRs (Cadambe2008 eq. 28) ------------------------

    def calc_Q(self, k: int, F_all_users: Sequence) -> torch.Tensor:
        """Interference covariance at receiver k, noise included:
        ``sum_{j != k} H_kj F_j F_j^H H_kj^H + noise_var I``."""
        return self._calc_Q_impl(k, F_all_users) + self._noise_eye(k)

    def _noise_eye(self, k: int) -> torch.Tensor:
        nv = self.noise_var or 0.0
        return nv * torch.eye(int(self._Nr[k]), dtype=torch.complex64,
                              device=self.device)

    def _calc_Q_impl(self, k: int, F_all_users: Sequence) -> torch.Tensor:
        nr = int(self._Nr[k])
        q = torch.zeros((nr, nr), dtype=torch.complex64, device=self.device)
        for j in range(self._K):
            if j == k:
                continue
            hf = self.get_Hkl(k, j) @ self._tensor(F_all_users[j])
            q = q + hf @ hf.mH
        return q

    def calc_JP_Q(self, k: int, F_all_users: Sequence) -> torch.Tensor:
        """Joint-processing variant: the full row ``H_k``."""
        return self._calc_JP_Q_impl(k, F_all_users) + self._noise_eye(k)

    def _calc_JP_Q_impl(self, k: int, F_all_users: Sequence) -> torch.Tensor:
        nr = int(self._Nr[k])
        q = torch.zeros((nr, nr), dtype=torch.complex64, device=self.device)
        hk = self.get_Hk(k)
        for j in range(self._K):
            if j == k:
                continue
            hf = hk @ self._tensor(F_all_users[j])
            q = q + hf @ hf.mH
        return q

    def _as_Rek(self, N0_or_Rek, nr: int) -> torch.Tensor:
        if N0_or_Rek is None:
            N0_or_Rek = 0.0
        if isinstance(N0_or_Rek, torch.Tensor) or (
                isinstance(N0_or_Rek, np.ndarray) and N0_or_Rek.ndim >= 2):
            return self._tensor(N0_or_Rek)
        return float(N0_or_Rek) * torch.eye(nr, dtype=torch.complex64,
                                            device=self.device)

    def _calc_Bkl_cov_matrix_first_part(self, F_all_users: Sequence, k: int,
                                        N0_or_Rek=0.0) -> torch.Tensor:
        first = self._as_Rek(N0_or_Rek, int(self._Nr[k]))
        for j in range(self._K):
            hv = self.get_Hkl(k, j) @ self._tensor(F_all_users[j])
            first = first + hv @ hv.mH
        return first

    def _calc_Bkl_cov_matrix_second_part(self, Fk, k: int,
                                         l: int) -> torch.Tensor:
        hv = self.get_Hkl(k, k) @ self._tensor(Fk)[..., :, l:l + 1]
        return hv @ hv.mH

    def _calc_Bkl_cov_matrix_all_l(self, F_all_users: Sequence, k: int,
                                   N0_or_Rek=0.0) -> List[torch.Tensor]:
        first = self._calc_Bkl_cov_matrix_first_part(F_all_users, k,
                                                     N0_or_Rek)
        ns_k = self._tensor(F_all_users[k]).shape[-1]
        return [first - self._calc_Bkl_cov_matrix_second_part(
            F_all_users[k], k, l) for l in range(ns_k)]

    def _sinr_impl(self, Hk: torch.Tensor, Fk, Uk,
                   Bkl_all_l) -> torch.Tensor:
        fk, uk = self._tensor(Fk), self._tensor(Uk)
        sinrs = []
        for l in range(fk.shape[-1]):
            ukl = uk[..., :, l:l + 1]
            aux = ukl.mH @ (Hk @ fk[..., :, l:l + 1])
            num = (aux.real ** 2 + aux.imag ** 2)[..., 0, 0]
            den = (ukl.mH @ (Bkl_all_l[l] @ ukl)).real[..., 0, 0]
            sinrs.append(num / den.abs())
        return torch.stack(sinrs, dim=-1)

    def _calc_SINR_k(self, k: int, Fk, Uk, Bkl_all_l) -> torch.Tensor:
        return self._sinr_impl(self.get_Hkl(k, k), Fk, Uk, Bkl_all_l)

    def calc_SINR(self, F: Sequence, U: Sequence) -> List[torch.Tensor]:
        """Per-stream SINRs of every user (linear)."""
        out = []
        for k in range(self._K):
            bkl = self._calc_Bkl_cov_matrix_all_l(F, k, self.noise_var or 0.0)
            out.append(self._calc_SINR_k(k, F[k], U[k], bkl))
        return out

    # -- joint-processing variants ----------------------------------------

    def _calc_JP_Bkl_cov_matrix_first_part(self, F_all_users: Sequence,
                                           k: int, noise_power: float = 0.0):
        first = self._as_Rek(noise_power, int(self._Nr[k]))
        hk = self.get_Hk(k)
        for j in range(self._K):
            hv = hk @ self._tensor(F_all_users[j])
            first = first + hv @ hv.mH
        return first

    def _calc_JP_Bkl_cov_matrix_second_part(self, Fk, k: int,
                                            l: int) -> torch.Tensor:
        hv = self.get_Hk(k) @ self._tensor(Fk)[..., :, l:l + 1]
        return hv @ hv.mH

    def _calc_JP_Bkl_cov_matrix_all_l(self, F_all_users: Sequence, k: int,
                                      noise_power: float = 0.0):
        first = self._calc_JP_Bkl_cov_matrix_first_part(F_all_users, k,
                                                        noise_power)
        ns_k = self._tensor(F_all_users[k]).shape[-1]
        return [first - self._calc_JP_Bkl_cov_matrix_second_part(
            F_all_users[k], k, l) for l in range(ns_k)]

    def _calc_JP_SINR_k(self, k: int, Fk, Uk, Bkl_all_l) -> torch.Tensor:
        return self._sinr_impl(self.get_Hk(k), Fk, Uk, Bkl_all_l)

    def calc_JP_SINR(self, F: Sequence, U: Sequence) -> List[torch.Tensor]:
        """Per-stream SINRs under joint processing (the full row H_k)."""
        out = []
        for k in range(self._K):
            bkl = self._calc_JP_Bkl_cov_matrix_all_l(F, k,
                                                     self.noise_var or 0.0)
            out.append(self._calc_JP_SINR_k(k, F[k], U[k], bkl))
        return out


class MultiUserChannelMatrixExtInt(MultiUserChannelMatrix):
    """Interference channel with external interference sources, modeled as
    extra transmit-only users: the last ``extIntK`` column blocks of
    ``big_H``, with no receive antennas of their own."""

    def __init__(self, device: DeviceLike = "cuda") -> None:
        super().__init__(device)
        self._extIntK = 0
        self._extIntNt = np.array([], dtype=int)

    # -- properties --------------------------------------------------------

    @property
    def extIntK(self) -> int:
        return self._extIntK

    @property
    def extIntNt(self) -> np.ndarray:
        return self._extIntNt

    @property
    def K(self) -> int:
        return self._K - self._extIntK

    @property
    def Nr(self) -> np.ndarray:
        return self._Nr[:self.K]

    @property
    def Nt(self) -> np.ndarray:
        return self._Nt[:self.K]

    @property
    def big_H_no_ext_int(self) -> Optional[torch.Tensor]:
        bh = self.big_H
        return None if bh is None else bh[..., :, :int(self._tx_off[self.K])]

    @property
    def H_no_ext_int(self):
        """(K, K) object array of the users' blocks (no ext-int columns)."""
        full = self.H
        return None if full is None else full[:self.K, :self.K]

    # -- construction ------------------------------------------------------

    @staticmethod
    def _prepare_input_parans(Nr, Nt, K, NtE):
        """The antenna arrays extended with the external sources (no
        receive antennas, ``NtE`` transmit antennas each)."""
        Nr = np.full(K, Nr, dtype=int) if np.isscalar(Nr) else \
            np.asarray(Nr, dtype=int)
        Nt = np.full(K, Nt, dtype=int) if np.isscalar(Nt) else \
            np.asarray(Nt, dtype=int)
        if np.isscalar(NtE):
            extIntK = 1
            extIntNt = np.array([NtE], dtype=int)
        else:
            extIntK = len(NtE)
            extIntNt = np.asarray(NtE, dtype=int)
        full_Nr = np.concatenate([Nr, np.zeros(extIntK, dtype=int)])
        full_Nt = np.concatenate([Nt, extIntNt])
        return full_Nr, full_Nt, K + extIntK, extIntK, extIntNt

    def randomize(self, Nr, Nt, K, NtE,  # type: ignore[override]
                  generator: Optional[torch.Generator] = None) -> None:
        """Draw a new iid CN(0, 1) channel, ext-int columns included."""
        full_Nr, full_Nt, full_K, extK, extNt = \
            self._prepare_input_parans(Nr, Nt, K, NtE)
        self._extIntK, self._extIntNt = extK, extNt
        super().randomize(full_Nr, full_Nt, full_K, generator)

    def init_from_channel_matrix(self, channel_matrix, Nr, Nt, K,
                                 NtE) -> None:  # type: ignore[override]
        """Install a given (sum Nr, sum Nt + sum NtE) matrix."""
        full_Nr, full_Nt, full_K, extK, extNt = \
            self._prepare_input_parans(Nr, Nt, K, NtE)
        self._extIntK, self._extIntNt = extK, extNt
        super().init_from_channel_matrix(channel_matrix, full_Nr, full_Nt,
                                         full_K)

    def set_pathloss(self, pathloss_matrix=None,  # type: ignore[override]
                     ext_int_pathloss=None) -> None:
        """Per-link path loss (K, K) plus the (K, extIntK) loss from each
        external source to each receiver."""
        if pathloss_matrix is None:
            super().set_pathloss(None)
            return
        K, extK = self.K, self._extIntK
        full = np.ones((K + extK, K + extK))
        full[:K, :K] = np.asarray(pathloss_matrix)
        if ext_int_pathloss is not None:
            full[:K, K:] = np.asarray(ext_int_pathloss).reshape(K, extK)
        super().set_pathloss(full)

    def get_Hk_without_ext_int(self, k: int) -> torch.Tensor:
        """Row of ``big_H`` for receiver ``k`` without the ext-int
        columns."""
        return self.get_Hk(k)[..., :, :int(self._tx_off[self.K])]

    def get_Hk_with_ext_int(self, k: int) -> torch.Tensor:
        return self.get_Hk(k)

    # -- transmission ------------------------------------------------------

    def corrupt_data(self, data, ext_int_data=None,  # type: ignore[override]
                     generator: Optional[torch.Generator] = None):
        """``data``: per-user signals; ``ext_int_data``: per-source
        signals. Returns the per-receiver outputs (numpy in, numpy out)."""
        all_data = list(data) + list(ext_int_data or [])
        concat = torch.cat([self._tensor(d) for d in all_data], dim=-2)
        big_out = self.corrupt_concatenated_data(concat, generator)
        out = [big_out[..., self._rx_off[k]:self._rx_off[k + 1], :]
               for k in range(self.K)]
        return _host_like(out, data)

    # -- external interference covariance ----------------------------------

    def calc_cov_matrix_extint_without_noise(
            self, pe: float = 1.0) -> List[torch.Tensor]:
        """Covariance of the external interference at each receiver:
        ``pe * sum_e H_k,e H_k,e^H``."""
        out = []
        for k in range(self.K):
            nr = int(self._Nr[k])
            acc = torch.zeros((nr, nr), dtype=torch.complex64,
                              device=self.device)
            for e in range(self._extIntK):
                he = self.get_Hkl(k, self.K + e)
                acc = acc + (he @ he.mH) * pe
            out.append(acc)
        return out

    def calc_cov_matrix_extint_plus_noise(
            self, pe: float = 1.0) -> List[torch.Tensor]:
        """Ext-int covariance plus the noise variance on the diagonal."""
        return [r + self._noise_eye(k) for k, r in enumerate(
            self.calc_cov_matrix_extint_without_noise(pe))]

    # -- Q and SINR with the external interference -------------------------

    def calc_Q(self, k: int, F_all_users: Sequence,  # type: ignore[override]
               pe: float = 1.0) -> torch.Tensor:
        return self._calc_Q_impl(k, F_all_users) + \
            self.calc_cov_matrix_extint_plus_noise(pe)[k]

    def calc_JP_Q(self, k: int,  # type: ignore[override]
                  F_all_users: Sequence, pe: float = 1.0) -> torch.Tensor:
        return self._calc_JP_Q_impl_no_ext(k, F_all_users) + \
            self.calc_cov_matrix_extint_plus_noise(pe)[k]

    def _calc_JP_Q_impl_no_ext(self, k: int,
                               F_all_users: Sequence) -> torch.Tensor:
        nr = int(self._Nr[k])
        q = torch.zeros((nr, nr), dtype=torch.complex64, device=self.device)
        hk = self.get_Hk_without_ext_int(k)
        for j in range(self.K):
            if j == k:
                continue
            hf = hk @ self._tensor(F_all_users[j])
            q = q + hf @ hf.mH
        return q

    def _calc_Q_impl(self, k: int, F_all_users: Sequence) -> torch.Tensor:
        nr = int(self._Nr[k])
        q = torch.zeros((nr, nr), dtype=torch.complex64, device=self.device)
        for j in range(self.K):
            if j == k:
                continue
            hf = self.get_Hkl(k, j) @ self._tensor(F_all_users[j])
            q = q + hf @ hf.mH
        return q

    def calc_SINR(self, F: Sequence, U: Sequence,  # type: ignore[override]
                  pe: float = 1.0) -> List[torch.Tensor]:
        """Per-stream SINRs with the external interference in the Bkl
        covariances."""
        reks = self.calc_cov_matrix_extint_plus_noise(pe)
        out = []
        for k in range(self.K):
            bkl = self._calc_Bkl_cov_matrix_all_l(F, k, reks[k])
            out.append(self._calc_SINR_k(k, F[k], U[k], bkl))
        return out

    def _calc_Bkl_cov_matrix_first_part(self, F_all_users: Sequence, k: int,
                                        N0_or_Rek=0.0) -> torch.Tensor:
        first = self._as_Rek(N0_or_Rek, int(self._Nr[k]))
        for j in range(self.K):
            hv = self.get_Hkl(k, j) @ self._tensor(F_all_users[j])
            first = first + hv @ hv.mH
        return first

    def _calc_JP_Bkl_cov_matrix_first_part(  # type: ignore[override]
            self, F_all_users: Sequence, k: int, noise_power=0.0):
        first = self._as_Rek(noise_power, int(self._Nr[k]))
        hk = self.get_Hk_without_ext_int(k)
        for j in range(self.K):
            hv = hk @ self._tensor(F_all_users[j])
            first = first + hv @ hv.mH
        return first

    def _calc_JP_Bkl_cov_matrix_second_part(self, Fk, k: int,
                                            l: int) -> torch.Tensor:
        hv = self.get_Hk_without_ext_int(k) @ \
            self._tensor(Fk)[..., :, l:l + 1]
        return hv @ hv.mH

    def _calc_JP_SINR_k(self, k: int, Fk, Uk, Bkl_all_l) -> torch.Tensor:
        return self._sinr_impl(self.get_Hk_without_ext_int(k), Fk, Uk,
                               Bkl_all_l)

    def calc_JP_SINR(self, F: Sequence, U: Sequence,  # type: ignore[override]
                     pe: float = 1.0) -> List[torch.Tensor]:
        """Per-stream SINRs under joint processing, the external
        interference in the Bkl covariances."""
        reks = self.calc_cov_matrix_extint_plus_noise(pe)
        out = []
        for k in range(self.K):
            bkl = self._calc_JP_Bkl_cov_matrix_all_l(F, k, reks[k])
            out.append(self._calc_JP_SINR_k(k, F[k], U[k], bkl))
        return out
