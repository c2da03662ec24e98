"""Tapped-delay-line (TDL) channels.

Counterpart of ``pyphysim_tpu/channels/fading.py``:

  * :class:`TdlChannelProfile` — tap powers/delays, mean excess delay, RMS
    delay spread, discretization to a sample grid (merge coincident taps,
    renormalize), and the COST259 standard profiles (3GPP TR 25.943).
    Host-side numpy: this is static configuration computed once.
  * :class:`TdlImpulseResponse` — sparse tap values over time, the dense
    view, the frequency response (frequency axis last).
  * :class:`TdlChannel` — the functional API (``init_state``,
    ``generate_impulse_response_f``, ``corrupt_data`` per-sample or
    block-static, ``corrupt_data_in_freq_domain``) and the stateful
    convenience form (``seed``, ``corrupt_data(signal)``,
    ``get_last_impulse_response``), SISO or MIMO (a generator shape
    ``(Nr, Nt)``, :meth:`TdlChannel.set_num_antennas`), with the uplink
    (``switched_direction``); :class:`TdlMimoChannel`.
  * :func:`tdl_filter` (per-sample taps), :func:`tdl_filter_block_fft` and
    :func:`tdl_filter_block_fft_mimo` (block-static taps, through
    ``ops/fir.py``; the backend is :data:`BLOCK_CONV_IMPL`).

Layout: tap values are ``batch + (T, num_samples)`` (SISO) or ``batch +
(T, Nr, Nt, num_samples)`` (MIMO) — the JAX package's per-realization
layout with any leading batch dimensions (one realization per row, where
the JAX package would ``vmap``; a multiuser channel's links are the last
batch axis). Signals are ``batch + (num_samples,)`` (SISO) or ``batch +
(Nt, num_samples)`` (MIMO; ``(Nr, num_samples)`` on the uplink). An
impulse response says which it holds (:attr:`TdlImpulseResponse.mimo`).

The JAX package's odd corners are kept: a plain :class:`TdlChannel` with a
MIMO shape and a ``block_size`` filters per sample with the block taps
repeated and returns that per-sample response, while
:class:`TdlMimoChannel` filters block by block and returns the per-block
response; :func:`tdl_filter` refuses the uplink, which
:class:`TdlMimoChannel` serves by transposing the taps.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, require_cuda
from ..ops.fir import block_fir, block_fir_fft
from ..ops.sparse_dft import sparse_dft
from ..utils.conversion import dB2Linear, linear2dB
from ..utils.misc import full_precision
from .fading_generators import (JakesSampleGenerator, JakesState,
                                RayleighSampleGenerator)

__all__ = ["TdlChannelProfile", "TdlImpulseResponse", "TdlChannel",
           "TdlMimoChannel", "tdl_filter", "tdl_filter_block_fft",
           "tdl_filter_block_fft_mimo", "BLOCK_CONV_IMPL", "COST259_TUx",
           "COST259_RAx", "COST259_HTx"]


class TdlChannelProfile:
    """Power-delay profile of a TDL channel (host-side configuration)."""

    def __init__(self, tap_powers_dB: Optional[np.ndarray] = None,
                 tap_delays: Optional[np.ndarray] = None,
                 name: str = "custom") -> None:
        self._name = name
        if tap_powers_dB is None and tap_delays is None:
            tap_powers_dB = np.zeros(1)
            tap_delays = np.zeros(1)
        self._tap_powers_dB = np.asarray(tap_powers_dB, dtype=float)
        self._tap_powers_linear = dB2Linear(self._tap_powers_dB)
        self._tap_delays = np.asarray(tap_delays, dtype=float)
        self._num_taps = self._tap_delays.size

        p, d = self._tap_powers_linear, self._tap_delays
        self._mean_excess_delay = float(np.sum(p * d) / np.sum(p))
        aux = float(np.sum(p * d ** 2) / np.sum(p))
        self._rms_delay_spread = math.sqrt(
            max(aux - self._mean_excess_delay ** 2, 0.0))
        self._Ts: Optional[float] = None

    # -- properties --------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    @property
    def tap_powers_dB(self) -> np.ndarray:
        return self._tap_powers_dB

    @property
    def tap_powers_linear(self) -> np.ndarray:
        return self._tap_powers_linear

    @property
    def tap_delays(self) -> np.ndarray:
        return self._tap_delays

    @property
    def num_taps(self) -> int:
        return self._num_taps

    @property
    def mean_excess_delay(self) -> float:
        return self._mean_excess_delay

    @property
    def rms_delay_spread(self) -> float:
        return self._rms_delay_spread

    @property
    def Ts(self) -> Optional[float]:
        return self._Ts

    @property
    def is_discretized(self) -> bool:
        return self._Ts is not None

    @property
    def num_taps_with_padding(self) -> int:
        """Total tap span including zero taps (only for discretized
        profiles, where delays are integer sample indexes)."""
        if not self.is_discretized:
            raise RuntimeError(
                "num_taps_with_padding is only defined for discretized "
                "profiles")
        return int(self._tap_delays[-1]) + 1

    # -- discretization ----------------------------------------------------

    def get_discretize_profile(self, Ts: float) -> "TdlChannelProfile":
        """Round delays to the ``Ts`` grid, merge coincident taps, and
        renormalize total power to 1."""
        if self.is_discretized:
            raise RuntimeError("Trying to discretize a TdlChannelProfile "
                               "object that is already discretized.")
        delay_idx, inverse = np.unique(
            np.round(self._tap_delays / Ts).astype(int).ravel(),
            return_inverse=True)
        powers = np.zeros(delay_idx.size)
        for i, p in enumerate(self._tap_powers_linear):
            powers[inverse[i]] += p
        powers /= powers.sum()
        prof = TdlChannelProfile(linear2dB(powers), delay_idx,
                                 f"{self.name} (discretized)")
        prof._Ts = Ts
        return prof

    def __repr__(self) -> str:
        return (f"<TdlChannelProfile: '{self.name}' "
                f"({self.num_taps} taps)>")


# 3GPP TR 25.943 standard profiles (public spec constants)
COST259_TUx = TdlChannelProfile(
    np.array([-5.7, -7.6, -10.1, -10.2, -10.2, -11.5, -13.4, -16.3, -16.9,
              -17.1, -17.4, -19.0, -19.0, -19.8, -21.5, -21.6, -22.1, -22.6,
              -23.5, -24.3]),
    np.array([0, 217, 512, 514, 517, 674, 882, 1230, 1287, 1311, 1349, 1533,
              1535, 1622, 1818, 1836, 1884, 1943, 2048, 2140]) * 1e-9,
    "COST259_TU")

COST259_RAx = TdlChannelProfile(
    np.array([-5.2, -6.4, -8.4, -9.3, -10.0, -13.1, -15.3, -18.5, -20.4,
              -22.4]),
    np.array([0., 42., 101., 129., 149., 245., 312., 410., 469., 528.])
    * 1e-9, "COST259_RA")

COST259_HTx = TdlChannelProfile(
    np.array([-3.6, -8.9, -10.2, -11.5, -11.8, -12.7, -13.0, -16.2, -17.3,
              -17.7, -17.6, -22.7, -24.1, -25.8, -25.8, -26.2, -29.0, -29.9,
              -30.0, -30.7]),
    np.array([0., 356., 441., 528., 546., 609., 625., 842., 916., 941.,
              15000., 16172., 16492., 16876., 16882., 16978., 17615.,
              17827., 17849., 18016.]) * 1e-9, "COST259_HT")


class TdlImpulseResponse:
    """Impulse response samples of a (discretized) TDL channel.

    ``tap_values``: complex64 ``batch + (num_sparse_taps, num_samples)``,
    or ``batch + (num_sparse_taps, Nr, Nt, num_samples)`` when ``mimo``;
    the tap positions come from the (static) discretized profile.
    """

    def __init__(self, tap_values: torch.Tensor,
                 channel_profile: TdlChannelProfile,
                 mimo: bool = False) -> None:
        if not channel_profile.is_discretized:
            raise RuntimeError("TdlImpulseResponse requires a discretized "
                               "channel profile")
        self._tap_values_sparse = tap_values
        self._channel_profile = channel_profile
        self._mimo = bool(mimo)

    @classmethod
    def from_numpy(cls, tap_values, profile: TdlChannelProfile,
                   device: DeviceLike = "cuda",
                   mimo: Optional[bool] = None) -> "TdlImpulseResponse":
        """From numpy complex tap values, e.g. a JAX impulse response's
        ``tap_values_sparse`` passed through ``np.asarray``: ``(T, N)``, or
        ``(T, Nr, Nt, N)`` for MIMO (``mimo=None`` takes 4 axes for MIMO),
        with any leading batch axes."""
        dev = require_cuda(device)
        taps = np.asarray(tap_values, np.complex64)
        return cls(torch.as_tensor(taps, device=dev), profile,
                   taps.ndim == 4 if mimo is None else mimo)

    @property
    def channel_profile(self) -> TdlChannelProfile:
        return self._channel_profile

    @property
    def tap_values_sparse(self) -> torch.Tensor:
        return self._tap_values_sparse

    @property
    def mimo(self) -> bool:
        """Whether the taps carry ``(Nr, Nt)`` antenna axes."""
        return self._mimo

    @property
    def tap_axis(self) -> int:
        """The (negative) axis of the taps: -2, or -4 for MIMO."""
        return -4 if self._mimo else -2

    @property
    def tap_indexes_sparse(self) -> np.ndarray:
        """Static integer delay indexes of the nonzero taps."""
        return self._channel_profile.tap_delays.astype(int)

    @property
    def tap_delays_sparse(self) -> np.ndarray:
        """Tap delays in seconds (multiples of Ts)."""
        return self.tap_indexes_sparse * self.Ts

    @property
    def Ts(self) -> Optional[float]:
        return self._channel_profile.Ts

    @property
    def num_samples(self) -> int:
        return self._tap_values_sparse.shape[-1]

    @property
    def tap_values(self) -> torch.Tensor:
        """Dense tap values including the zero taps: the sparse layout
        with ``num_taps_with_padding`` taps."""
        sparse = self._tap_values_sparse.movedim(self.tap_axis, 0)
        D = self._channel_profile.num_taps_with_padding
        dense = sparse.new_zeros((D,) + sparse.shape[1:])
        dense[self.tap_indexes_sparse] = sparse
        return dense.movedim(0, self.tap_axis)

    def get_freq_response(self, fft_size: int) -> torch.Tensor:
        """``batch + [(Nr, Nt)] + (num_samples, fft_size)``: the frequency
        axis last, as in the JAX package. Taps at delays >= fft_size are
        dropped (numpy FFT truncation)."""
        taps = self._tap_values_sparse.movedim(self.tap_axis, -1)
        w = sparse_dft(self.tap_indexes_sparse, range(fft_size), fft_size,
                       taps.device)
        return full_precision(torch.matmul)(taps, w)

    def plot_impulse_response(self) -> None:
        """3-D plot of |tap| over (delay, time), one line a sample (of the
        first antenna pair and batch entry). Imports matplotlib here: the
        rest of the port does not need it."""
        import matplotlib.pyplot as plt
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        dense = self.tap_values.movedim(self.tap_axis, 0).abs().cpu().numpy()
        x = np.arange(dense.shape[0])
        for i in range(self.num_samples):
            ax.plot(x, np.full(dense.shape[0], i),
                    dense[..., i].reshape(dense.shape[0], -1)[:, 0])
        ax.set_xlabel("Taps (delay domain)")
        ax.set_ylabel("Time Domain")
        ax.set_zlabel("Channel Amplitude")
        plt.show()

    def plot_frequency_response(self, fft_size: int) -> None:
        """3-D plot of |H(f)| over (frequency, time), one line a sample (of
        the first antenna pair and batch entry). Imports matplotlib here."""
        import matplotlib.pyplot as plt
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        fr = self.get_freq_response(fft_size).abs().cpu().numpy()
        fr2 = fr.reshape(-1, self.num_samples, fft_size)[0]
        x = np.arange(fft_size)
        for i in range(self.num_samples):
            ax.plot(x, np.full(fft_size, i), fr2[i])
        ax.set_xlabel("Frequency (FFT bins)")
        ax.set_ylabel("Time Domain")
        ax.set_zlabel("Channel Amplitude")
        plt.show()

    def transposed(self) -> "TdlImpulseResponse":
        """The MIMO response with the antenna axes swapped (``H^T`` per
        tap and sample: the uplink of a downlink channel)."""
        if not self._mimo:
            raise ValueError("only a MIMO response has antenna axes")
        return TdlImpulseResponse(self._tap_values_sparse.transpose(-3, -2),
                                  self._channel_profile, True)

    def __mul__(self, value) -> "TdlImpulseResponse":
        return TdlImpulseResponse(self._tap_values_sparse * value,
                                  self._channel_profile, self._mimo)

    __rmul__ = __mul__

    @staticmethod
    def concatenate_samples(
            responses: List["TdlImpulseResponse"]) -> "TdlImpulseResponse":
        """Concatenate along the sample (last) axis."""
        if len(responses) == 1:
            return responses[0]
        return TdlImpulseResponse(
            torch.cat([r.tap_values_sparse for r in responses], dim=-1),
            responses[0].channel_profile, responses[0].mimo)


class TdlChannel:
    """Tapped-delay-line channel: a discretized power-delay profile driven
    by a fading generator (Jakes or Rayleigh) whose first shape axis is the
    (sparse) tap count.

    Functional API:
      * ``state = channel.init_state(source)``
      * ``ir, state = channel.generate_impulse_response_f(state, n)``
      * ``out, ir, state = channel.corrupt_data(state, signal,
        block_size=None)``
      * ``out, ir, state = channel.corrupt_data_in_freq_domain(state,
        signal, fft_size, carrier_indexes)``

    Stateful convenience: ``corrupt_data(signal)`` (and the frequency-domain
    form) with the signal alone threads an internal state, drawn from
    :meth:`seed`'s generator, and returns only the output.

    A generator shape ``(Nr, Nt)`` makes the channel MIMO (taps ``(T, Nr,
    Nt)`` a sample); ``switched_direction`` sends the signal the other way
    (from the ``Nr`` side to the ``Nt`` side).
    """

    def __init__(self, fading_generator, channel_profile:
                 Optional[TdlChannelProfile] = None,
                 tap_powers_dB: Optional[np.ndarray] = None,
                 tap_delays: Optional[np.ndarray] = None,
                 Ts: Optional[float] = None) -> None:
        if isinstance(fading_generator, JakesSampleGenerator):
            if Ts is None:
                Ts = fading_generator.Ts
            elif Ts != fading_generator.Ts:
                raise RuntimeError(
                    "The provided sampling interval Ts is different from "
                    "the one in the Jakes sample generator.")
        elif not isinstance(fading_generator, RayleighSampleGenerator):
            raise TypeError("TdlChannel takes a JakesSampleGenerator or a "
                            "RayleighSampleGenerator")

        if channel_profile is None:
            channel_profile = TdlChannelProfile(tap_powers_dB, tap_delays)

        if not channel_profile.is_discretized:
            if Ts is None:   # only a Rayleigh generator carries no Ts
                Ts = 1.0
            channel_profile = channel_profile.get_discretize_profile(Ts)
        elif Ts is not None and channel_profile.Ts != Ts:
            raise RuntimeError(
                "Channel profile is already discretized, but it does not "
                "agree with the provided Ts")

        self._channel_profile = channel_profile
        self._fading_generator = fading_generator
        self._set_fading_generator_shape(fading_generator.shape)
        self.switched_direction = False
        self._last_impulse_response: Optional[TdlImpulseResponse] = None
        self._state = None
        self._seed = 0

    def _set_fading_generator_shape(self, shape) -> None:
        """The generator's first axis must be the (sparse) tap count;
        MIMO channels add (Nr, Nt)."""
        n = self.num_taps
        if shape is None:
            self._fading_generator.shape = (n,)
        elif len(shape) == 2:
            self._fading_generator.shape = (n,) + tuple(shape)
        elif len(shape) in (1, 3) and shape[0] == n:
            self._fading_generator.shape = tuple(shape)
        else:
            raise ValueError(
                f"Invalid fading generator shape {shape} for a channel "
                f"with {n} taps: pass None (SISO) or (Nr, Nt) (MIMO)")
        powers = np.sqrt(self._channel_profile.tap_powers_linear)
        tail = (1,) * len(self._fading_generator.shape)
        self._tap_scale = torch.tensor(
            powers.reshape((n,) + tail), dtype=torch.float32,
            device=self._fading_generator.device)

    def set_num_antennas(self, num_rx_antennas: Optional[int],
                         num_tx_antennas: Optional[int]) -> None:
        """Make the channel MIMO with these antenna counts, or SISO with
        both None."""
        if num_rx_antennas is None and num_tx_antennas is None:
            self._set_fading_generator_shape(None)
        else:
            self._set_fading_generator_shape(
                (num_rx_antennas, num_tx_antennas))

    @property
    def mimo(self) -> bool:
        return len(self._fading_generator.shape) == 3

    @property
    def num_rx_antennas(self) -> Optional[int]:
        return self._fading_generator.shape[1] if self.mimo else None

    @property
    def num_tx_antennas(self) -> Optional[int]:
        return self._fading_generator.shape[2] if self.mimo else None

    @property
    def channel_profile(self) -> TdlChannelProfile:
        return self._channel_profile

    @property
    def num_taps(self) -> int:
        """Number of NONZERO (sparse) taps."""
        return self._channel_profile.num_taps

    @property
    def num_taps_with_padding(self) -> int:
        return self._channel_profile.num_taps_with_padding

    @property
    def device(self) -> torch.device:
        return self._fading_generator.device

    # -- functional API ----------------------------------------------------

    def init_state(self, source, batch: Tuple[int, ...] = ()):
        """A fresh fading state from an explicit random source (a
        ``torch.Generator``, or an ``AttemptStreams`` for one state per
        attempt), with ``batch`` leading axes of independent states after
        those."""
        return self._fading_generator.init_state(source, batch)

    def generate_impulse_response_f(
            self, state, num_samples: int = 1
    ) -> Tuple[TdlImpulseResponse, object]:
        """``num_samples`` per-sample impulse responses: fading samples
        scaled by sqrt(tap power)."""
        samples, state = self._fading_generator.generate(state, num_samples)
        return self._response(samples), state

    def _response(self, samples: torch.Tensor) -> TdlImpulseResponse:
        """Fading samples (``batch + shape + (N,)``) scaled by sqrt(tap
        power)."""
        return TdlImpulseResponse(samples * self._tap_scale,
                                  self._channel_profile, self.mimo)

    def _generate_strided_impulse_response(self, state, num_blocks: int,
                                           stride: int):
        """One impulse response per block, blocks ``stride`` samples apart
        in channel time: the Jakes closed form evaluated once per block."""
        gen = self._fading_generator
        if not isinstance(gen, JakesSampleGenerator):
            # Rayleigh is memoryless: the stride is irrelevant
            return self.generate_impulse_response_f(state, num_blocks)
        t0 = state.t0
        ray_axis = t0.dim()
        phi = state.phi_l[..., 0]                       # batch + (L, *shape)
        w = 2.0 * np.pi * gen.Fd * torch.cos(phi)
        t = t0.reshape(t0.shape + (1,) * (phi.dim() - ray_axis + 1)) + \
            torch.arange(num_blocks, dtype=t0.dtype,
                         device=t0.device) * (stride * gen.Ts)
        phase = w[..., None] * t + state.psi_l[..., 0][..., None]
        scale = math.sqrt(1.0 / gen.L)
        samples = torch.complex(torch.cos(phase).sum(dim=ray_axis) * scale,
                                torch.sin(phase).sum(dim=ray_axis) * scale)
        new_state = JakesState(phi_l=state.phi_l, psi_l=state.psi_l,
                               t0=t0 + num_blocks * stride * gen.Ts)
        return self._response(samples), new_state

    def corrupt_data(self, state_or_signal, signal=None,
                     block_size: Optional[int] = None):
        """Time-domain transmission through the time-varying channel.

        Functional form ``corrupt_data(state, signal)`` returns ``(output,
        impulse_response, new_state)``; the convenience form
        ``corrupt_data(signal)`` threads the internal state and returns the
        output only. SISO: signal ``batch + (N,)`` -> output ``batch + (N +
        D - 1,)``; MIMO: ``batch + (Nt, N)`` -> ``batch + (Nr, N + D -
        1)``.

        ``block_size``: hold the channel constant over blocks of that many
        samples (one Jakes evaluation per block). SISO filters through
        :func:`tdl_filter_block_fft` and returns one response sample per
        block; MIMO, as the JAX package's plain channel, repeats each
        block's taps over its samples, filters through :func:`tdl_filter`
        and returns that per-sample response (:class:`TdlMimoChannel`
        filters block by block). ``None`` generates per-sample responses
        and filters through :func:`tdl_filter`.
        """
        if signal is None or isinstance(signal, int):
            if isinstance(signal, int):
                block_size = signal
            out, ir, self._state = self._corrupt_data_impl(
                self._ensure_state(), state_or_signal, block_size)
            self._last_impulse_response = ir
            return out
        return self._corrupt_data_impl(state_or_signal, signal, block_size)

    def _as_signal(self, signal) -> torch.Tensor:
        return torch.as_tensor(signal).to(self.device, torch.complex64)

    def _corrupt_data_impl(self, state, signal, block_size: Optional[int]):
        signal = self._as_signal(signal)
        num_samples = signal.shape[-1]
        if block_size is None:
            ir, state = self.generate_impulse_response_f(state, num_samples)
            return (tdl_filter(ir, signal, self.switched_direction), ir,
                    state)
        ir_block, state = self._block_response(state, num_samples,
                                               block_size)
        if not self.mimo:
            out = tdl_filter_block_fft(ir_block, signal, block_size)
            return out, ir_block, state
        ir = TdlImpulseResponse(
            ir_block.tap_values_sparse.repeat_interleave(block_size, dim=-1),
            self._channel_profile, True)
        return tdl_filter(ir, signal, self.switched_direction), ir, state

    def _block_response(self, state, num_samples: int, block_size: int):
        if num_samples % block_size != 0:
            raise ValueError(
                "block_size must divide the number of transmitted samples")
        return self._generate_strided_impulse_response(
            state, num_samples // block_size, stride=block_size)

    def corrupt_data_in_freq_domain(self, state_or_signal, signal=None,
                                    fft_size: Optional[int] = None,
                                    carrier_indexes=None):
        """Block-static frequency-domain transmission: one impulse response
        per block of ``fft_size`` channel samples, each block of the signal
        (all ``fft_size`` carriers, or the ``carrier_indexes``) multiplied
        by its frequency response at those carriers. MIMO: signal ``batch +
        (Nt, N)`` -> ``batch + (Nr, N)``, summed over the transmit antennas
        (over the receive ones, from ``(Nr, N)`` to ``(Nt, N)``, with
        ``switched_direction``).

        Functional form ``(state, signal, fft_size, carrier_indexes)`` ->
        ``(output, impulse_response, state)``; convenience form
        ``(signal, fft_size, carrier_indexes)`` -> output.
        """
        if signal is None or isinstance(signal, int):
            if signal is not None:
                fft_size, carrier_indexes = signal, fft_size
            out, ir, self._state = self._corrupt_freq_impl(
                self._ensure_state(), state_or_signal, fft_size,
                carrier_indexes)
            self._last_impulse_response = ir
            return out
        return self._corrupt_freq_impl(state_or_signal, signal, fft_size,
                                       carrier_indexes)

    def _corrupt_freq_impl(self, state, signal, fft_size: int,
                           carrier_indexes):
        signal = self._as_signal(signal)
        num_samples = signal.shape[-1]
        carriers = (np.arange(fft_size) if carrier_indexes is None
                    else np.asarray(carrier_indexes))
        block_size = carriers.size
        if num_samples % block_size != 0:
            raise ValueError(
                "The number of elements in `signal` must be a multiple of "
                "the number of sent elements per `fft_size`")
        num_blocks = num_samples // block_size
        ir, state = self._generate_strided_impulse_response(
            state, num_blocks, stride=fft_size)
        w = sparse_dft(ir.tap_indexes_sparse, carriers, fft_size,
                       signal.device)
        # batch + [(Nr, Nt)] + (nb, Nc)
        freq = full_precision(torch.matmul)(
            ir.tap_values_sparse.movedim(ir.tap_axis, -1), w)
        blocks = signal.reshape(signal.shape[:-1] + (num_blocks, block_size))
        if not self.mimo:
            out = blocks * freq
        elif self.switched_direction:
            out = (freq * blocks.unsqueeze(-3)).sum(dim=-4)   # over r
        else:
            out = (freq * blocks.unsqueeze(-4)).sum(dim=-3)   # over t
        return out.reshape(out.shape[:-2] + (num_samples,)), ir, state

    # -- stateful convenience ---------------------------------------------

    def seed(self, seed: int) -> None:
        """Seed the internal state of the stateful convenience API."""
        self._seed = int(seed)
        self._state = None

    def _ensure_state(self):
        if self._state is None:
            gen = torch.Generator(device=self.device).manual_seed(self._seed)
            self._state = self.init_state(gen)
        return self._state

    def generate_impulse_response(self, num_samples: int = 1) -> None:
        """Stateful form: generate and keep the next impulse response."""
        ir, self._state = self.generate_impulse_response_f(
            self._ensure_state(), num_samples)
        self._last_impulse_response = ir

    def get_last_impulse_response(self) -> Optional[TdlImpulseResponse]:
        return self._last_impulse_response


# Block-convolution backend of tdl_filter_block_fft: "kernel" (the CUDA
# kernel ops/csrc/block_fir.cu on CUDA tensors, its plain version on CPU
# tensors), "fft" (per-block FFT convolution), or "auto" (= kernel). The JAX
# package resolves "auto" to its FFT route from one TPU v5e measurement,
# which says nothing of this card; chip_smoke.py times both routes here.
BLOCK_CONV_IMPL = "auto"


def _conv_route() -> str:
    """:data:`BLOCK_CONV_IMPL` resolved: "kernel" or "fft"."""
    impl = "kernel" if BLOCK_CONV_IMPL == "auto" else BLOCK_CONV_IMPL
    if impl not in ("kernel", "fft"):
        raise ValueError(f"unknown BLOCK_CONV_IMPL {BLOCK_CONV_IMPL!r}")
    return impl


def _overlap_add(y: torch.Tensor, block_size: int, D: int) -> torch.Tensor:
    """Blocks ``(..., nb, block_size + D - 1)`` -> ``(..., nb * block_size
    + D - 1)``: block b's tail lands on the head of block b + 1."""
    nb = y.shape[-2]
    main = y[..., :block_size]
    tail = y[..., block_size:]
    main[..., 1:, :D - 1] += tail[..., :-1, :]   # disjoint views of y
    return torch.cat([main.reshape(y.shape[:-2] + (nb * block_size,)),
                      tail[..., -1, :]], dim=-1)


def _check_blocks(idx, n: int, block_size: int) -> Tuple[int, int]:
    D = int(idx[-1]) + 1
    if block_size < D - 1:
        raise ValueError("block_size must be at least the channel span")
    if n % block_size != 0:
        raise ValueError(
            "block_size must divide the number of transmitted samples")
    return D, n // block_size


def tdl_filter_block_fft(ir_block: TdlImpulseResponse,
                         signal: torch.Tensor,
                         block_size: int) -> torch.Tensor:
    """Block-static SISO TDL filtering: each block of ``block_size``
    samples convolved with its own dense ``D``-tap kernel (the channel is
    constant within a block), then overlap-added across block boundaries
    (the ``D - 1``-sample halo). The same output as :func:`tdl_filter` with
    per-block-constant taps.

    ``ir_block``: taps ``batch + (T, num_blocks)``. ``signal``: ``batch +
    (N,)``. Returns ``batch + (N + D - 1,)``. The per-block convolution
    runs through :data:`BLOCK_CONV_IMPL`'s route.
    """
    idx = ir_block.tap_indexes_sparse
    taps = ir_block.tap_values_sparse                     # batch + (T, nb)
    D, nb = _check_blocks(idx, signal.shape[-1], block_size)
    batch = signal.shape[:-1]
    if taps.shape != batch + (len(idx), nb):
        raise ValueError(f"taps {tuple(taps.shape)} do not match the "
                         f"signal: want {batch + (len(idx), nb)}")
    conv = block_fir if _conv_route() == "kernel" else block_fir_fft
    y = conv(signal.reshape(-1, block_size),
             taps.transpose(-1, -2).reshape(-1, len(idx)), idx, block_size)
    return _overlap_add(y.reshape(batch + (nb, block_size + D - 1)),
                        block_size, D)


def tdl_filter_block_fft_mimo(ir_block: TdlImpulseResponse,
                              signal: torch.Tensor,
                              block_size: int) -> torch.Tensor:
    """MIMO variant of :func:`tdl_filter_block_fft`: receive antenna r
    gets ``sum_t conv(x_t, h_{r,t})`` block by block.

    ``ir_block``: taps ``batch + (T, Nr, Nt, num_blocks)``; ``signal``:
    ``batch + (Nt, N)``. Returns ``batch + (Nr, N + D - 1)``.

    Routes (:data:`BLOCK_CONV_IMPL`): ``"kernel"`` convolves every (r, t)
    pair's blocks in ONE ``block_fir`` call, over the signal's blocks
    repeated for each receive antenna, then sums over t. One launch over
    repeated rows rather than one launch per receive antenna: the
    wrapper's host work (50-60 us a call, PERF.md) exceeds the kernel's
    time for one antenna's rows at the MIMO geometry, so Nr launches would
    keep the card waiting on the host. ``"fft"`` is the JAX package's
    route: the per-block spectra contracted over t, then one inverse FFT
    per receive antenna.
    """
    idx = ir_block.tap_indexes_sparse
    taps = ir_block.tap_values_sparse                # batch + (T, Nr, Nt, nb)
    nt, n = signal.shape[-2:]
    D, nb = _check_blocks(idx, n, block_size)
    batch = signal.shape[:-2]
    nr = taps.shape[-3]
    if taps.shape != batch + (len(idx), nr, nt, nb):
        raise ValueError(f"taps {tuple(taps.shape)} do not match the "
                         f"signal: want {batch + (len(idx), nr, nt, nb)}")
    x_blocks = signal.reshape(batch + (nt, nb, block_size))
    h = taps.movedim(-4, -1)                         # batch + (Nr, Nt, nb, T)
    if _conv_route() == "fft":
        out_len = block_size + D - 1
        L = ((out_len + 127) // 128) * 128
        X = torch.fft.fft(x_blocks, n=L)             # batch + (Nt, nb, L)
        H = full_precision(torch.matmul)(
            h, sparse_dft(idx, range(L), L, signal.device))
        y = torch.fft.ifft((H * X.unsqueeze(-4)).sum(dim=-3))[..., :out_len]
    else:
        x_rows = x_blocks.unsqueeze(-4).expand(
            batch + (nr, nt, nb, block_size)).reshape(-1, block_size)
        y = block_fir(x_rows, h.reshape(-1, len(idx)), idx, block_size)
        y = y.reshape(batch + (nr, nt, nb, block_size + D - 1)).sum(dim=-3)
    return _overlap_add(y, block_size, D)


def tdl_filter(ir: TdlImpulseResponse, signal: torch.Tensor,
               switched_direction: bool = False) -> torch.Tensor:
    """Apply the time-varying sparse FIR of a per-sample impulse response:
    ``out[m] = sum_i h_i[m - d_i] x[m - d_i]``, one shifted multiply-add
    per tap. SISO: taps ``batch + (T, N)``, signal ``batch + (N,)`` ->
    ``batch + (N + D - 1,)``. MIMO: taps ``batch + (T, Nr, Nt, N)``, signal
    ``batch + (Nt, N)`` -> ``batch + (Nr, N + D - 1)``, contracted over the
    transmit antennas. The uplink (``switched_direction``) raises, as in
    the JAX package: :class:`TdlMimoChannel` transposes the taps
    instead."""
    idx = ir.tap_indexes_sparse
    taps = ir.tap_values_sparse
    n = signal.shape[-1]
    if not ir.mimo:
        if taps.shape[-2:] != (len(idx), n):
            raise ValueError(f"taps {tuple(taps.shape)} do not match "
                             f"{len(idx)} taps x {n} samples")
        prod = taps * signal[..., None, :]                # batch + (T, N)
    else:
        if switched_direction:
            raise NotImplementedError(
                "switched_direction uplink is handled by TdlMimoChannel "
                "transposing the impulse response")
        if taps.shape[-4] != len(idx) or \
                taps.shape[-2:] != signal.shape[-2:]:
            raise ValueError(f"taps {tuple(taps.shape)} do not match "
                             f"{len(idx)} taps and the signal "
                             f"{tuple(signal.shape)}")
        # batch + (T, Nr, N): contracted over t in float32 adds
        prod = (taps * signal.unsqueeze(-3).unsqueeze(-4)).sum(dim=-2)
    prod = prod.movedim(-3 if ir.mimo else -2, 0)          # taps first
    out = signal.new_zeros(prod.shape[1:-1] + (n + int(idx[-1]),))
    for i, d in enumerate(idx):
        out[..., d:d + n] += prod[i]
    return out


class TdlMimoChannel(TdlChannel):
    """MIMO-shaped :class:`TdlChannel`: the generator's shape must be
    ``(num_rx_antennas, num_tx_antennas)``. Block-static transmission
    filters block by block (:func:`tdl_filter_block_fft_mimo`) and returns
    the per-block response; the uplink (``switched_direction``) transposes
    the per-tap channel matrices (the returned response stays
    untransposed)."""

    def __init__(self, fading_generator, channel_profile:
                 Optional[TdlChannelProfile] = None,
                 tap_powers_dB: Optional[np.ndarray] = None,
                 tap_delays: Optional[np.ndarray] = None,
                 Ts: Optional[float] = None) -> None:
        if fading_generator.shape is None or \
                len(fading_generator.shape) != 2:
            raise RuntimeError(
                "The provided fading_generator for TdlMimoChannel must "
                "have a shape of (num_rx_antennas, num_tx_antennas)")
        super().__init__(fading_generator, channel_profile, tap_powers_dB,
                         tap_delays, Ts)

    def _corrupt_data_impl(self, state, signal, block_size: Optional[int]):
        signal = self._as_signal(signal)
        num_samples = signal.shape[-1]
        if block_size is None:
            ir, state = self.generate_impulse_response_f(state, num_samples)
            ir_use = ir.transposed() if self.switched_direction else ir
            return tdl_filter(ir_use, signal), ir, state
        ir_block, state = self._block_response(state, num_samples,
                                               block_size)
        ir_use = ir_block.transposed() if self.switched_direction \
            else ir_block
        out = tdl_filter_block_fft_mimo(ir_use, signal, block_size)
        return out, ir_block, state
