"""Tapped-delay-line channel configuration.

Counterpart of the parts of ``pyphysim_tpu/channels/fading.py`` that the
Monte Carlo kernel reads:

  * :class:`TdlChannelProfile` — tap powers/delays, mean excess delay, RMS
    delay spread, discretization to a sample grid (merge coincident taps,
    renormalize), and the COST259 standard profiles (3GPP TR 25.943).
    Host-side numpy: this is static configuration computed once.
  * :class:`TdlChannel` — the constructor (profile discretization at the
    Jakes generator's ``Ts``) and the properties ``channel_profile``,
    ``num_taps`` and ``_fading_generator``.

``TdlChannel.corrupt_data`` and the block-FIR backends are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..utils.conversion import dB2Linear, linear2dB
from .fading_generators import JakesSampleGenerator

__all__ = ["TdlChannelProfile", "TdlChannel", "COST259_TUx", "COST259_RAx",
           "COST259_HTx"]


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


class TdlChannel:
    """Tapped-delay-line channel: a discretized power-delay profile driven
    by a Jakes fading generator whose first shape axis is the (sparse)
    tap count."""

    def __init__(self, fading_generator: JakesSampleGenerator,
                 channel_profile: Optional[TdlChannelProfile] = None,
                 tap_powers_dB: Optional[np.ndarray] = None,
                 tap_delays: Optional[np.ndarray] = None,
                 Ts: Optional[float] = None) -> None:
        if not isinstance(fading_generator, JakesSampleGenerator):
            raise TypeError("TdlChannel takes a JakesSampleGenerator (the "
                            "Rayleigh generator is not ported yet)")
        if Ts is None:
            Ts = fading_generator.Ts
        elif Ts != fading_generator.Ts:
            raise RuntimeError(
                "The provided sampling interval Ts is different from "
                "the one in the Jakes sample generator.")

        if channel_profile is None:
            channel_profile = TdlChannelProfile(tap_powers_dB, tap_delays)

        if not channel_profile.is_discretized:
            channel_profile = channel_profile.get_discretize_profile(Ts)
        elif channel_profile.Ts != Ts:
            raise RuntimeError(
                "Channel profile is already discretized, but it does not "
                "agree with the provided Ts")

        self._channel_profile = channel_profile
        self._fading_generator = fading_generator
        self._set_fading_generator_shape(fading_generator.shape)

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

    @property
    def channel_profile(self) -> TdlChannelProfile:
        return self._channel_profile

    @property
    def num_taps(self) -> int:
        """Number of NONZERO (sparse) taps."""
        return self._channel_profile.num_taps
