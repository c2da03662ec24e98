"""Single-user TDL channels with a path loss.

Counterpart of ``pyphysim_tpu/channels/singleuser.py``: :class:`SuChannel`
wraps a :class:`~.fading.TdlChannel` and applies a scalar linear path loss
(``sqrt(pl)`` on the output signal and on the impulse response);
:class:`SuMimoChannel` is its (N x N) MIMO form. Both expose the
functional (explicit-state) API of the channel and the stateful
convenience form.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .._device import DeviceLike
from .fading import TdlChannel, TdlChannelProfile, TdlImpulseResponse
from .fading_generators import RayleighSampleGenerator

__all__ = ["SuChannel", "SuMimoChannel"]


class SuChannel:
    """Single-user TDL channel with an optional scalar path loss.
    ``device`` places the default Rayleigh generator (a given generator
    brings its own)."""

    def __init__(self, fading_generator=None,
                 channel_profile: Optional[TdlChannelProfile] = None,
                 tap_powers_dB: Optional[np.ndarray] = None,
                 tap_delays: Optional[np.ndarray] = None,
                 Ts: Optional[float] = None,
                 device: DeviceLike = "cuda") -> None:
        if fading_generator is None:
            fading_generator = RayleighSampleGenerator(device=device)
            if Ts is None and channel_profile is None and \
                    tap_delays is None:
                Ts = 1.0
        self._tdlchannel = TdlChannel(fading_generator,
                                      channel_profile=channel_profile,
                                      tap_powers_dB=tap_powers_dB,
                                      tap_delays=tap_delays, Ts=Ts)
        self._pathloss_value: Optional[float] = None

    # -- configuration -----------------------------------------------------

    def set_pathloss(self, pathloss_value: Optional[float] = None) -> None:
        """Set the linear path loss in (0, 1] applied to this channel (None:
        none)."""
        if pathloss_value is not None and not 0 < pathloss_value <= 1:
            raise ValueError(
                "Pathloss must be a positive value lower than or equal "
                "to 1")
        self._pathloss_value = pathloss_value

    @property
    def pathloss_value(self) -> Optional[float]:
        return self._pathloss_value

    def set_num_antennas(self, num_rx_antennas: Optional[int],
                         num_tx_antennas: Optional[int]) -> None:
        self._tdlchannel.set_num_antennas(num_rx_antennas, num_tx_antennas)

    @property
    def switched_direction(self) -> bool:
        return self._tdlchannel.switched_direction

    @switched_direction.setter
    def switched_direction(self, value: bool) -> None:
        self._tdlchannel.switched_direction = value

    @property
    def channel_profile(self) -> TdlChannelProfile:
        return self._tdlchannel.channel_profile

    @property
    def num_taps(self) -> int:
        return self._tdlchannel.num_taps

    @property
    def num_taps_with_padding(self) -> int:
        return self._tdlchannel.num_taps_with_padding

    @property
    def num_tx_antennas(self) -> Optional[int]:
        return self._tdlchannel.num_tx_antennas

    @property
    def num_rx_antennas(self) -> Optional[int]:
        return self._tdlchannel.num_rx_antennas

    def _scale(self) -> float:
        return (math.sqrt(self._pathloss_value)
                if self._pathloss_value is not None else 1.0)

    # -- functional API ----------------------------------------------------

    def init_state(self, source):
        return self._tdlchannel.init_state(source)

    def corrupt_data(self, state_or_signal, signal=None):
        """Functional ``(state, signal) -> (out, ir, state)`` or stateful
        ``(signal) -> out``; the path loss scales the output and the
        impulse response."""
        scale = self._scale()
        if signal is None:
            out = self._tdlchannel.corrupt_data(state_or_signal)
            self._apply_pathloss_to_last_ir()
            return out * scale
        out, ir, state = self._tdlchannel.corrupt_data(state_or_signal,
                                                       signal)
        return out * scale, ir * scale, state

    def corrupt_data_in_freq_domain(self, state_or_signal, signal=None,
                                    fft_size=None, carrier_indexes=None):
        """The frequency-domain form of :meth:`corrupt_data` (the
        arguments of :meth:`TdlChannel.corrupt_data_in_freq_domain`)."""
        scale = self._scale()
        if signal is None or isinstance(signal, int):
            out = self._tdlchannel.corrupt_data_in_freq_domain(
                state_or_signal, signal, fft_size, carrier_indexes)
            self._apply_pathloss_to_last_ir()
            return out * scale
        out, ir, state = self._tdlchannel.corrupt_data_in_freq_domain(
            state_or_signal, signal, fft_size, carrier_indexes)
        return out * scale, ir * scale, state

    def _apply_pathloss_to_last_ir(self) -> None:
        ir = self._tdlchannel.get_last_impulse_response()
        if ir is not None and self._pathloss_value is not None:
            self._tdlchannel._last_impulse_response = ir * self._scale()

    def seed(self, seed: int) -> None:
        self._tdlchannel.seed(seed)

    def get_last_impulse_response(self) -> Optional[TdlImpulseResponse]:
        return self._tdlchannel.get_last_impulse_response()


class SuMimoChannel(SuChannel):
    """Single-user MIMO channel with N x N antennas. As in the JAX package,
    a given generator's shape is set to ``(N, N)``."""

    def __init__(self, N: int, fading_generator=None,
                 channel_profile: Optional[TdlChannelProfile] = None,
                 tap_powers_dB: Optional[np.ndarray] = None,
                 tap_delays: Optional[np.ndarray] = None,
                 Ts: Optional[float] = None,
                 device: DeviceLike = "cuda") -> None:
        if fading_generator is None:
            fading_generator = RayleighSampleGenerator(shape=(N, N),
                                                       device=device)
            if Ts is None and channel_profile is None and \
                    tap_delays is None:
                Ts = 1.0
        else:
            fading_generator.shape = (N, N)
        super().__init__(fading_generator, channel_profile=channel_profile,
                         tap_powers_dB=tap_powers_dB,
                         tap_delays=tap_delays, Ts=Ts, device=device)
