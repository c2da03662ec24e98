"""Power-delay profiles of the benchmark's configurations, from their files.

A configuration's ``channel`` names its profile: ``"table"`` gives the tap
powers (dB) and delays (s) as published; ``"exponential"`` gives the IEEE
802.11 exponential-decay profile (Chayat, IEEE P802.11-97/96) by its rms
delay spread and tap spacing. :func:`raw_profile` returns the published
taps, which both the program (``TdlChannelProfile``) and the plain reference
are given; :func:`discretize` is the reference's own rounding of them to the
sampling grid.

Frozen copies, from commit 8958300:

  * :func:`exponential_profile`: ``chip_smoke.py:2439-2446`` (taps every
    ``ts``, power exp(-k ts / trms) for k <= 10 trms / ts);
  * :func:`discretize`: ``pyphysim_tpu_torch/channels/fading.py:132-148``
    (delays rounded to the grid, coincident taps merged, power normalised
    to 1).

Imports only numpy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def exponential_profile(trms: float, ts: float) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """(tap powers in dB, tap delays in s) of the exponential profile."""
    k = np.arange(int(round(10 * trms / ts)) + 1)
    return 10 * np.log10(np.exp(-k * ts / trms)), k * ts


def raw_profile(channel: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """A configuration's ``channel`` entry as (powers dB, delays s)."""
    kind = channel["profile"]
    if kind == "table":
        return (np.asarray(channel["tap_powers_dB"], float),
                np.asarray(channel["tap_delays_s"], float))
    if kind == "exponential":
        return exponential_profile(float(channel["trms_s"]),
                                   float(channel["tap_spacing_s"]))
    raise ValueError(f"unknown profile kind {kind!r}")


def discretize(powers_dB: np.ndarray, delays_s: np.ndarray,
               ts: float) -> Tuple[np.ndarray, np.ndarray]:
    """(tap delays in samples, increasing; tap powers, linear, summing to
    1) on the grid of ``ts``."""
    idx, inverse = np.unique(np.round(delays_s / ts).astype(int).ravel(),
                             return_inverse=True)
    powers = np.zeros(idx.size)
    np.add.at(powers, inverse.ravel(), 10.0 ** (powers_dB / 10.0))
    return idx, powers / powers.sum()
