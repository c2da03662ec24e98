"""Thermal noise power: a copy of ``pyphysim_tpu/channels/noise.py``."""

from __future__ import annotations

import scipy.constants

from ..utils.conversion import linear2dBm

__all__ = ["calc_thermal_noise_power_dBm", "calc_thermal_noise_power"]


def calc_thermal_noise_power_dBm(T: float, delta_f: float) -> float:
    """Thermal noise power (dBm) in bandwidth ``delta_f`` (Hz) at
    temperature ``T`` (Kelvin): ``k T delta_f``."""
    return float(linear2dBm(calc_thermal_noise_power(T, delta_f)))


def calc_thermal_noise_power(T: float, delta_f: float) -> float:
    """Thermal noise power (Watts) in bandwidth ``delta_f`` at
    temperature ``T``."""
    return float(scipy.constants.Boltzmann * T * delta_f)
