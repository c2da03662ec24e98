"""Antenna gain models: a copy of ``pyphysim_tpu/channels/antennagain.py``
whose angles (degrees off boresight) are numpy arrays, tensors or
floats."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.conversion import dB2Linear

__all__ = ["AntGainBase", "AntGainOmni", "AntGainBS3GPP25996"]


class AntGainBase:
    """Base antenna model: gain (linear) as a function of the angle (in
    degrees) off boresight."""

    def get_antenna_gain(self, angle):  # pragma: no cover - abstract
        raise NotImplementedError("Implement in a subclass")


class AntGainOmni(AntGainBase):
    """Omnidirectional antenna with a fixed gain (dBi)."""

    def __init__(self, ant_gain: Optional[float] = None) -> None:
        self.ant_gain = 1.0 if ant_gain is None else float(
            dB2Linear(ant_gain))

    def get_antenna_gain(self, angle):
        if isinstance(angle, torch.Tensor):
            return torch.full_like(angle, self.ant_gain,
                                   dtype=torch.float32) if angle.dim() \
                else self.ant_gain
        if np.ndim(angle):
            return self.ant_gain * np.ones(np.shape(angle))
        return self.ant_gain


class AntGainBS3GPP25996(AntGainBase):
    """3GPP TR 25.996 sectorized base-station pattern:
    gain_dB = -min(12 (theta/theta_3dB)^2, Am) + peak gain."""

    def __init__(self, number_of_sectors: int = 3) -> None:
        if number_of_sectors == 3:
            self.theta_3db, self.Am = 70.0, 20.0
            self.ant_gain = float(dB2Linear(14.0))
        elif number_of_sectors == 6:
            self.theta_3db, self.Am = 35.0, 23.0
            self.ant_gain = float(dB2Linear(17.0))
        else:
            raise ValueError(
                f"Invalid number of sectors: {number_of_sectors}")

    def get_antenna_gain(self, angle):
        att = 12.0 * (angle / self.theta_3db) ** 2
        att_dB = (torch.clamp(att, max=self.Am)
                  if isinstance(att, torch.Tensor)
                  else np.minimum(att, self.Am))
        return self.ant_gain * 10.0 ** (-att_dB / 10.0)
