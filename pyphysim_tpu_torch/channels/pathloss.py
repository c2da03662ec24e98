"""Path loss models.

Counterpart of ``pyphysim_tpu/channels/pathloss.py``: positive dB losses,
optional log-normal shadowing, small-distance handling, linear scale
helpers and ``which_distance`` inverses.

Every deterministic formula takes numpy inputs (host numbers / arrays) or
tensors (on their device). Shadowing of a tensor draws from an explicit
``torch.Generator``; on the host it uses numpy's global generator, as the
JAX package does.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Union

import numpy as np
import torch

from ..utils import conversion

__all__ = ["PathLossBase", "PathLossIndoorBase", "PathLossOutdoorBase",
           "PathLossGeneral", "PathLossFreeSpace", "PathLoss3GPP1",
           "PathLossMetisPS7", "PathLossOkomuraHata"]

NumberOrArray = Union[float, np.ndarray, torch.Tensor]


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


class PathLossBase:
    """Base path loss model: deterministic loss + optional shadowing.

    Subclasses implement ``_calc_deterministic_path_loss_dB`` and
    ``which_distance_dB``.
    """

    TYPE = "base"

    def __init__(self) -> None:
        self.sigma_shadow = 8.0         # dB
        self.use_shadow_bool = False
        self.handle_small_distances_bool = False

    @property
    def type(self) -> str:
        """'indoor' or 'outdoor' (parity: pathloss.py:93-96)."""
        return self.TYPE

    # -- subclass API ------------------------------------------------------

    def _calc_deterministic_path_loss_dB(
            self, d: NumberOrArray, **kwargs: Any
    ) -> NumberOrArray:  # pragma: no cover - abstract
        raise NotImplementedError

    def which_distance_dB(
            self, PL: NumberOrArray
    ) -> NumberOrArray:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- public API --------------------------------------------------------

    def calc_path_loss_dB(
            self, d: NumberOrArray,
            shadow_generator: Optional[torch.Generator] = None,
            **kwargs: Any) -> NumberOrArray:
        """Positive path loss in dB for distance(s) ``d``; adds Gaussian
        shadowing when enabled (from ``shadow_generator`` for a tensor)."""
        PL = self._calc_deterministic_path_loss_dB(d, **kwargs)
        if isinstance(PL, torch.Tensor):
            if self.use_shadow_bool:
                PL = PL + self.sigma_shadow * torch.randn(
                    PL.shape, generator=shadow_generator, dtype=PL.dtype,
                    device=PL.device)
            # a tensor is clamped (the reference's handle_small_distances)
            return torch.clamp(PL, min=0.0)
        if self.use_shadow_bool:
            PL = PL + self.sigma_shadow * np.random.standard_normal(
                np.shape(PL) if np.ndim(PL) else ())
        PL = np.asarray(PL, dtype=float)
        if np.any(PL < 0):
            if self.handle_small_distances_bool:
                PL = np.where(PL < 0, 0.0, PL)
            else:
                raise RuntimeError(
                    "The distance is too small to calculate a valid path "
                    "loss.")
        if PL.ndim == 0:
            return float(PL)
        return PL

    def calc_path_loss(self, d: NumberOrArray,
                       **kwargs: Any) -> NumberOrArray:
        """Path loss in LINEAR scale (a gain < 1)."""
        return conversion.dB2Linear(-self.calc_path_loss_dB(d, **kwargs))

    def which_distance(self, pl: NumberOrArray) -> NumberOrArray:
        """Distance yielding the given LINEAR path loss."""
        return self.which_distance_dB(-conversion.linear2dB(pl))

    def plot_deterministic_path_loss_in_dB(self, d, ax=None,
                                           extra_args=None):
        """Plot the deterministic path loss curve (matplotlib)."""
        import matplotlib.pyplot as plt
        stand_alone = ax is None
        if ax is None:
            _, ax = plt.subplots()
        ax.plot(d, self._calc_deterministic_path_loss_dB(d),
                **(extra_args or {}))
        ax.set_xlabel("Distance")
        ax.set_ylabel("Path Loss (in dB)")
        if stand_alone:
            plt.show()
        return ax


class PathLossIndoorBase(PathLossBase):
    """Base class for indoor path loss models (pathloss.py:345-517)."""

    TYPE = "indoor"


class PathLossOutdoorBase(PathLossBase):
    """Base class for outdoor path loss models (pathloss.py:518-668)."""

    TYPE = "outdoor"


class PathLossGeneral(PathLossOutdoorBase):
    """``PL = 10 n log10(d) + C`` with d in Km (pathloss.py:669-816)."""

    TYPE = "outdoor"

    def __init__(self, n: float, C: float) -> None:
        super().__init__()
        self._n = float(n)
        self._C = float(C)

    @property
    def n(self) -> float:
        return self._n

    @property
    def C(self) -> float:
        return self._C

    def _calc_deterministic_path_loss_dB(self, d, **kwargs):
        xp = _xp(d)
        return 10.0 * self._n * xp.log10(d) + self._C

    def which_distance_dB(self, PL):
        return 10.0 ** ((PL - self._C) / (10.0 * self._n))

    def _get_latex_repr(self) -> str:
        return (f"$PL = {10 * self._n:.6g} \\log_{{10}} (d) + "
                f"{self._C:.6g}$")

    _repr_latex_ = _get_latex_repr


class PathLossFreeSpace(PathLossGeneral):
    """Free space loss ``(4 pi d / lambda)^n`` with d in Km, fc in MHz
    (pathloss.py:818-975)."""

    def __init__(self, n: float = 2.0, fc: float = 900.0) -> None:
        self._fc = float(fc)
        super().__init__(n, self._calculate_C_from_fc_and_n(fc, n))

    @staticmethod
    def _calculate_C_from_fc_and_n(fc: float, n: float) -> float:
        # 4.377911390697565 = log10(c / (4 pi)) - 3 (d in Km)
        return 10.0 * n * (math.log10(fc * 1e6) - 4.377911390697565)

    @property
    def fc(self) -> float:
        return self._fc

    @fc.setter
    def fc(self, value: float) -> None:
        self._fc = float(value)
        self._C = self._calculate_C_from_fc_and_n(self._fc, self._n)

    @property
    def n(self) -> float:
        return self._n

    @n.setter
    def n(self, value: float) -> None:
        self._n = float(value)
        self._C = self._calculate_C_from_fc_and_n(self._fc, self._n)


class PathLoss3GPP1(PathLossGeneral):
    """3GPP TR 25.814 macro-cell: ``128.1 + 37.6 log10(d_km)``
    (pathloss.py:977-1020)."""

    def __init__(self) -> None:
        super().__init__(n=3.76, C=128.1)


class PathLossMetisPS7(PathLossIndoorBase):
    """METIS project Propagation Scenario 7 (indoor office,
    pathloss.py:1022-1346): ``PL = A log10(d) + B + 20 log10(fc/5) + X``
    with d in METERS and fc in GHz; LOS (num_walls == 0):
    A=18.7, B=46.8, X=0; NLOS: A=36.8, B=43.8, X=5(n_w - 1)."""

    TYPE = "indoor"

    def __init__(self, fc: float = 900.0) -> None:
        super().__init__()
        self._fc = float(fc)  # in MHz, like the other models

    @property
    def fc(self) -> float:
        return self._fc

    @fc.setter
    def fc(self, value: float) -> None:
        self._fc = float(value)

    def _fc_ghz(self) -> float:
        return self._fc / 1e3

    @staticmethod
    def get_latex_repr(num_walls: Optional[int] = None) -> str:
        """LaTeX equation ``PL = A log10(d) + B + C log10(fc/5) + X`` with
        the coefficients for the given wall count (LOS when 0, NLOS when
        > 0, symbolic when None; parity: pathloss.py:1081-1121 — whose X
        disagrees with its own path loss formula at pathloss.py:1302; we
        print the actual ``5(n_w - 1)`` the model computes)."""
        if num_walls is None:
            a, b, c, x = "A", "B", "C", "X"
        elif num_walls == 0:
            a, b, c, x = "18.7", "46.8", "20", "0"
        elif num_walls > 0:
            a, b, c, x = "36.8", "43.8", "20", str(5 * (num_walls - 1))
        else:
            raise ValueError("num_walls cannot be negative")
        return (f"${a} \\log_{{10}}(d) + {b} + {c} \\log_{{10}}(f_c/5)"
                f" + {x}$")

    def _calc_PS7_path_loss_dB_LOS_same_floor(self, d):
        xp = _xp(d)
        return (18.7 * xp.log10(d) + 46.8 +
                20.0 * math.log10(self._fc_ghz() / 5.0))

    def _calc_PS7_path_loss_dB_NLOS_same_floor(self, d, num_walls=1):
        xp = _xp(d)
        return (36.8 * xp.log10(d) + 43.8 +
                20.0 * math.log10(self._fc_ghz() / 5.0) +
                5.0 * (num_walls - 1))

    def _calc_deterministic_path_loss_dB(self, d, num_walls=0, **kwargs):
        if isinstance(num_walls, (int, np.integer)):
            if num_walls == 0:
                return self._calc_PS7_path_loss_dB_LOS_same_floor(d)
            if num_walls < 0:
                raise ValueError("num_walls cannot be negative")
            return self._calc_PS7_path_loss_dB_NLOS_same_floor(d, num_walls)
        if isinstance(d, torch.Tensor) or \
                isinstance(num_walls, torch.Tensor):
            d_b, walls = torch.broadcast_tensors(torch.as_tensor(d),
                                                 torch.as_tensor(num_walls))
            xp = torch
        else:
            xp = np
            d_b, walls = np.broadcast_arrays(np.asarray(d),
                                             np.asarray(num_walls))
        los = self._calc_PS7_path_loss_dB_LOS_same_floor(d_b)
        nlos = self._calc_PS7_path_loss_dB_NLOS_same_floor(d_b, walls)
        return xp.where(walls == 0, los, nlos)

    def which_distance_dB(self, PL, num_walls: int = 0):
        if num_walls == 0:
            return 10.0 ** ((PL - 46.8 -
                             20.0 * math.log10(self._fc_ghz() / 5.0)) / 18.7)
        return 10.0 ** ((PL - 43.8 - 5.0 * (num_walls - 1) -
                         20.0 * math.log10(self._fc_ghz() / 5.0)) / 36.8)


class PathLossOkomuraHata(PathLossOutdoorBase):
    """Okomura-Hata urban/suburban/open model (pathloss.py:1348+).

    ``L = A + B log10(d)`` (urban), minus area corrections for suburban /
    open areas; d in Km between 1 and 20, fc in MHz between 150 and 1500.
    """

    TYPE = "outdoor"
    _VALID_AREA_TYPES = ("open", "suburban", "medium city", "large city")

    def __init__(self) -> None:
        super().__init__()
        self._hbs = 30.0         # base station height (m), 30..200
        self._hms = 1.0          # mobile height (m), 1..10
        self._fc = 900.0         # carrier (MHz), 150..1500
        self._area_type = "suburban"

    # -- validated properties ---------------------------------------------

    @property
    def fc(self) -> float:
        return self._fc

    @fc.setter
    def fc(self, value: float) -> None:
        if not 150.0 <= value <= 1500.0:
            raise RuntimeError(
                "The carrier frequency for the Okomura Hata model must be "
                "between 150 and 1500 (values in MHz).")
        self._fc = float(value)

    @property
    def hbs(self) -> float:
        return self._hbs

    @hbs.setter
    def hbs(self, value: float) -> None:
        if not 30.0 <= value <= 200.0:
            raise RuntimeError(
                "The base station height for the Okomura Hata model must "
                "be between 30 and 200 (values in meters).")
        self._hbs = float(value)

    @property
    def hms(self) -> float:
        return self._hms

    @hms.setter
    def hms(self, value: float) -> None:
        if not 1.0 <= value <= 10.0:
            raise RuntimeError(
                "The mobile station height for the Okomura Hata model "
                "must be between 1 and 10 (values in meters).")
        self._hms = float(value)

    @property
    def area_type(self) -> str:
        return self._area_type

    @area_type.setter
    def area_type(self, value: str) -> None:
        if value not in self._VALID_AREA_TYPES:
            raise RuntimeError(f"Invalid area type: {value}")
        self._area_type = value

    # -- model -------------------------------------------------------------

    def _calc_mobile_antenna_gain(self) -> float:
        log_fc = math.log10(self._fc)
        if self._area_type == "large city":
            if self._fc > 300.0:
                return 3.2 * math.log10(11.75 * self._hms) ** 2 - 4.97
            return 8.29 * math.log10(1.54 * self._hms) ** 2 - 1.1
        return ((1.1 * log_fc - 0.7) * self._hms -
                (1.56 * log_fc - 0.8))

    def _calc_A(self) -> float:
        return (69.55 + 26.16 * math.log10(self._fc) -
                13.82 * math.log10(self._hbs) -
                self._calc_mobile_antenna_gain())

    def _calc_B(self) -> float:
        return 44.9 - 6.55 * math.log10(self._hbs)

    def _area_correction(self) -> float:
        log_fc = math.log10(self._fc)
        if self._area_type == "open":
            return 40.94 + 4.78 * log_fc ** 2 - 18.33 * log_fc
        if self._area_type == "suburban":
            return 2.0 * (math.log10(self._fc / 28.0)) ** 2 + 5.4
        return 0.0  # urban (medium/large city)

    def _calc_deterministic_path_loss_dB(self, d, **kwargs):
        xp = _xp(d)
        return (self._calc_A() + self._calc_B() * xp.log10(d) -
                self._area_correction())

    def which_distance_dB(self, PL):
        return 10.0 ** ((PL + self._area_correction() - self._calc_A()) /
                        self._calc_B())
