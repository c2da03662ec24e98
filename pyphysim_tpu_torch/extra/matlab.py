"""MATLAB array export.

Counterpart of ``pyphysim_tpu/extra/matlab.py`` (host numpy).
"""

from __future__ import annotations

import numpy as np

__all__ = ["to_mat_str"]


def to_mat_str(x: np.ndarray, format_string: str = "+.12e") -> str:
    """String representation of a 1-D or 2-D array pasteable into MATLAB:
    ``[a, b; c, d]`` with ';' separating rows.

    >>> to_mat_str(np.array([[1, 2], [3, 4]]), "d")
    '[1, 2; 3, 4]'
    >>> to_mat_str(np.array([0.5 - 1j]), ".1f")
    '[0.5-1.0j]'
    """
    x = np.atleast_2d(np.asarray(x))
    if x.ndim > 2:
        raise ValueError("to_mat_str only supports 1D and 2D arrays")
    imag_format = "+" + format_string.lstrip("+")

    def fmt(v) -> str:
        if np.iscomplexobj(x):
            return f"{v.real:{format_string}}{v.imag:{imag_format}}j"
        return f"{v:{format_string}}"

    rows = [", ".join(fmt(v) for v in row) for row in x]
    return "[" + "; ".join(rows) + "]"
