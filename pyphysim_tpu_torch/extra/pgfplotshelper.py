"""pgfplots (LaTeX) export helpers.

Counterpart of ``pyphysim_tpu/extra/pgfplotshelper.py`` (host numpy).
"""

from __future__ import annotations

from typing import Collection, Optional

import numpy as np

__all__ = ["generate_pgfplots_plotline", "ber_plot_options",
           "ser_plot_options"]


def generate_pgfplots_plotline(x: Collection[float], y: Collection[float],
                               errors: Optional[np.ndarray] = None,
                               options: Optional[str] = None,
                               legend: Optional[str] = None) -> str:
    """A pgfplots ``\\addplot`` command for the given data, optionally with
    y error bars (``errors`` is the full bar length) and a legend entry.

    >>> print(generate_pgfplots_plotline([1, 2], [3, 4], legend="a"))
    \\addplot[]
    plot[]
    coordinates{(1, 3)
    (2, 4)};
    \\addlegendentry{a};
    """
    points = list(zip(x, y))
    if errors is None:
        points_string = "\n".join(str(p) for p in points)
        plot_line = f"plot[]\ncoordinates{{{points_string}}};"
    else:
        errs = np.asarray(errors) / 2.0
        entries = [f"{p} +- (0.0, {e})" for p, e in zip(points, errs)]
        points_string = "\n".join(entries)
        plot_line = ("plot[error bars/.cd, y dir = both, y explicit]\n"
                     f"coordinates{{{points_string}}};")
    out = f"\\addplot[{options or ''}]\n{plot_line}"
    if legend is not None:
        out += f"\n\\addlegendentry{{{legend}}};"
    return out


def ber_plot_options(color: str = "blue") -> str:
    """The option string of a BER curve."""
    return f"color={color}, solid, mark=square, mark options={{solid}}"


def ser_plot_options(color: str = "red") -> str:
    """The option string of a SER curve."""
    return f"color={color}, densely dashed, mark=o, mark options={{solid}}"
