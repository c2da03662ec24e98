"""Export helpers: pgfplots (LaTeX) and MATLAB."""

from .matlab import to_mat_str  # noqa: F401
from .pgfplotshelper import (generate_pgfplots_plotline,  # noqa: F401
                             ber_plot_options, ser_plot_options)
