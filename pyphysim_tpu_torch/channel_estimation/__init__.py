"""Channel estimation algorithms: LS and MMSE estimates and their
theoretical mean squared errors."""

from .estimators import (compute_ls_estimation,  # noqa: F401
                         compute_mmse_estimation,
                         compute_theoretical_ls_MSE,
                         compute_theoretical_mmse_MSE)
