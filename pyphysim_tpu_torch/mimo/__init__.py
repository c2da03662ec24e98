"""MIMO schemes: Blast, MRC, MRT, SVD, GMD, Alamouti."""

from .mimo import (MRC, MRT, Alamouti, Blast, GMDMimo,  # noqa: F401
                   MimoBase, SVDMimo, calc_post_processing_SINRs,
                   calc_post_processing_linear_SINRs)
