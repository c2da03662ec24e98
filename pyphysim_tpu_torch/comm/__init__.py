"""Multiuser precoding: water-filling, block diagonalization (host solvers
and their batched counterparts, the external-interference family
included)."""

from . import batched, blockdiagonalization, waterfilling  # noqa: F401
from .batched import (bd_blocks_no_power_batched,  # noqa: F401
                      bd_precoders_batched, bd_receive_filter_batched,
                      enhanced_bd_batched, whitening_bd_batched,
                      whitening_matrix_batched)
from .blockdiagonalization import (BDWithExtIntBase,  # noqa: F401
                                   BlockDiagonalizer, EnhancedBD,
                                   WhiteningBD,
                                   block_diagonalize,
                                   calc_receive_filter)
from .waterfilling import doWF, doWF_jit  # noqa: F401
