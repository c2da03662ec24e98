"""Multiuser precoding: water-filling and batched block diagonalization."""

from . import batched, waterfilling  # noqa: F401
from .batched import (bd_blocks_no_power_batched,  # noqa: F401
                      bd_precoders_batched, bd_receive_filter_batched)
from .waterfilling import doWF, doWF_jit  # noqa: F401
