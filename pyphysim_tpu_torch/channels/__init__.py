"""Fading channels: TDL profiles and the Jakes generator."""

from .fading import (COST259_HTx, COST259_RAx, COST259_TUx,  # noqa: F401
                     TdlChannel, TdlChannelProfile)
from .fading_generators import JakesSampleGenerator, JakesState  # noqa: F401
