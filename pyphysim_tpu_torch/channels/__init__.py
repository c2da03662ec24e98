"""Fading channels: TDL profiles, impulse responses and channels; the
Jakes and Rayleigh generators; the flat-fading multiuser channel matrix
(with external interference too); path loss models."""

from .fading import (COST259_HTx, COST259_RAx, COST259_TUx,  # noqa: F401
                     TdlChannel, TdlChannelProfile, TdlImpulseResponse)
from .fading_generators import (FadingSampleGenerator,  # noqa: F401
                                JakesSampleGenerator, JakesState,
                                RayleighSampleGenerator, RayleighState,
                                generate_jakes_samples)
from .multiuser import (MultiUserChannelMatrix,  # noqa: F401
                        MultiUserChannelMatrixExtInt)
