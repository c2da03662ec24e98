"""Fading channels: TDL profiles, impulse responses and channels (SISO
and MIMO); the Jakes and Rayleigh generators; the single-user and
multiuser TDL channels; the flat-fading multiuser channel matrix (with
external interference too); path loss, antenna gain and thermal noise
models."""

from .fading import (COST259_HTx, COST259_RAx, COST259_TUx,  # noqa: F401
                     TdlChannel, TdlChannelProfile, TdlImpulseResponse,
                     TdlMimoChannel)
from .fading_generators import (FadingSampleGenerator,  # noqa: F401
                                JakesSampleGenerator, JakesState,
                                RayleighSampleGenerator, RayleighState,
                                generate_jakes_samples,
                                jakes_state_from_numpy)
from .multiuser import (MuChannel, MuMimoChannel,  # noqa: F401
                        MultiUserChannelMatrix,
                        MultiUserChannelMatrixExtInt)
from .singleuser import SuChannel, SuMimoChannel  # noqa: F401
