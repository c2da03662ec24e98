"""LTE-style reference signals: Zadoff-Chu sequences, root sequences,
SRS/DMRS user sequences (host numpy), CAZAC-based channel estimation
(numpy or tensors)."""

from .channel_estimation import (CazacBasedChannelEstimator,  # noqa: F401
                                 CazacBasedWithOCCChannelEstimator)
from .dmrs import DmrsUeSequence, get_dmrs_seq  # noqa: F401
from .root_sequence import RootSequence  # noqa: F401
from .srs import SrsUeSequence, UeSequence, get_srs_seq  # noqa: F401
from .zadoffchu import (calcBaseZC, get_extended_ZF,  # noqa: F401
                        get_shifted_root_seq)
