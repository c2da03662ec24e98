"""Modulators: PSK / QPSK / BPSK / QAM, OFDM and its one-tap equalizer."""

from .fundamental import BPSK, PSK, QAM, QPSK, Modulator  # noqa: F401
from .ofdm import OFDM, OfdmOneTapEqualizer  # noqa: F401
