"""Modulators: OFDM."""

from .ofdm import OFDM  # noqa: F401
