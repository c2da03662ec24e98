"""Numeric utilities: conversions, bit counting, JSON serialization, and
the seed replay of stochastic tests (``utils.testing``)."""
