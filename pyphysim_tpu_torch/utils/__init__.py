"""Numeric utilities: conversions, bit counting, JSON serialization."""
