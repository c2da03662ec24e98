"""Zadoff-Chu sequence primitives.

A copy of ``pyphysim_tpu/reference_signals/zadoffchu.py``:
root sequence ``exp(-j pi u n (n+1+2q) / Nzc)`` (zadoffchu.py:11-36),
cyclic shifts (zadoffchu.py:39-72) and cyclic extension
(zadoffchu.py:75-114). Host numpy (sequence construction is one-time
configuration); device code converts with ``torch.as_tensor``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["calcBaseZC", "get_shifted_root_seq", "get_extended_ZF"]


def calcBaseZC(Nzc: int, u: int, q: complex = 0) -> np.ndarray:
    """Root Zadoff-Chu sequence of size ``Nzc`` with root index ``u``."""
    if u >= Nzc:
        raise ValueError("u must be lower than Nzc")
    n = np.arange(Nzc)
    return np.exp((-1j * np.pi * u * n * (n + 1 + 2 * q)) / Nzc)


def get_shifted_root_seq(root_seq: np.ndarray, n_cs: int,
                         denominator: int) -> np.ndarray:
    """Apply cyclic shift ``n_cs`` (a progressive phase ramp
    ``exp(j 2 pi n_cs m / denominator)``); denominator is 8 for SRS and
    12 for DMRS."""
    if not 0 <= abs(n_cs) < denominator:
        raise ValueError("n_cs must be between 0 and denominator-1")
    m = np.arange(root_seq.size)
    alpha_m = 2 * np.pi * n_cs / denominator
    return np.exp(1j * alpha_m * m) * root_seq


def get_extended_ZF(root_seq: np.ndarray, size: int) -> np.ndarray:
    """Cyclically extend ``root_seq`` to ``size`` elements.

    Examples
    --------
    >>> import numpy as np
    >>> get_extended_ZF(np.array([1, 2, 3, 4, 5]), 8)
    array([1, 2, 3, 4, 5, 1, 2, 3])
    """
    n = root_seq.size
    reps = size // n + 1
    return np.tile(root_seq, reps)[:size]
