"""LTE root sequences.

A copy of ``pyphysim_tpu/reference_signals/root_sequence.py`` (host
numpy): for sizes above
two PRBs the root sequence is a Zadoff-Chu sequence of the largest prime
``Nzc <= size`` cyclically extended to ``size``; for sizes 12 and 24 the
3GPP TS 36.211 phi tables are used (``r(n) = exp(j pi/4 phi(n))``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .ts36211_tables import PHI_TABLE_SIZE_12, PHI_TABLE_SIZE_24
from .zadoffchu import calcBaseZC, get_extended_ZF

__all__ = ["RootSequence"]


def _largest_prime_leq(n: int) -> int:
    def is_prime(x: int) -> bool:
        if x < 2:
            return False
        if x % 2 == 0:
            return x == 2
        f = 3
        while f * f <= x:
            if x % f == 0:
                return False
            f += 2
        return True

    while n >= 2:
        if is_prime(n):
            return n
        n -= 1
    raise ValueError("No prime available")


class RootSequence:
    """Root sequence for SRS/DMRS reference signals."""

    n_sc_PRB = 12  # subcarriers per LTE physical resource block

    def __init__(self, root_index: int, size: Optional[int] = None,
                 Nzc: Optional[int] = None) -> None:
        if size is None and Nzc is None:
            raise AttributeError(
                "Either 'size' or 'Nzc' (or both) must be provided.")
        if size is None:
            size = Nzc
        if Nzc is None and size > 2 * self.n_sc_PRB:
            Nzc = _largest_prime_leq(size)
        if Nzc is not None and size < Nzc:
            raise AttributeError(
                "If 'size' and Nzc are provided, then size must be "
                "greater than Nzc")

        self._root_index = int(root_index)
        self._extended_seq_array: Optional[np.ndarray] = None

        if size > 2 * self.n_sc_PRB:
            self._Nzc = int(Nzc)
            self._seq_array = calcBaseZC(self._Nzc, self._root_index)
            if size > self._Nzc:
                self._extended_seq_array = get_extended_ZF(
                    self._seq_array, size)
        elif size == self.n_sc_PRB:
            self._Nzc = size
            self._seq_array = np.exp(
                1j * (np.pi / 4.0) * PHI_TABLE_SIZE_12[self._root_index])
        elif size == 2 * self.n_sc_PRB:
            self._Nzc = size
            self._seq_array = np.exp(
                1j * (np.pi / 4.0) * PHI_TABLE_SIZE_24[self._root_index])
        else:
            raise AttributeError("Invalid root sequence size")

    # -- properties --------------------------------------------------------

    @property
    def Nzc(self) -> int:
        """Size of the (unextended) Zadoff-Chu part."""
        return self._Nzc

    @property
    def size(self) -> int:
        """Size of the (possibly extended) sequence."""
        return self.seq_array().size

    @property
    def index(self) -> int:
        """The root sequence index."""
        return self._root_index

    def seq_array(self) -> np.ndarray:
        """The sequence (extended version when an extension exists)."""
        if self._extended_seq_array is not None:
            return self._extended_seq_array
        return self._seq_array

    # -- ndarray-ish conveniences -----------------------------------------

    def __getitem__(self, val):
        return self.seq_array()[val]

    def __add__(self, other):
        return self.seq_array() + other

    __radd__ = __add__

    def __mul__(self, other):
        return self.seq_array() * other

    __rmul__ = __mul__

    def conjugate(self) -> np.ndarray:
        return self.seq_array().conj()

    conj = conjugate

    def __repr__(self) -> str:
        return (f"<RootSequence(root_index={self._root_index}, "
                f"size={self.size}, Nzc={self._Nzc})>")
