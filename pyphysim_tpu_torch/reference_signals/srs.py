"""SRS (Sounding Reference Signal) sequences: a copy of
``pyphysim_tpu/reference_signals/srs.py`` (host numpy)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .root_sequence import RootSequence
from .zadoffchu import get_shifted_root_seq

__all__ = ["get_srs_seq", "UeSequence", "SrsUeSequence"]


def get_srs_seq(root_seq: np.ndarray, n_cs: int) -> np.ndarray:
    """Shifted root sequence with the SRS denominator (8)
    (srs.py:23-48)."""
    return get_shifted_root_seq(root_seq, n_cs, 8)


class UeSequence:
    """Per-user reference-signal sequence (srs.py:51-263)."""

    def __init__(self, root_seq: RootSequence, n_cs: int,
                 user_seq_array: np.ndarray,
                 normalize: bool = False) -> None:
        self._n_cs = n_cs
        self._root_index = root_seq.index
        self._normalized = bool(normalize)
        if normalize:
            ref = user_seq_array if user_seq_array.ndim == 1 \
                else user_seq_array[0]
            user_seq_array = user_seq_array / np.linalg.norm(ref)
        self._user_seq_array = user_seq_array

    @property
    def normalized(self) -> bool:
        return self._normalized

    @property
    def size(self) -> int:
        return self.seq_array().size

    @property
    def shape(self):
        return self.seq_array().shape

    def seq_array(self) -> np.ndarray:
        return self._user_seq_array

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
        return (f"<{self.__class__.__name__}(root_index={self._root_index},"
                f" n_cs={self._n_cs})>")


class SrsUeSequence(UeSequence):
    """SRS sequence of one user: root sequence with cyclic shift
    n_cs in 0..7 (srs.py:265-330)."""

    def __init__(self, root_seq: RootSequence, n_cs: int,
                 normalize: bool = False) -> None:
        user_seq = get_srs_seq(root_seq.seq_array(), n_cs)
        super().__init__(root_seq, n_cs, user_seq, normalize=normalize)
