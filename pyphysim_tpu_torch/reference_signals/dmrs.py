"""DMRS (Demodulation Reference Signal) sequences: a copy of
``pyphysim_tpu/reference_signals/dmrs.py`` (host numpy)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .root_sequence import RootSequence
from .srs import UeSequence
from .zadoffchu import get_shifted_root_seq

__all__ = ["get_dmrs_seq", "DmrsUeSequence"]


def get_dmrs_seq(root_seq: np.ndarray, n_cs: int) -> np.ndarray:
    """Shifted root sequence with the DMRS denominator (12)
    (dmrs.py:19-41)."""
    return get_shifted_root_seq(root_seq, n_cs, 12)


class DmrsUeSequence(UeSequence):
    """DMRS sequence of one user, with optional orthogonal cover code:
    with OCC ``[1, -1]`` the user sends ``seq`` in slot 0 and ``-seq`` in
    slot 1 (dmrs.py:44-110)."""

    def __init__(self, root_seq: RootSequence, n_cs: int,
                 cover_code: Optional[np.ndarray] = None,
                 normalize: bool = False) -> None:
        user_seq = get_dmrs_seq(root_seq.seq_array(), n_cs)
        self._occ = cover_code
        if cover_code is not None:
            user_seq = user_seq * np.asarray(cover_code)[:, np.newaxis]
        super().__init__(root_seq, n_cs, user_seq, normalize=normalize)

    @property
    def cover_code(self) -> Optional[np.ndarray]:
        return self._occ

    @property
    def size(self) -> int:
        if self._occ is None:
            return self._user_seq_array.shape[0] if \
                self._user_seq_array.ndim == 1 else \
                self._user_seq_array.shape[-1]
        return self._user_seq_array.shape[1]
