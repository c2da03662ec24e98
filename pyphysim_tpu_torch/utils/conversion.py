"""Unit conversions and bit-level codecs.

Counterpart of ``pyphysim_tpu/utils/conversion.py`` (behavioral parity with
dB2Linear/linear2dB, Gray codes, SNR<->EbN0 and the matrix-of-matrices
views). Every function takes python numbers, numpy arrays or torch tensors;
the elementwise ones keep the input's kind (a tensor stays a tensor on its
device).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

NumberOrArray = Union[int, float, np.ndarray, torch.Tensor]

__all__ = [
    "dB2Linear",
    "linear2dB",
    "dBm2Linear",
    "linear2dBm",
    "binary2gray",
    "gray2binary",
    "SNR_dB_to_EbN0_dB",
    "EbN0_dB_to_SNR_dB",
    "single_matrix_to_matrix_of_matrices",
    "blocks_to_single_matrix",
]


def dB2Linear(value_in_dB: NumberOrArray) -> NumberOrArray:
    """Convert a power value from decibels to linear scale.

    Examples
    --------
    >>> float(dB2Linear(30.0))
    1000.0
    >>> float(dB2Linear(0.0))
    1.0
    """
    if _is_host(value_in_dB):
        return 10.0 ** (np.asarray(value_in_dB) / 10.0)
    return 10.0 ** (value_in_dB / 10.0)


def linear2dB(value_in_linear: NumberOrArray) -> NumberOrArray:
    """Convert a linear power value to decibels."""
    if _is_host(value_in_linear):
        return 10.0 * np.log10(np.asarray(value_in_linear))
    return 10.0 * torch.log10(value_in_linear)


def dBm2Linear(value_in_dBm: NumberOrArray) -> NumberOrArray:
    """Convert dBm to linear Watts: ``10**(dBm/10) / 1000``."""
    return dB2Linear(value_in_dBm) / 1000.0


def linear2dBm(value_in_linear: NumberOrArray) -> NumberOrArray:
    """Convert linear Watts to dBm: ``10 log10(1000 * W)``."""
    if _is_host(value_in_linear):
        return 10.0 * np.log10(1000.0 * np.asarray(value_in_linear))
    return 10.0 * torch.log10(1000.0 * value_in_linear)


def binary2gray(num: NumberOrArray) -> NumberOrArray:
    """Binary-reflected Gray code of integer(s): ``n ^ (n >> 1)``.

    Examples
    --------
    >>> import numpy as np
    >>> binary2gray(np.arange(4))
    array([0, 1, 3, 2])
    """
    return num ^ (num >> 1)


def gray2binary(num: NumberOrArray) -> NumberOrArray:
    """Inverse Gray code via iterated xor-shift (valid for < 64-bit ints)."""
    out = num
    shift = 1
    while shift < 64:
        out = out ^ (out >> shift)
        shift *= 2
    return out


def SNR_dB_to_EbN0_dB(SNR: NumberOrArray, bits_per_symb: int) -> NumberOrArray:
    """Es/N0 in dB -> Eb/N0 in dB for a ``2**bits_per_symb``-ary modulator."""
    return linear2dB(dB2Linear(SNR) / float(bits_per_symb))


def EbN0_dB_to_SNR_dB(EbN0: NumberOrArray, bits_per_symb: int) -> NumberOrArray:
    """Eb/N0 in dB -> Es/N0 in dB for a ``2**bits_per_symb``-ary modulator."""
    return linear2dB(dB2Linear(EbN0) * float(bits_per_symb))


def single_matrix_to_matrix_of_matrices(single_matrix,
                                        nrows=None,
                                        ncols=None):
    """Split a block matrix into an object-array of blocks.

    Given per-block row sizes ``nrows`` and column sizes ``ncols``, return a
    numpy object array ``out[r, c]`` holding block ``(r, c)``. If only one
    of nrows/ncols is given, a 1-D object array of row-blocks (or
    column-blocks) is returned. Host-side helper kept for API parity.
    """
    single_matrix = np.asarray(single_matrix)
    if nrows is None and ncols is None:
        raise ValueError("nrows and ncols cannot both be None")

    if nrows is None:
        cum_c = np.concatenate(([0], np.cumsum(ncols)))
        out = np.empty(len(ncols), dtype=object)
        for c in range(len(ncols)):
            out[c] = single_matrix[..., cum_c[c]:cum_c[c + 1]]
        return out
    if ncols is None:
        cum_r = np.concatenate(([0], np.cumsum(nrows)))
        out = np.empty(len(nrows), dtype=object)
        for r in range(len(nrows)):
            out[r] = single_matrix[cum_r[r]:cum_r[r + 1]]
        return out

    cum_r = np.concatenate(([0], np.cumsum(nrows)))
    cum_c = np.concatenate(([0], np.cumsum(ncols)))
    out = np.empty((len(nrows), len(ncols)), dtype=object)
    for r in range(len(nrows)):
        for c in range(len(ncols)):
            out[r, c] = single_matrix[cum_r[r]:cum_r[r + 1],
                                      cum_c[c]:cum_c[c + 1]]
    return out


def blocks_to_single_matrix(blocks) -> np.ndarray:
    """Assemble a dense ``(K*Nr, L*Nt)`` matrix from a ``(K, L, Nr, Nt)``
    block tensor — the inverse view used by the dense multiuser channel."""
    blocks = np.asarray(blocks)
    K, L, Nr, Nt = blocks.shape
    return blocks.transpose(0, 2, 1, 3).reshape(K * Nr, L * Nt)


def _is_host(x) -> bool:
    """True when ``x`` is a plain python number / numpy array (not a
    tensor)."""
    return isinstance(x, (int, float, np.ndarray, np.generic))
