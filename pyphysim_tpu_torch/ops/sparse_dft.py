"""The sparse DFT matrix that turns a TDL channel's sparse taps into its
frequency response at chosen bins.

``W[i, k] = exp(-2 pi j d_i b_k / n)`` for tap delays ``d_i`` and bins
``b_k`` on an ``n``-point grid, with the rows of taps at ``d_i >= n`` set to
zero (numpy's FFT truncation, as the JAX package does). Built in float64 on
the host, stored as complex64 on the device, and cached: the channel, the
equalizer, the FFT block convolution and the fused path call it every step
with the same static geometry, and a fresh host-to-device copy would make
the host wait for the device each time.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

__all__ = ["sparse_dft"]


def sparse_dft(tap_indexes: Sequence[int], bins: Sequence[int], n: int,
               device) -> torch.Tensor:
    """(T, len(bins)) complex64 matrix on ``device`` (see the module
    docstring). The result is shared between callers: do not modify it."""
    return _cached(tuple(int(d) for d in tap_indexes),
                   tuple(int(b) for b in bins), int(n), torch.device(device))


@functools.lru_cache(maxsize=64)
def _cached(idx, bins, n, device) -> torch.Tensor:
    d = np.asarray(idx)
    phase = (-2.0 * np.pi / n) * np.outer(d, np.asarray(bins))
    keep = (d < n)[:, None]
    return torch.tensor((np.exp(1j * phase) * keep).astype(np.complex64),
                        device=device)
