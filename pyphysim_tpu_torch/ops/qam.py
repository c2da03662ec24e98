"""Square Gray-mapped M-QAM on tensors: the map from indices to points, one
pass on the card, and the plain hard decision.

The point of index ``(r << h) | c`` (``h`` = half the bits, ``L =
sqrt(M)``) sits at grid position ``(gray(r), gray(c))``, scaled to unit
average energy: real part ``(2 gray(c) - (L - 1)) / scale``, imaginary part
``((L - 1) - 2 gray(r)) / scale``, ``scale = sqrt(2 (M - 1) / 3)``
(``modulators.QAM``'s constellation).

  * :func:`qam_map` (indices -> complex64 points; ``QAM.modulate``'s tensor
    route): on CUDA tensors one launch of a hand-written kernel
    (``ops/csrc/qam.cu``), on CPU tensors the plain version; any other
    device raises. There is no fallback from one to the other. A launch
    synchronises nothing and allocates only its output, so a CUDA graph
    captures it.
  * :func:`qam_map_reference`, the plain PyTorch version on any device:
    the arithmetic the port ran op by op before the kernel (about 15
    element-wise launches), which the kernel rounds float32 operation by
    float32 operation as torch does, so the two agree bit for bit.
  * :func:`qam_slice`, the plain decision (``QAM.demodulate_hard``, and
    the slicer of the plain versions of ``ops.mimo_detect``'s kernels). On
    the card a step decides and counts in one launch: ``ChainStep`` through
    ``ops.mimo_detect.sc_decide`` with a unit gain.

Shapes and dtypes: ``qam_map(indices, M, gain=None)`` takes integer indices
of any shape (int64 on the card; other integer types are converted) and
returns complex64 points of that shape; with ``gain`` (a python float, the
MIMO step's 1 / sqrt(Nt) split) each point is also multiplied by it, as
``points * gain`` rounds it. ``M`` is a square QAM order.

``qam_map.launch_count`` counts kernel launches, ``.reference_count``
calls of the plain version; a replayed chain step advances
``launch_count`` by its captured launches (``counted_kernels``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["qam_map", "qam_map_reference", "qam_slice"]


def _half_bits(M: int) -> int:
    """Bits a real axis of square ``M``-QAM (up to 2**30); raises for any
    other ``M``."""
    half = int(round(math.log2(M))) // 2 if M >= 4 else 0
    if half < 1 or half > 15 or (1 << (2 * half)) != M:
        raise ValueError(f"M must be a square QAM order from 4 to 2**30, "
                         f"got {M}")
    return half


def _scale(M: int) -> float:
    """``sqrt(2 (M - 1) / 3)``, the python float ``QAM`` divides by."""
    return math.sqrt((M - 1) * 2.0 / 3.0)


def qam_map(indices: torch.Tensor, M: int,
            gain: Optional[float] = None) -> torch.Tensor:
    """Complex64 points of ``indices`` (the module docstring): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    _half_bits(M)
    if indices.dtype.is_floating_point or indices.dtype.is_complex:
        raise TypeError(f"qam_map takes integer indices, got {indices.dtype}")
    dev = indices.device
    if dev.type == "cpu":
        return qam_map_reference(indices, M, gain)
    if dev.type != "cuda":
        raise RuntimeError(f"qam_map: no route for device {dev}")
    from . import _build
    idx = indices.to(torch.int64).contiguous()
    points = torch.empty(idx.shape, dtype=torch.complex64, device=dev)
    if idx.numel() == 0:
        return points
    _build.check(_build.load().qam_map(
        idx.data_ptr(), points.data_ptr(), idx.numel(), int(M),
        float(np.float32(1.0 / _scale(M))),
        float(np.float32(1.0 if gain is None else gain)),
        int(gain is not None), torch.cuda.current_stream(dev).cuda_stream),
        "qam_map")
    qam_map.launch_count += 1
    return points


qam_map.launch_count = 0
qam_map.reference_count = 0


def qam_map_reference(indices: torch.Tensor, M: int,
                      gain: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`qam_map` on any device: the
    Gray codes of the index's column and row bits, the levels cast to
    float32 and multiplied by ``1 / scale`` (then by ``gain``)."""
    half = _half_bits(M)
    qam_map.reference_count += 1
    L = 1 << half
    col = indices & (L - 1)
    row = indices >> half
    jj = col ^ (col >> 1)
    ii = row ^ (row >> 1)
    inv_scale = 1.0 / _scale(M)
    re = (2 * jj - (L - 1)).to(torch.float32) * inv_scale
    im = ((L - 1) - 2 * ii).to(torch.float32) * inv_scale
    points = torch.complex(re, im)
    return points if gain is None else points * gain


def _inv_gray(p: torch.Tensor) -> torch.Tensor:
    """Inverse Gray code by xor-prefix, exact below 8 bits."""
    out = p
    sh = 1
    while sh < 8:
        out = out ^ (out >> sh)
        sh *= 2
    return out


def qam_slice(received: torch.Tensor, M: int) -> torch.Tensor:
    """Int64 indices of the hard decisions on ``received`` (complex): round
    I and Q to the nearest level (half to even, clipped), then rebuild the
    Gray-mapped index. The same decisions as the nearest-neighbour search
    (rectangular regions)."""
    half = _half_bits(M)
    L = 1 << half
    scale = _scale(M)
    col_pos = torch.clamp(torch.round(
        (received.real * scale + (L - 1)) / 2.0), 0, L - 1).to(torch.int64)
    row_pos = torch.clamp(torch.round(
        ((L - 1) - received.imag * scale) / 2.0), 0, L - 1).to(torch.int64)
    return (_inv_gray(row_pos) << half) | _inv_gray(col_pos)
