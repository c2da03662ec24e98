"""Block-static sparse-tap FIR: each row of ``x_blocks`` (R, block_size)
convolved with its own sparse complex kernel ``taps`` (R, T) at static
offsets ``d_0 < ... < d_{T-1}``, giving (R, block_size + D - 1) with
``D = d_{T-1} + 1``.

Counterpart of ``pyphysim_tpu/ops/fir_pallas.py`` ``block_fir``. Three
versions of one function:

  * :func:`block_fir`, the wrapper: on CUDA tensors it launches the
    hand-written kernel ``ops/csrc/block_fir.cu`` (its source note says what
    bounds it and what its design does about that), on CPU tensors it runs
    the plain version. There is no fallback from one to the other.
  * :func:`block_fir_reference`, the plain PyTorch version: one shifted
    multiply-add per tap, as the TPU kernel's body does.
  * :func:`block_fir_fft`, the per-block FFT convolution (the JAX package's
    XLA route): any circular length >= block_size + D - 1 gives the same
    linear convolution.

``block_fir.launch_count`` counts kernel launches and
``block_fir.reference_count`` calls of the plain version, so a run can show
which one it went through.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .sparse_dft import sparse_dft

__all__ = ["block_fir", "block_fir_reference", "block_fir_fft",
           "MAX_TAPS", "MAX_BLOCK_SIZE"]

MAX_TAPS = 64              # the kernel's offsets struct
MAX_BLOCK_SIZE = 6144      # the kernel stages a row in 48 KB of shared memory


def _check(x_blocks: torch.Tensor, taps: torch.Tensor,
           tap_offsets: Sequence[int], block_size: int) -> Tuple[int, ...]:
    offsets = tuple(int(d) for d in tap_offsets)
    if x_blocks.dim() != 2 or x_blocks.shape[1] != block_size:
        raise ValueError(f"x_blocks must be (R, {block_size}), got "
                         f"{tuple(x_blocks.shape)}")
    if taps.dim() != 2 or taps.shape != (x_blocks.shape[0], len(offsets)):
        raise ValueError(f"taps must be (R, T) = ({x_blocks.shape[0]}, "
                         f"{len(offsets)}), got {tuple(taps.shape)}")
    if not offsets or offsets[0] < 0 or \
            any(b <= a for a, b in zip(offsets, offsets[1:])):
        raise ValueError("tap_offsets must be increasing and non-negative")
    if taps.device != x_blocks.device:
        raise ValueError("x_blocks and taps must be on one device")
    return offsets


def block_fir(x_blocks: torch.Tensor, taps: torch.Tensor,
              tap_offsets: Sequence[int], block_size: int) -> torch.Tensor:
    """Convolve each row of ``x_blocks`` (R, block_size) with its own
    sparse kernel ``taps`` (R, T) at static ``tap_offsets``; returns
    (R, block_size + D - 1) complex64 on the inputs' device. The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    offsets = _check(x_blocks, taps, tap_offsets, block_size)
    dev = x_blocks.device
    if dev.type == "cuda":
        return _launch(x_blocks, taps, offsets, block_size)
    if dev.type == "cpu":
        return block_fir_reference(x_blocks, taps, offsets, block_size)
    raise RuntimeError(f"no route for device {dev}")


block_fir.launch_count = 0
block_fir.reference_count = 0


def block_fir_reference(x_blocks: torch.Tensor, taps: torch.Tensor,
                        tap_offsets: Sequence[int],
                        block_size: int) -> torch.Tensor:
    """The plain PyTorch version: ``y[:, d_i : d_i + block_size] +=
    taps[:, i] * x`` for each tap, as ``fir_pallas._kernel`` does."""
    offsets = _check(x_blocks, taps, tap_offsets, block_size)
    block_fir.reference_count += 1
    x = x_blocks.to(torch.complex64)
    t = taps.to(torch.complex64)
    y = x.new_zeros((x.shape[0], block_size + offsets[-1]))
    for i, d in enumerate(offsets):
        y[:, d:d + block_size] += t[:, i:i + 1] * x
    return y


def block_fir_fft(x_blocks: torch.Tensor, taps: torch.Tensor,
                  tap_offsets: Sequence[int],
                  block_size: int) -> torch.Tensor:
    """The same convolution per block in the frequency domain: circular
    length ``L`` = block_size + D - 1 rounded up to a multiple of 128 (as
    the JAX package's route), kernel spectrum from the sparse taps."""
    offsets = _check(x_blocks, taps, tap_offsets, block_size)
    out_len = block_size + offsets[-1]
    L = ((out_len + 127) // 128) * 128
    X = torch.fft.fft(x_blocks.to(torch.complex64), n=L)
    H = taps.to(torch.complex64) @ sparse_dft(offsets, range(L), L,
                                              x_blocks.device)
    return torch.fft.ifft(X * H)[:, :out_len]


def _launch(x_blocks: torch.Tensor, taps: torch.Tensor,
            offsets: Tuple[int, ...], block_size: int) -> torch.Tensor:
    from . import _build
    if x_blocks.dtype != torch.complex64 or taps.dtype != torch.complex64:
        raise TypeError("the block_fir kernel takes complex64 tensors")
    if len(offsets) > MAX_TAPS or block_size > MAX_BLOCK_SIZE:
        raise ValueError(f"the block_fir kernel takes at most {MAX_TAPS} "
                         f"taps and block_size <= {MAX_BLOCK_SIZE}")
    x = x_blocks.contiguous()
    t = taps.contiguous()
    rows = x.shape[0]
    y = torch.empty((rows, block_size + offsets[-1]), dtype=torch.complex64,
                    device=x.device)
    host_offsets = (ctypes.c_int * len(offsets))(*offsets)
    lib = _build.load()
    rc = lib.block_fir(x.data_ptr(), t.data_ptr(), y.data_ptr(), rows,
                       block_size, len(offsets),
                       ctypes.cast(host_offsets, ctypes.c_void_p),
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "block_fir")
    block_fir.launch_count += 1
    return y
