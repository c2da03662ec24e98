"""The work a kernel's call needs, from the call's shapes alone, and the
card's peaks: the least time a call could take, whatever implements it.

Frozen copies, from commit 8958300: :func:`mc_flops` of ``chip_smoke.py:
407-412`` (the flagship function's T-deep complex product, 8 T operations a
symbol and used bin, and its ray sums, 2 a symbol row and (tap, ray) pair),
the flagship's bytes of ``chip_smoke.py:2484`` (G_tap read once, the counts
written once) and :func:`fir_bytes` of ``chip_smoke.py:448-451`` (x and the
taps read once, y written once, complex64). The block FIR's operations are
8 a sample, tap and row (one complex multiply-add).

The work leaves out what the function needs but a roofline of operations
cannot price (the Philox draws, the sines and cosines of the Jakes rays,
the inverse CDF of the noise), so a share of it can only read low.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The larger of operations over the f32 peak and bytes over HBM's."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


def mc_flops(reps: int, num_tiles: int, tile: int, taps: int, rays: int,
             used: int) -> int:
    """f32 operations of one flagship call of ``reps`` attempts."""
    rows = reps * num_tiles * tile
    return rows * (8 * taps * used + 2 * taps * rays)


def mc_bytes(reps: int, num_tiles: int, taps: int, used: int) -> int:
    """Bytes one flagship call must move: G_tap in, the counts out."""
    return 8 * taps * used + 4 * reps * num_tiles


def mc_least_seconds(reps: int, num_tiles: int, tile: int, taps: int,
                     rays: int, used: int) -> float:
    return least_seconds(mc_flops(reps, num_tiles, tile, taps, rays, used),
                         mc_bytes(reps, num_tiles, taps, used))


def fir_bytes(rows: int, block_size: int, offsets: Sequence[int]) -> int:
    """Bytes one block FIR call must move: x and the taps in, y out."""
    return 8 * rows * (block_size + len(offsets) + block_size + offsets[-1])


def fir_flops(rows: int, block_size: int, taps: int) -> int:
    return 8 * rows * block_size * taps


def fir_least_seconds(rows: int, block_size: int,
                      offsets: Sequence[int]) -> float:
    return least_seconds(fir_flops(rows, block_size, len(offsets)),
                         fir_bytes(rows, block_size, offsets))


def share_percent(work_seconds: float, device_seconds: float
                  ) -> Tuple[float, bool]:
    """(100 * least time / device time, whether there was device time)."""
    if device_seconds <= 0:
        return 0.0, False
    return 100.0 * work_seconds / device_seconds, True
