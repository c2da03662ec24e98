"""Alamouti 2x1 QPSK Monte Carlo kernel: one CUDA kernel simulates whole
repetitions over flat Rayleigh fading, from random bits to bit-error counts.

Counterpart of ``pyphysim_tpu/ops/alamouti_pallas.py``
``MonteCarloAlamouti``. This module holds the builder's checks, the plain
PyTorch version of the kernel's math (``simulate_block_reference``, a
step-for-step mirror of ``_simulate_block``), and the wrappers that launch
the CUDA kernel ``ops/csrc/mc_alamouti.cu`` (its source note says what
bounds it on the card and what its design does about that).

Each (row, lane) element of a tile is one Alamouti codeword (a symbol
pair); a lane is an independent channel stream whose ``h`` is drawn once per
repetition and shared by all of its tiles. Two bit sources:

  * PRNG mode (:meth:`MonteCarloAlamouti.build`): Philox4x32-10 streams of
    the absolute attempt (layout in ``ops/philox.py``), drawn in registers
    by the kernel and by ``philox.alamouti_stream_bits`` for the plain
    version.
  * Inject mode (:meth:`MonteCarloAlamouti.build_inject`): bits are inputs
    in the JAX layout, ch (reps, 8, lane) and d / n1r / n1i / n2r / n2i
    (reps, num_tiles * tile, lane), so the port and the JAX kernel see
    identical bits in the tests.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel, or raises: there is no fallback.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .._device import DeviceLike, require_cuda
from . import philox
from .mc_kernel import _as_bits, _u11

__all__ = ["MonteCarloAlamouti", "from_jax_attrs"]

_CLIP = 0.99999994
_THREADS = 256        # mc_alamouti.cu kThreads: lanes per block
_GROUP_ROWS = 32      # mc_alamouti.cu kGroupRows: rows per thread


def _gauss(bits: torch.Tensor) -> torch.Tensor:
    """erfinv of the clamped uniform: N(0, 1/2) per part."""
    return torch.erfinv(torch.clamp(_u11(bits), -_CLIP, _CLIP))


class MonteCarloAlamouti:
    """Builder for the single-kernel Alamouti 2x1 QPSK Monte Carlo
    repetition: ``tile`` codeword rows x ``lane`` channel streams per tile,
    ``num_tiles`` tiles per repetition sharing one channel draw per lane.
    Symbols per call: ``reps * num_tiles * tile * lane * 2``.
    ``launch_count`` counts CUDA kernel launches and ``reference_count``
    calls of the plain version.
    """

    def __init__(self, tile: int = 256, lane: int = 512,
                 device: DeviceLike = "cuda") -> None:
        if tile < 8 or tile % 8:
            raise ValueError("tile must be a multiple of 8")
        if lane < 128 or lane % 128:
            raise ValueError("lane must be a multiple of 128")
        self.device = require_cuda(device)
        self.tile = int(tile)
        self.lane = int(lane)
        self.launch_count = 0
        self.reference_count = 0

    @property
    def symbols_per_grid_step(self) -> int:
        return self.tile * self.lane * 2

    @staticmethod
    def amp(snr_linear: float) -> float:
        """Per-component noise std ``sqrt(0.5 / snr)`` in float32."""
        return float(np.float32(math.sqrt(0.5 / snr_linear)))

    def prng_kernel_profile(self, reps: int, num_tiles: int
                            ) -> Dict[str, object]:
        """What ``ops/sass.py`` needs to count one PRNG-mode call's
        instructions: the kernel's mangled-name pattern, the threads
        launched, and its loops (none: the 32 rows are unrolled)."""
        lanes = -(-self.lane // _THREADS) * _THREADS
        groups = -(-self.tile // _GROUP_ROWS)
        return {"pattern": r"mc_alamouti_kernelILb0EE",
                "threads": reps * num_tiles * groups * lanes,
                "loops": 0, "loop_trips": 1}

    # ------------------------------------------------------------------
    # The plain PyTorch version
    # ------------------------------------------------------------------

    def simulate_block_reference(self, ch_bits, d_bits, n1r_bits, n1i_bits,
                                 n2r_bits, n2i_bits,
                                 amp: float) -> torch.Tensor:
        """All the physics, from random bits to bit-error counts, in plain
        tensor code on the bits' device.

        ch_bits: (reps, >= 4, lane) int32, rows h1.re, h1.im, h2.re, h2.im
        d / n*_bits: (reps, num_tiles * tile, lane) int32
        Returns (reps, num_tiles) int32 error counts. Mirrors
        ``alamouti_pallas.py _simulate_block`` step for step.
        """
        self.reference_count += 1
        f32 = torch.float32
        reps = ch_bits.shape[0]
        num_tiles = d_bits.shape[1] // self.tile
        h1r, h1i, h2r, h2i = (_gauss(ch_bits[:, i:i + 1, :])
                              for i in range(4))
        idx = d_bits & 15
        c = np.float32(1.0 / math.sqrt(2.0))
        s1r = (1 - 2 * (idx & 1)).to(f32) * c
        s1i = (1 - 2 * ((idx >> 1) & 1)).to(f32) * c
        s2r = (1 - 2 * ((idx >> 2) & 1)).to(f32) * c
        s2i = (1 - 2 * ((idx >> 3) & 1)).to(f32) * c
        sqrt2 = np.float32(math.sqrt(2.0))
        n1r, n1i, n2r, n2i = (_gauss(b) * sqrt2 for b in
                              (n1r_bits, n1i_bits, n2r_bits, n2i_bits))
        # received samples, power-split encode
        r1r = (h1r * s1r - h1i * s1i + h2r * s2r - h2i * s2i) * c + \
            amp * n1r
        r1i = (h1r * s1i + h1i * s1r + h2r * s2i + h2i * s2r) * c + \
            amp * n1i
        r2r = (-(h1r * s2r + h1i * s2i) + h2r * s1r + h2i * s1i) * c + \
            amp * n2r
        r2i = (-(h1i * s2r - h1r * s2i) + (h2i * s1r - h2r * s1i)) * c + \
            amp * n2i
        # matched combining: d1 = h1* r1 + h2 r2*, d2 = h2* r1 - h1 r2*
        d1r = h1r * r1r + h1i * r1i + h2r * r2r + h2i * r2i
        d1i = h1r * r1i - h1i * r1r - (h2r * r2i - h2i * r2r)
        d2r = h2r * r1r + h2i * r1i - (h1r * r2r + h1i * r2i)
        d2i = h2r * r1i - h2i * r1r + (h1r * r2i - h1i * r2r)
        decided = ((d1r < 0).to(torch.int32) |
                   ((d1i < 0).to(torch.int32) << 1) |
                   ((d2r < 0).to(torch.int32) << 2) |
                   ((d2i < 0).to(torch.int32) << 3))
        diff = idx ^ decided
        errs = (diff & 1) + ((diff >> 1) & 1) + ((diff >> 2) & 1) + \
            ((diff >> 3) & 1)
        return errs.reshape(reps, num_tiles, -1).sum(
            dim=2, dtype=torch.int64).to(torch.int32)

    def prng_bits(self, reps: int, num_tiles: int, seed: int, start: int):
        """The PRNG-mode bits of attempts ``[start, start + reps)``: ch
        (reps, 4, lane) and d / n1r / n1i / n2r / n2i
        (reps, num_tiles * tile, lane), int32 (the layout the kernel draws
        in registers)."""
        attempts = torch.arange(start, start + reps, dtype=torch.int64,
                                device=self.device)
        return philox.alamouti_stream_bits(seed, attempts, num_tiles,
                                           self.tile, self.lane)

    def prng_reference(self, reps: int, num_tiles: int, seed: int,
                       amp: float, start: int = 0) -> torch.Tensor:
        """The plain version in PRNG mode: the kernel's bits through
        :meth:`simulate_block_reference`."""
        return self.simulate_block_reference(
            *self.prng_bits(reps, num_tiles, seed, start), amp)

    # ------------------------------------------------------------------
    # Builders: the kernel on CUDA, the plain version on the CPU
    # ------------------------------------------------------------------

    def build(self, reps: int, num_tiles: int, mesh=None,
              axis: str = "mc"):
        """``run(seed, snr_linear, start=0) -> (reps, num_tiles) int32``
        error counts on ``self.device``, every bit drawn from the Philox
        streams of attempts ``[start, start + reps)``. On CUDA the result
        is returned without synchronising.

        ``mesh``: a ``DeviceMesh`` to split the rep axis over (``reps``
        divisible by its ``axis`` size): rank ``i`` runs its ``reps /
        size`` reps from ``start + i * reps / size`` and the rows are
        all-gathered in rank order, bit for bit the unsharded call's."""
        _check_grid(reps, num_tiles)
        if mesh is not None:
            from ..parallel.mesh import shard_prng_build
            return shard_prng_build(self.build, reps, num_tiles, mesh, axis,
                                    start_arg=2)

        def run(seed: int, snr_linear: float, start: int = 0):
            amp = self.amp(snr_linear)
            if self.device.type == "cuda":
                return self._launch_prng(reps, num_tiles, int(seed), amp,
                                         int(start))
            if self.device.type == "cpu":
                return self.prng_reference(reps, num_tiles, int(seed), amp,
                                           int(start))
            raise RuntimeError(f"no route for device {self.device}")

        return run

    def build_inject(self, reps: int, num_tiles: int, mesh=None,
                     axis: str = "mc"):
        """``run(ch_bits, d_bits, n1r, n1i, n2r, n2i, amp) ->
        (reps, num_tiles) int32`` with the randomness supplied in the JAX
        layout: ch (reps, >= 4, lane), the rest (reps, num_tiles * tile,
        lane). Numpy uint32 arrays are moved to ``self.device``; tensors
        keep their device, which picks the route.

        ``mesh``: split the rep axis as in :meth:`build`; each rank takes
        its rows of the bit tensors and the rows are all-gathered."""
        _check_grid(reps, num_tiles)
        if mesh is not None:
            from ..parallel.mesh import shard_inject_build
            return shard_inject_build(self.build_inject, reps, num_tiles,
                                      mesh, axis, num_bits=6)

        def run(ch_bits, d_bits, n1r, n1i, n2r, n2i, amp):
            bits = [_as_bits(b, self.device)
                    for b in (ch_bits, d_bits, n1r, n1i, n2r, n2i)]
            self._check_inject_shapes(reps, num_tiles, bits)
            amp = float(np.float32(amp))
            dev = bits[0].device
            if dev.type == "cuda":
                return self._launch_inject(reps, num_tiles, bits, amp)
            if dev.type == "cpu":
                return self.simulate_block_reference(*bits, amp)
            raise RuntimeError(f"no route for device {dev}")

        return run

    def _check_inject_shapes(self, reps, num_tiles, bits) -> None:
        ch, rest = bits[0], bits[1:]
        if ch.dim() != 3 or ch.shape[0] != reps or ch.shape[1] < 4 or \
                ch.shape[2] != self.lane:
            raise ValueError(f"channel bits must be (reps={reps}, >=4, "
                             f"{self.lane}), got {tuple(ch.shape)}")
        want = (reps, num_tiles * self.tile, self.lane)
        for b in rest:
            if tuple(b.shape) != want:
                raise ValueError(f"data/noise bits must be {want}, got "
                                 f"{tuple(b.shape)}")
        if any(b.device != ch.device for b in rest):
            raise ValueError("all bit tensors must be on one device")

    # ------------------------------------------------------------------
    # CUDA launches
    # ------------------------------------------------------------------

    def _launch_prng(self, reps, num_tiles, seed, amp, start):
        from . import _build
        lib = _build.load()
        out = torch.zeros((reps, num_tiles), dtype=torch.int32,
                          device=self.device)
        rc = lib.mc_alamouti_prng(
            out.data_ptr(), reps, num_tiles, self.tile, self.lane, amp,
            seed & 0xFFFFFFFF, start,
            torch.cuda.current_stream(self.device).cuda_stream)
        _build.check(rc, "mc_alamouti_prng")
        self.launch_count += 1
        return out

    def _launch_inject(self, reps, num_tiles, bits, amp):
        from . import _build
        ch, d = bits[0], bits[1]
        lib = _build.load()
        out = torch.zeros((reps, num_tiles), dtype=torch.int32,
                          device=ch.device)
        rc = lib.mc_alamouti_inject(
            *(b.data_ptr() for b in bits), out.data_ptr(), reps, num_tiles,
            self.tile, self.lane, amp, ch.stride(0), ch.stride(1),
            d.stride(0), d.stride(1),
            torch.cuda.current_stream(ch.device).cuda_stream)
        _build.check(rc, "mc_alamouti_inject")
        self.launch_count += 1
        return out


def _check_grid(reps: int, num_tiles: int) -> None:
    if reps < 1 or num_tiles < 1:
        raise ValueError("reps and num_tiles must be positive")


def from_jax_attrs(d: Dict[str, object],
                   device: DeviceLike = "cuda") -> MonteCarloAlamouti:
    """The port's builder from a JAX ``MonteCarloAlamouti``'s attributes
    (``vars(mc)``: ``_tile``, ``_lane``). The kernel has no weights, so
    this is all its state."""
    return MonteCarloAlamouti(tile=int(d["_tile"]), lane=int(d["_lane"]),
                              device=device)
