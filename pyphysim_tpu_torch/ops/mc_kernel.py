"""Monte Carlo kernel of the flagship OFDM-over-TDL chain: one CUDA kernel
simulates whole repetitions, from random bits to bit-error counts.

Counterpart of ``pyphysim_tpu/ops/mc_pallas.py`` ``MonteCarloOfdmTdl``.
This module holds the host side (the constructor's checks, the constant
(tap, ray) -> bin matrix G built in float64 and stored in float32, the
Doppler coefficient ``C``, ``noise_gain``), the plain PyTorch version of
the kernel's math, and the wrappers that launch the CUDA kernel
``ops/csrc/mc_ofdm_tdl.cu`` (its source note says what bounds it on the
card and what its design does about that).

Per (rep, symbol tile) the chain is: Jakes ray phases -> phasor matrix
``E[s, il] = exp(j (t_s C cos(phi_il) + psi_il))`` -> per-bin channel
``H = E @ G`` -> Gray QAM symbols -> ``y = x H + amp n`` with post-demod
AWGN -> one-tap equalizer -> Gray slicer -> popcount of bit errors over the
used bins. Two algebraic collapses make this exact for a CP that covers the
channel span: the ray sum and the sparse tap DFT are one product with G,
and time-domain AWGN becomes post-demodulation AWGN with std scaled by
``noise_gain``. G's rows repeat within each tap (one row per tap, repeated
over its rays), so the kernel sums the rays of a tap first and multiplies
by ``G_tap`` (T, used): the same function with a product T deep instead of
TL (:meth:`MonteCarloOfdmTdl.channel_rays_first`). The plain version keeps
the TL-deep product of the JAX kernel.

``matmul_dtype`` is the JAX option of the same name: ``torch.bfloat16``
rounds E and G to bf16 (round to nearest even) and sums their products in
float32; a different result from float32 mode, held to its own parity.

Two bit sources, as in the JAX package:

  * PRNG mode (:meth:`MonteCarloOfdmTdl.build`): bits come from
    Philox4x32-10 keyed by ``(seed, stream)`` and the absolute attempt
    (layout in ``ops/philox.py``). The kernel draws them in registers; the
    plain version draws the same bits with ``ops/philox.py``.
  * Inject mode (:meth:`MonteCarloOfdmTdl.build_inject`): bits are inputs
    in the JAX layout — phase bits (reps, 8, TLp), data / noise bits
    (reps, num_tiles * tile, used_p) — so the port and the JAX kernel see
    identical bits in the tests.

The kernel takes every shape the JAX kernel takes
(:meth:`MonteCarloOfdmTdl.kernel_plan` says how a launch runs): its fast
instances hold up to 32 taps and 1,024 (tap, ray) pairs, its general
form any number of either, and a call of more than 65,535 reps or tiles
is cut into launches of at most that many of each
(:func:`launch_slices`), each from its own absolute attempt and first
tile, so bit for bit one launch under the Philox contract.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel, or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .._device import DeviceLike, require_cuda
from ..utils.misc import level2bits
from . import philox

__all__ = ["MonteCarloOfdmTdl", "from_jax_arrays", "launch_slices"]

_TWO_PI = 6.283185307179586
_MATMUL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CHUNK = 8          # G_tap's taps a chunk of the general form, and its
                    # taps padded to a multiple of this (kChunk)
_GRID_YZ = 65535    # reps / tiles a launch: the fast form's grid z / y
# mc_ofdm_tdl_plan's values, in order
_PLAN_KEYS = ("general", "rows", "bin_chunks", "threads", "smem_bytes",
              "scratch_bytes", "grid", "blocks", "taps_padded",
              "slot_floats", "chunk_taps", "group_rows")
# mc_ofdm_tdl_launch_info's values, in order
_INFO_KEYS = ("registers", "local_bytes", "static_smem_bytes",
              "blocks_per_sm")


def launch_slices(n: int) -> List[Tuple[int, int]]:
    """The ranges ``[a, b)`` of at most 65,535 (the fast form's grid z and
    y) that cut ``n`` reps or ``n`` tiles. A call launches once a pair of
    a rep range and a tile range: launch ``[r0, r1) x [t0, t1)`` writes
    ``out[r0:r1, t0:t1]``, reads the inject bits of those reps and tiles,
    starts at absolute attempt ``start + r0`` and at tile ``t0`` (the
    Philox counters and symbol times of the call's own tiles)."""
    return [(a, min(a + _GRID_YZ, n)) for a in range(0, n, _GRID_YZ)]


def _matmul_dtype(dtype) -> torch.dtype:
    """``torch.float32`` / ``torch.bfloat16`` or their names."""
    if isinstance(dtype, torch.dtype) and dtype in _MATMUL_DTYPES.values():
        return dtype
    if isinstance(dtype, str) and dtype in _MATMUL_DTYPES:
        return _MATMUL_DTYPES[dtype]
    raise ValueError(f"matmul_dtype must be torch.float32, torch.bfloat16, "
                     f"'float32' or 'bfloat16', got {dtype!r}")


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bf16 (ties to even), back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _ray_run(g_re: np.ndarray, g_im: np.ndarray) -> int:
    """The number of leading rows of G bit-identical to its first row: the
    rays of its first tap."""
    rows = np.concatenate([g_re, g_im], axis=1).view(np.uint32)
    n = 1
    while n < rows.shape[0] and np.array_equal(rows[n], rows[0]):
        n += 1
    return n


def _u01(bits: torch.Tensor) -> torch.Tensor:
    """int32 bits -> float32 uniform in [0, 1): the signed view scaled and
    shifted (mc_pallas.py ``_u01``)."""
    return bits.to(torch.float32) * 2.0 ** -32 + 0.5


def _u11(bits: torch.Tensor) -> torch.Tensor:
    """int32 bits -> float32 uniform in [-1, 1) (mc_pallas.py ``_u11``)."""
    return bits.to(torch.float32) * 2.0 ** -31


def _inv_gray(p: torch.Tensor) -> torch.Tensor:
    """Arithmetic inverse Gray code (xor-prefix), exact for < 8 bits."""
    out = p
    sh = 1
    while sh < 8:
        out = out ^ (out >> sh)
        sh *= 2
    return out


def _as_bits(x, device: torch.device) -> torch.Tensor:
    """Random bits as a contiguous int32 tensor (the signed view of each
    32-bit word). A numpy array is moved to ``device``; a tensor stays on
    its own device, which decides the wrapper's route."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
        return x.to(device)
    if x.dtype == torch.int64:
        x = philox.to_int32_bits(x & 0xFFFFFFFF)
    elif x.dtype == getattr(torch, "uint32", None):
        x = x.view(torch.int32)
    elif x.dtype != torch.int32:
        raise TypeError(f"random bits must be 32-bit integers, got {x.dtype}")
    return x.contiguous()


class MonteCarloOfdmTdl:
    """Builder for the single-kernel Monte Carlo repetition.

    Parameters mirror the flagship chain: a square-``M`` QAM
    constellation, an ``OFDM`` geometry and a ``TdlChannel`` with a Jakes
    generator whose CP covers the channel span. ``tile`` OFDM symbols are
    one grid step; a repetition is ``num_tiles`` consecutive tiles sharing
    one set of Jakes rays. ``launch_count`` counts CUDA kernel launches and
    ``reference_count`` calls of the plain version, so a run can show
    which one it went through.
    """

    def __init__(self, ofdm, channel, M: int = 16, tile: int = 256,
                 matmul_dtype=torch.float32,
                 device: DeviceLike = "cuda") -> None:
        profile = channel.channel_profile
        gen = channel._fading_generator
        if not hasattr(gen, "Fd"):
            raise ValueError("MonteCarloOfdmTdl requires a Jakes generator")
        span = int(profile.tap_delays.astype(int)[-1]) + 1
        if ofdm.cp_size < span - 1:
            raise ValueError(
                f"cp_size {ofdm.cp_size} < channel span - 1 ({span - 1})")

        used = ofdm.num_used_subcarriers
        delays = profile.tap_delays.astype(int)          # sample indices
        powers = profile.tap_powers_linear               # normalized to 1
        Lrays = gen.L
        TL = delays.size * Lrays
        bins = ofdm.get_used_subcarrier_indexes() % ofdm.fft_size
        phase = (-_TWO_PI / ofdm.fft_size) * np.outer(
            np.repeat(delays, Lrays), bins)              # (TL, used)
        w = np.repeat(np.sqrt(powers / Lrays), Lrays)[:, None]
        g_re = (w * np.cos(phase)).astype(np.float32)
        g_im = (w * np.sin(phase)).astype(np.float32)
        # per-OFDM-symbol phase advance coefficient: w_il = C cos(phi_il),
        # phase(s) = s * w_il + psi_il  (block-static per symbol)
        C = float(_TWO_PI * gen.Fd * gen.Ts * ofdm.samples_per_symbol)
        # post-demod equivalent AWGN std multiplier (exact)
        noise_gain = math.sqrt(ofdm.fft_size / ofdm._calculate_power_scale())
        self._set_state(g_re, g_im, C, noise_gain, M, tile, used, Lrays,
                        matmul_dtype, device)

    def _set_state(self, g_re, g_im, C, noise_gain, M, tile, used, rays,
                   matmul_dtype, device) -> None:
        Lq = int(round(math.sqrt(M)))
        if Lq * Lq != M or M & (M - 1):
            raise ValueError("M must be a square power of 2")
        if tile < 8 or tile & (tile - 1):
            raise ValueError("tile must be a power of two >= 8 "
                             "(the E matrix is built by row doubling)")
        if g_re.shape != g_im.shape or g_re.shape[1] != used:
            raise ValueError("G must be two (TL, used) arrays")
        TL = g_re.shape[0]
        if rays < 1 or TL % rays:
            raise ValueError(f"TL {TL} is not a multiple of the ray count "
                             f"{rays}")
        taps = TL // rays
        for g in (g_re, g_im):
            g = g.reshape(taps, rays, used).view(np.uint32)
            if not np.array_equal(g, np.broadcast_to(g[:, :1], g.shape)):
                raise ValueError("the rows of a tap of G differ: the rays "
                                 "of a tap must share one row")
        self.matmul_dtype = _matmul_dtype(matmul_dtype)
        self.device = require_cuda(device)
        self.M = int(M)
        self.bits_per_symbol = level2bits(M)
        self._half_bits = self.bits_per_symbol // 2
        self._Lq = Lq
        self.qam_scale = math.sqrt((M - 1) * 2.0 / 3.0)
        self.tile = int(tile)
        self.used = int(used)
        self.TL = int(TL)
        self.rays = int(rays)
        self.taps = int(taps)
        self.C = float(C)
        self.noise_gain = float(noise_gain)
        # G (TL, used) for the plain version, G_tap (T, used) for the
        # kernel; both rounded to bf16 where they are used in that mode
        self.g_re = torch.tensor(g_re, device=self.device).contiguous()
        self.g_im = torch.tensor(g_im, device=self.device).contiguous()
        self._g = torch.complex(self._cast(self.g_re), self._cast(self.g_im))
        self.g_tap_re = self._cast(self.g_re[::rays]).contiguous()
        self.g_tap_im = self._cast(self.g_im[::rays]).contiguous()
        self._g_tap = torch.complex(self.g_tap_re, self.g_tap_im)
        # the general form's G_tap: (re, im) pairs, zero rows up to a
        # multiple of its chunk
        self.g_tap_pairs = torch.zeros(
            (-(-taps // _CHUNK) * _CHUNK, used, 2), dtype=torch.float32,
            device=self.device)
        self.g_tap_pairs[:taps] = torch.stack([self.g_tap_re,
                                               self.g_tap_im], dim=-1)
        self.launch_count = 0
        self.reference_count = 0

    # -- the JAX inject layout ---------------------------------------------

    @property
    def used_p(self) -> int:
        """Width of the inject-mode data/noise bit tensors (the JAX
        layout pads the used bins to a multiple of 128)."""
        return ((self.used + 127) // 128) * 128

    @property
    def TLp(self) -> int:
        """Width of the inject-mode phase bit tensor (the JAX layout)."""
        return ((self.TL + 127) // 128) * 128

    @property
    def bf16(self) -> bool:
        return self.matmul_dtype == torch.bfloat16

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as an operand of the channel product: float32, rounded to
        bf16 in the bf16 mode."""
        return _round_bf16(x) if self.bf16 else x

    def amp(self, snr_linear: float) -> float:
        """Per-component noise std at ``snr_linear``, rounded to float32
        as the kernel receives it."""
        return float(np.float32(math.sqrt(0.5 / snr_linear) *
                                self.noise_gain))

    # ------------------------------------------------------------------
    # The plain PyTorch version
    # ------------------------------------------------------------------

    def channel_reference(self, e: torch.Tensor) -> torch.Tensor:
        """H = E @ G, TL deep, as the JAX kernel computes it: ``e`` complex
        (..., TL) -> (..., used), its parts rounded to bf16 first in the
        bf16 mode; products and sums in float32."""
        e = torch.complex(self._cast(e.real), self._cast(e.imag))
        return e @ self._g.to(e.device)

    def channel_rays_first(self, e: torch.Tensor) -> torch.Tensor:
        """The same H as :meth:`channel_reference` in the CUDA kernel's
        order: the rays of each tap summed first, then a product with
        G_tap only T deep. Equal in real arithmetic because G's rows repeat
        within a tap; in float32 the two differ by rounding."""
        e = torch.complex(self._cast(e.real), self._cast(e.imag))
        h_tap = e.reshape(*e.shape[:-1], self.taps, self.rays).sum(-1)
        return h_tap @ self._g_tap.to(e.device)

    def simulate_block_reference(self, phase_bits: torch.Tensor,
                                 data_bits: torch.Tensor,
                                 n1_bits: torch.Tensor,
                                 n2_bits: torch.Tensor,
                                 amp: float,
                                 first_tile: int = 0) -> torch.Tensor:
        """All the physics, from random bits to bit-error counts, in plain
        tensor code on the bits' device.

        phase_bits: (reps, >= 2, >= TL) int32 — rows 0/1 = (phi, psi)
        data/n1/n2_bits: (reps, num_tiles * tile, >= used) int32, tiles
        ``first_tile`` onward of the repetitions (their symbol times)
        Returns (reps, num_tiles) int32 error counts. Mirrors
        ``mc_pallas.py _simulate_block`` step for step, including the
        log-depth row doubling of E and the TL-deep product, so that it
        agrees with the JAX kernel to float32 rounding.
        """
        self.reference_count += 1
        f32 = torch.float32
        dev = phase_bits.device
        tile, used, TL = self.tile, self.used, self.TL
        Lq, half_bits = self._Lq, self._half_bits
        reps = phase_bits.shape[0]
        num_tiles = data_bits.shape[1] // tile

        # --- Jakes rays -> per-bin channel (ONE complex matmul) --------
        phi = _u01(phase_bits[:, 0, :TL]) * _TWO_PI       # (reps, TL)
        psi = _u01(phase_bits[:, 1, :TL]) * _TWO_PI
        wl = (self.C * torch.cos(phi))[:, None, None, :]  # (reps,1,1,TL)
        psi = psi[:, None, None, :]
        # E[r, il] = e^{j((t0 + r) wl + psi)} by log-depth doubling: trig
        # for the first 8 rows and the 8-step rotator, then each level
        # appends rows [R..2R) = rows [0..R) * e^{j R wl}
        t8 = ((torch.arange(num_tiles, device=dev)[:, None] + first_tile) *
              tile +
              torch.arange(8, device=dev)[None, :]).to(f32)
        ph8 = t8[None, :, :, None] * wl + psi             # (reps,nt,8,TL)
        e_re = torch.cos(ph8)
        e_im = torch.sin(ph8)
        d_re = torch.cos(8.0 * wl)
        d_im = torch.sin(8.0 * wl)
        rows = 8
        while rows < tile:
            n_re = e_re * d_re - e_im * d_im
            n_im = e_re * d_im + e_im * d_re
            e_re = torch.cat([e_re, n_re], dim=2)
            e_im = torch.cat([e_im, n_im], dim=2)
            s_re = d_re * d_re - d_im * d_im
            d_im = 2.0 * d_re * d_im
            d_re = s_re
            rows *= 2
        h = self.channel_reference(torch.complex(e_re, e_im))
        h_re, h_im = h.real, h.imag                       # (reps,nt,tile,used)

        # --- data symbols: arithmetic Gray QAM map ---------------------
        shape = (reps, num_tiles, tile, -1)
        idx = data_bits.reshape(shape)[..., :used] & (self.M - 1)
        col = idx & (Lq - 1)
        row = idx >> half_bits
        jj = col ^ (col >> 1)
        ii = row ^ (row >> 1)
        inv_scale = float(np.float32(1.0 / self.qam_scale))
        x_re = (2 * jj - (Lq - 1)).to(f32) * inv_scale
        x_im = ((Lq - 1) - 2 * ii).to(f32) * inv_scale

        # --- AWGN via inverse CDF, both tails clamped ------------------
        sqrt2 = math.sqrt(2.0)
        z1 = torch.clamp(_u11(n1_bits.reshape(shape)[..., :used]),
                         -0.99999994, 0.99999994)
        z2 = torch.clamp(_u11(n2_bits.reshape(shape)[..., :used]),
                         -0.99999994, 0.99999994)
        n_re = torch.erfinv(z1) * sqrt2
        n_im = torch.erfinv(z2) * sqrt2

        y_re = x_re * h_re - x_im * h_im + amp * n_re
        y_im = x_re * h_im + x_im * h_re + amp * n_im

        # --- one-tap equalize + slicer ---------------------------------
        den = h_re * h_re + h_im * h_im + 1e-30
        eq_re = (y_re * h_re + y_im * h_im) / den
        eq_im = (y_im * h_re - y_re * h_im) / den
        scale = self.qam_scale
        col_pos = torch.clamp(torch.floor(
            (eq_re * scale + (Lq - 1)) * 0.5 + 0.5),
            0, Lq - 1).to(torch.int32)
        row_pos = torch.clamp(torch.floor(
            ((Lq - 1) - eq_im * scale) * 0.5 + 0.5),
            0, Lq - 1).to(torch.int32)
        decided = (_inv_gray(row_pos) << half_bits) | _inv_gray(col_pos)

        # --- bit errors over the used bins -----------------------------
        diff = idx ^ decided
        errs = torch.zeros_like(diff)
        for k in range(self.bits_per_symbol):
            errs = errs + ((diff >> k) & 1)
        return errs.sum(dim=(2, 3), dtype=torch.int64).to(torch.int32)

    def prng_bits(self, reps: int, num_tiles: int, seed: int, start: int,
                  first_tile: int = 0):
        """The PRNG-mode bits of attempts ``[start, start + reps)``:
        phase bits (reps, 2, TL) and data / noise bits
        (reps, num_tiles * tile, used) of tiles ``first_tile`` onward,
        int32, drawn with ``ops/philox.py`` (the layout the kernel draws
        in registers)."""
        attempts = torch.arange(start, start + reps, dtype=torch.int64,
                                device=self.device)
        pb = philox.phase_stream_bits(seed, attempts, self.TL)
        db, n1, n2 = philox.symbol_stream_bits(seed, attempts, num_tiles,
                                               self.tile, self.used,
                                               first_tile)
        return pb, db, n1, n2

    def prng_reference(self, reps: int, num_tiles: int, seed: int,
                       amp: float, start: int = 0,
                       first_tile: int = 0) -> torch.Tensor:
        """The plain version in PRNG mode: the same bits as the kernel's,
        through :meth:`simulate_block_reference`; ``first_tile``: the
        counts of tiles ``[first_tile, first_tile + num_tiles)`` of a call
        of more tiles."""
        return self.simulate_block_reference(
            *self.prng_bits(reps, num_tiles, seed, start, first_tile), amp,
            first_tile)

    # ------------------------------------------------------------------
    # Builders: the kernel on CUDA, the plain version on the CPU
    # ------------------------------------------------------------------

    def build(self, reps: int, num_tiles: int, mesh=None,
              axis: str = "mc"):
        """``run(seed, snr_linear, start=0) -> (reps, num_tiles) int32``
        error counts on ``self.device``, with every bit drawn from the
        Philox streams of attempts ``[start, start + reps)``. Symbols
        simulated per call: ``reps * num_tiles * tile * used``. On CUDA
        the result is returned without synchronising.

        ``mesh``: a ``DeviceMesh`` to split the rep axis over (``reps``
        divisible by its ``axis`` size). Rank ``i`` runs the same call on
        its ``reps / size`` reps from ``start + i * reps / size`` and the
        counts are all-gathered in rank order, so every rank holds all
        ``reps`` rows, bit for bit those of the unsharded call (the
        absolute-attempt stream contract)."""
        self._check_grid(reps, num_tiles)
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
        """``run(phase_bits, data_bits, n1_bits, n2_bits, amp) ->
        (reps, num_tiles) int32`` with the randomness supplied in the JAX
        layout: phase bits (reps, 8, TLp), data/noise bits
        (reps, num_tiles * tile, used_p) (any widths >= TL / used do).
        Numpy uint32 arrays are moved to ``self.device``; tensors keep
        their device, which picks the route.

        ``mesh``: split the rep axis as in :meth:`build`; each rank takes
        its rows of the bit tensors (they carry the absolute attempts, so
        no offset is needed) and the counts are all-gathered."""
        self._check_grid(reps, num_tiles)
        if mesh is not None:
            from ..parallel.mesh import shard_inject_build
            return shard_inject_build(self.build_inject, reps, num_tiles,
                                      mesh, axis, num_bits=4)

        def run(phase_bits, data_bits, n1_bits, n2_bits, amp):
            bits = [_as_bits(b, self.device)
                    for b in (phase_bits, data_bits, n1_bits, n2_bits)]
            self._check_inject_shapes(reps, num_tiles, *bits)
            amp = float(np.float32(amp))
            dev = bits[0].device
            if dev.type == "cuda":
                return self._launch_inject(reps, num_tiles, bits, amp)
            if dev.type == "cpu":
                return self.simulate_block_reference(*bits, amp)
            raise RuntimeError(f"no route for device {dev}")

        return run

    def _check_grid(self, reps: int, num_tiles: int) -> None:
        if reps < 1 or num_tiles < 1:
            raise ValueError("reps and num_tiles must be positive")

    def _check_inject_shapes(self, reps, num_tiles, pb, db, n1, n2) -> None:
        if pb.dim() != 3 or pb.shape[0] != reps or pb.shape[1] < 2 or \
                pb.shape[2] < self.TL:
            raise ValueError(f"phase bits must be (reps={reps}, >=2, "
                             f">={self.TL}), got {tuple(pb.shape)}")
        want = (reps, num_tiles * self.tile)
        for b in (db, n1, n2):
            if b.dim() != 3 or tuple(b.shape[:2]) != want or \
                    b.shape[2] < self.used or b.shape != db.shape:
                raise ValueError(f"data/noise bits must be {want} + "
                                 f"(>={self.used},), got {tuple(b.shape)}")
        if any(b.device != pb.device for b in (db, n1, n2)):
            raise ValueError("all bit tensors must be on one device")

    # ------------------------------------------------------------------
    # CUDA launches
    # ------------------------------------------------------------------

    def kernel_plan(self, reps: int, num_tiles: int,
                    lib=None) -> Dict[str, int]:
        """How the first launch of a call of ``reps`` reps and
        ``num_tiles`` tiles runs (its slices of at most 65,535 of each,
        :func:`launch_slices`), as the built library ``lib`` (the prebuilt
        one by default) plans it on the current device
        (``mc_ofdm_tdl_plan``), keyed by ``_PLAN_KEYS``: the fast instance
        (``general`` 0) while there are at most 32 taps and 1,024 pairs;
        else the general form, its ``rows`` a block, its slot of
        ``slot_floats`` in shared memory (``smem_bytes``) or in a scratch
        buffer (``scratch_bytes``), the taps padded to ``taps_padded`` (a
        multiple of ``chunk_taps``), G_tap ``chunk_taps`` taps and
        ``group_rows`` rows at a time."""
        from . import _build
        lib = _build.load() if lib is None else lib
        out = (ctypes.c_longlong * len(_PLAN_KEYS))()
        _build.check(lib.mc_ofdm_tdl_plan(
            min(reps, _GRID_YZ), min(num_tiles, _GRID_YZ), self.tile,
            self.used, self.TL, self.taps, num_tiles, out),
            "mc_ofdm_tdl_plan")
        return dict(zip(_PLAN_KEYS, out))

    def launch_info(self, reps: int, num_tiles: int) -> Dict[str, int]:
        """What the first PRNG-mode launch of such a call runs on this
        card (``mc_ofdm_tdl_launch_info``): its instance's registers and
        local (spill) bytes a thread, static shared bytes and resident
        blocks a SM, with the plan's threads and dynamic shared bytes.
        Needs the card."""
        from . import _build
        out = (ctypes.c_int * len(_INFO_KEYS))()
        _build.check(_build.load().mc_ofdm_tdl_launch_info(
            min(reps, _GRID_YZ), min(num_tiles, _GRID_YZ), self.tile,
            self.used, self.TL, self.taps, num_tiles, int(self.bf16), out),
            "mc_ofdm_tdl_launch_info")
        plan = self.kernel_plan(reps, num_tiles)
        info = dict(zip(_INFO_KEYS, out))
        info.update(general=plan["general"], threads=plan["threads"],
                    smem_bytes=plan["smem_bytes"],
                    scratch=plan["scratch_bytes"] > 0)
        return info

    def prng_kernel_profile(self, reps: int, num_tiles: int
                            ) -> Dict[str, object]:
        """What ``ops/sass.py`` needs to count one PRNG-mode call's
        instructions: the kernel instance's mangled-name pattern, the
        threads that do work (one per used bin and block: idle lanes are
        left out) and the trips of its loops in listing order, per such
        thread. The fast instance: the (tap, ray) pairs' rays, the rays of
        a tap, the (row, tap) pairs of the tap sums, the rows of the body.
        The general form (its blocks counted as if each were launched, so
        the walk over them takes one trip): the pairs, the rays of a tap,
        the (row, tap) pairs, the chunks of taps, the groups of rows, the
        walk; its trips count the T taps the function
        has, not the zero taps the form pads them to, so the bound is the
        work the function needs. Every launch of the call is counted (one
        instance: that of the first)."""
        plan = self.kernel_plan(reps, num_tiles)
        rows = plan["rows"]
        chunks = plan["bin_chunks"]
        active = self.used / chunks                  # bins a block owns
        blocks = reps * num_tiles * (self.tile // rows) * chunks
        if plan["general"]:
            scratch = int(plan["scratch_bytes"] > 0)
            return {"pattern": f"mc_ofdm_tdl_general_kernelILb0ELb"
                               f"{int(self.bf16)}ELb{scratch}EE",
                    "threads": round(blocks * active), "loops": 6,
                    "loop_trips": [self.TL / active, self.rays,
                                   self.taps * rows / active,
                                   self.taps / plan["chunk_taps"],
                                   rows / plan["group_rows"], 1]}
        ktaps = 16 if self.taps <= 16 else 32
        return {"pattern": f"mc_ofdm_tdl_kernelILi{ktaps}ELb0ELb"
                           f"{int(self.bf16)}EE",
                "threads": round(blocks * active), "loops": 4,
                "loop_trips": [self.TL / active,
                               self.rays * self.taps / ktaps,
                               ktaps * rows / active, rows]}

    def _common_args(self, out: torch.Tensor, reps: int, num_tiles: int,
                     amp: float):
        return (self.g_tap_re.data_ptr(), self.g_tap_im.data_ptr(),
                out.data_ptr(), reps, num_tiles, self.tile, self.used,
                self.TL, self.taps, self.M, self.C, amp, self.qam_scale,
                1.0 / self.qam_scale, int(self.bf16),
                self.g_tap_pairs.data_ptr())

    def _scratch(self, lib, reps: int, num_tiles: int, device):
        """The general form's scratch buffer for one launch whose state is
        past shared memory, or None."""
        from . import _build
        nbytes = self.kernel_plan(reps, num_tiles, lib)["scratch_bytes"]
        return (_build.state_buffer(nbytes, device, "mc_ofdm_tdl")
                if nbytes else None)

    def _launches(self, reps: int, num_tiles: int):
        """``(r0, r1, t0, t1)`` of every launch of a call
        (:func:`launch_slices` of both axes)."""
        return [(r0, r1, t0, t1) for r0, r1 in launch_slices(reps)
                for t0, t1 in launch_slices(num_tiles)]

    def _launch_prng(self, reps: int, num_tiles: int, seed: int, amp: float,
                     start: int) -> torch.Tensor:
        from . import _build
        lib = _build.load()
        out = torch.zeros((reps, num_tiles), dtype=torch.int32,
                          device=self.device)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        for r0, r1, t0, t1 in self._launches(reps, num_tiles):
            scratch = self._scratch(lib, r1 - r0, num_tiles, self.device)
            g_re, g_im, o, *geom = self._common_args(out[r0:r1], r1 - r0,
                                                     num_tiles, amp)
            rc = lib.mc_ofdm_tdl_prng(
                g_re, g_im, o, *geom, seed & 0xFFFFFFFF, start + r0, t0,
                t1 - t0, None if scratch is None else scratch.data_ptr(),
                stream)
            _build.check(rc, "mc_ofdm_tdl_prng")
            self.launch_count += 1
        return out

    def _launch_inject(self, reps: int, num_tiles: int, bits,
                       amp: float) -> torch.Tensor:
        from . import _build
        pb, db, n1, n2 = bits
        if pb.device != self.g_tap_re.device:
            raise ValueError(f"bits on {pb.device}, builder on "
                             f"{self.g_tap_re.device}")
        lib = _build.load()
        out = torch.zeros((reps, num_tiles), dtype=torch.int32,
                          device=pb.device)
        stream = torch.cuda.current_stream(pb.device).cuda_stream
        for r0, r1, t0, t1 in self._launches(reps, num_tiles):
            scratch = self._scratch(lib, r1 - r0, num_tiles, pb.device)
            g_re, g_im, o, *geom = self._common_args(out[r0:r1], r1 - r0,
                                                     num_tiles, amp)
            rc = lib.mc_ofdm_tdl_inject(
                g_re, g_im, pb[r0:r1].data_ptr(), db[r0:r1].data_ptr(),
                n1[r0:r1].data_ptr(), n2[r0:r1].data_ptr(), o, *geom,
                pb.stride(0), pb.stride(1), db.stride(0), db.stride(1), t0,
                t1 - t0, None if scratch is None else scratch.data_ptr(),
                stream)
            _build.check(rc, "mc_ofdm_tdl_inject")
            self.launch_count += 1
        return out


def from_jax_arrays(d: Dict[str, object],
                    device: DeviceLike = "cuda") -> MonteCarloOfdmTdl:
    """The port's builder from a JAX ``MonteCarloOfdmTdl``'s numpy state:
    ``g_re`` / ``g_im`` (``np.asarray(mc._g_re)``, padded to (TLp,
    used_p), float32 or bf16), ``C``, ``noise_gain``, ``M``, ``tile``,
    ``used``, ``TL`` and optionally ``matmul_dtype``
    (``str(mc._matmul_dtype)``, default ``"float32"``). The padding is cut
    off. The ray count is the number of leading rows of G equal to its
    first, and G must repeat one row over the rays of every tap."""
    TL, used = int(d["TL"]), int(d["used"])
    g_re = np.asarray(d["g_re"], np.float32)[:TL, :used]
    g_im = np.asarray(d["g_im"], np.float32)[:TL, :used]
    md = d.get("matmul_dtype", "float32")
    mc = MonteCarloOfdmTdl.__new__(MonteCarloOfdmTdl)
    mc._set_state(g_re, g_im, float(d["C"]), float(d["noise_gain"]),
                  int(d["M"]), int(d["tile"]), used, _ray_run(g_re, g_im),
                  md if isinstance(md, torch.dtype) else str(md), device)
    return mc
