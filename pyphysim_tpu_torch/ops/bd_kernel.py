"""BD CoMP sum-capacity Monte Carlo kernel: one CUDA kernel runs a whole
Block Diagonalization solve per element, from random bits to a capacity
sum per (rep, tile).

Counterpart of ``pyphysim_tpu/ops/bd_pallas.py`` ``MonteCarloBD``. This
module holds the builder's checks, the plain PyTorch version of the
kernel's math (``simulate_block_reference``, through ``ops/planes.py`` in
the order of ``_solve_block`` and ``_guarded``), and the wrappers that
launch the CUDA kernel ``ops/csrc/mc_bd.cu`` (its source note says what
bounds it on the card and what its design does about that).

Per element: an NT x NT complex Gaussian channel (NT = K * Nr_u), each
user's projection on the other users' null space by an LDL^H solve, the
stream gains (closed-form 2x2 eigenvalues at Nr_u = 2), branch-free
water-filling with per-BS normalization (``"normalized"``), the
water-filling powers as they are (``"global"``) or equal power
(``"none"``), and the scale-relative guard. Any ``K >= 2`` and ``Nr_u`` in
(1, 2) runs, as in the JAX kernel: the prebuilt library holds the
geometries ``PREBUILT``, and any other is compiled into a library of its
own on its first launch (``ops/_build.py`` ``load(geometry)``: the
prebuilt kernel's form up to ``NT = tile_form_max_nt()``, the wide form
above); ``iPu`` and ``noise_var`` are run-time arguments. Two bit
sources:

  * PRNG mode (:meth:`MonteCarloBD.build`): Philox4x32-10 streams of the
    absolute attempt (layout in ``ops/philox.py``), drawn in registers by
    the kernel and by ``philox.bd_stream_bits`` for the plain version.
  * Inject mode (:meth:`MonteCarloBD.build_inject`): one bit tensor in the
    JAX layout (reps, num_tiles * tile, num_planes * lane).

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel, or raises: there is no fallback.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .._device import DeviceLike, require_cuda
from . import philox
from .alamouti_kernel import _gauss
from .mc_kernel import _as_bits
from .planes import (EPS, cabs2, gram_full, gram_rows, herm2_eigvals,
                     herm_solve_cols_ldl, mat_H, mat_mul, mat_sub)

__all__ = ["MonteCarloBD", "PREBUILT", "MODES", "from_jax_attrs"]

# (K, Nr_u) in the prebuilt library; any other builds on its first launch
PREBUILT = ((2, 1), (2, 2), (3, 2), (4, 1), (4, 2))
MODES = ("normalized", "global", "none")           # the kernel's mode codes
_SOURCE = Path(__file__).resolve().parent / "csrc" / "mc_bd.cu"


@functools.lru_cache(maxsize=None)
def _source_constant(name: str) -> int:
    """The ``constexpr int`` ``name`` of ``ops/csrc/mc_bd.cu``, read from
    the source so that the wrapper cannot drift from the kernel."""
    m = re.search(rf"constexpr int {name} = (\d+);", _SOURCE.read_text())
    if m is None:
        raise RuntimeError(f"{_SOURCE.name} defines no {name}")
    return int(m.group(1))


def block_threads() -> int:
    """``kThreads`` of ``mc_bd.cu``: the threads of a block (one element
    each) of the prebuilt kernel's form."""
    return _source_constant("kThreads")


def tile_form_max_nt() -> int:
    """``kTileFormMaxNt`` of ``mc_bd.cu``: the largest NT that a library
    built for one geometry runs in the prebuilt kernel's form (the wide
    form above it)."""
    return _source_constant("kTileFormMaxNt")


def _f32(x) -> float:
    return float(np.float32(x))


class MonteCarloBD:
    """Builder for the single-kernel BD CoMP capacity sweep over the square
    geometry ``(K, Nr_u, Nt_total = K * Nr_u)``: ``tile`` rows x ``lane``
    lanes of independent realizations per tile. Solves per call:
    ``reps * num_tiles * tile * lane``. ``launch_count`` counts CUDA kernel
    launches and ``reference_count`` calls of the plain version.
    """

    def __init__(self, tile: int = 8, lane: int = 512,
                 iPu: float = 10.0 / 3, noise_var: float = 1.0,
                 K: int = 3, Nr_u: int = 2, mode: str = "normalized",
                 device: DeviceLike = "cuda") -> None:
        if tile < 8 or tile % 8:
            raise ValueError("tile must be a multiple of 8")
        if lane < 128 or lane % 128:
            raise ValueError("lane must be a multiple of 128")
        if K < 2:
            raise ValueError("K must be >= 2")
        if Nr_u not in (1, 2):
            raise ValueError("Nr_u must be 1 or 2 (closed-form per-user "
                             "eigenvalues)")
        if mode not in MODES:
            raise ValueError(f"Unknown mode: {mode!r}")
        self.device = require_cuda(device)
        self.tile = int(tile)
        self.lane = int(lane)
        self.iPu = float(iPu)
        self.noise_var = float(noise_var)
        self.K = int(K)
        self.Nr_u = int(Nr_u)
        self.mode = mode
        self.launch_count = 0
        self.reference_count = 0

    @property
    def num_planes(self) -> int:
        """Channel bit planes per element: NT * NT complex entries x 2."""
        nt = self.K * self.Nr_u
        return nt * nt * 2

    @property
    def solves_per_grid_step(self) -> int:
        return self.tile * self.lane

    @property
    def prebuilt(self) -> bool:
        """True if the prebuilt library holds this geometry."""
        return (self.K, self.Nr_u) in PREBUILT

    @property
    def wide_form(self) -> bool:
        """True if the kernel runs in the wide form (``mc_bd_wide_kernel``:
        a geometry built on first use above ``tile_form_max_nt()``)."""
        return (not self.prebuilt and
                self.K * self.Nr_u > tile_form_max_nt())

    def geometry_build(self):
        """``(source, defines)`` of this geometry's own library for
        ``ops/_build.py``, or None if it is prebuilt."""
        if self.prebuilt:
            return None
        return "mc_bd", {"MC_BD_K": self.K, "MC_BD_NR": self.Nr_u}

    def launch_info(self) -> Dict[str, object]:
        """How the PRNG instance of this mode launches on the card, as its
        library reports it (``mc_bd_launch_info``, ``_build.launch_info``):
        threads and shared bytes a block, elements a block, lanes an
        element, the scratch buffer, resident blocks and warps a SM."""
        from . import _build
        return _build.launch_info(
            _build.load(self.geometry_build()).mc_bd_launch_info, self.K,
            self.Nr_u, MODES.index(self.mode))

    def prng_kernel_profile(self, reps: int, num_tiles: int
                            ) -> Dict[str, object]:
        """What ``ops/sass.py`` needs to count one PRNG-mode call's
        instructions: the library and the kernel instance's mangled-name
        pattern, the threads launched (one a solve), and its loops with
        their trips in listing order: the Philox calls that fill two
        entries of a thread's channel (at odd NT one more, unrolled, fills
        the last), then for each user (the user loop is unrolled) two passes
        over the columns of H. The rest is unrolled. The wide form
        (:attr:`wide_form`) nests rolled loops whose trips depend on the
        row (the LDL^H's triangles): its ``loops`` is None, so its bound
        comes from the solve's operations instead."""
        from . import _build
        mode = MODES.index(self.mode)
        library = _build.library_path(self.geometry_build())
        if self.wide_form:
            lib = _build.load(self.geometry_build())
            return {"library": library,
                    "pattern": (f"mc_bd_wide_kernelILi{self.K}ELi"
                                f"{self.Nr_u}ELi{mode}ELb0EE"),
                    "threads": reps * num_tiles *
                    lib.mc_bd_num_parts(self.tile, self.lane) *
                    self.launch_info()["threads"],
                    "loops": None, "loop_trips": None}
        threads = block_threads()
        parts = -(-self.tile * self.lane // threads)
        nt = self.K * self.Nr_u
        trips = [self.num_planes // 4] + [nt, nt] * self.K
        pattern = f"mc_bd_kernelILi{self.K}ELi{self.Nr_u}ELi{mode}ELb0EE"
        return {"library": library, "pattern": pattern,
                "threads": reps * num_tiles * parts * threads,
                "loops": len(trips), "loop_trips": trips}

    def _scalars(self, iPu, noise_var):
        return (_f32(self.iPu if iPu is None else iPu),
                _f32(self.noise_var if noise_var is None else noise_var))

    # ------------------------------------------------------------------
    # The plain PyTorch version
    # ------------------------------------------------------------------

    def stream_gains(self, ch_bits: torch.Tensor,
                     dtype: torch.dtype = torch.complex64) -> list:
        """The K * Nr_u stream gains of each element, each (reps,
        num_tiles, tile, lane): ``_solve_block``'s projections and
        eigenvalues on the float32 draws of ``ch_bits`` (inject layout),
        carried out in ``dtype`` (complex64 as the kernel; complex128 as a
        witness of what float32 rounding does to a draw)."""
        K, NR = self.K, self.Nr_u
        NT = K * NR
        reps, rows, _ = ch_bits.shape
        nt = rows // self.tile
        planes = ch_bits.reshape(reps, nt, self.tile, self.num_planes,
                                 self.lane).transpose(-1, -2)
        g = _gauss(planes)                       # (reps, nt, tile, lane, P)
        H = torch.complex(g[..., 0::2], g[..., 1::2]).reshape(
            g.shape[:-1] + (NT, NT)).to(dtype)

        gains = []
        for k in range(K):
            others = [i for i in range(NT) if i // NR != k]
            tilde = H[..., others, :]                 # (m, NT)
            Hk = H[..., NR * k:NR * (k + 1), :]       # (NR, NT)
            B = gram_full(tilde)
            Y = mat_mul(Hk, mat_H(tilde))             # (NR, m)
            W = herm_solve_cols_ldl(B, mat_H(Y))      # (m, NR)
            T = mat_sub(Hk, mat_mul(mat_H(W), tilde))
            if NR == 1:
                gain = cabs2(T[..., 0, 0])
                for j in range(1, NT):
                    gain = gain + cabs2(T[..., 0, j])
                gains.append(torch.clamp(gain, min=0.0))
            else:
                l0, l1 = herm2_eigvals(gram_rows(T))
                gains.append(torch.clamp(l0, min=0.0))
                gains.append(torch.clamp(l1, min=0.0))
        return gains

    def element_capacities(self, ch_bits: torch.Tensor,
                           iPu: Optional[float] = None,
                           noise_var: Optional[float] = None
                           ) -> torch.Tensor:
        """Per-element capacities (reps, num_tiles, tile * lane), float32,
        0 for a degenerate draw: ``_solve_block`` + ``_guarded`` step for
        step on the bits' device. ``ch_bits`` is the inject layout."""
        K, NR = self.K, self.Nr_u
        ipu, nv = self._scalars(iPu, noise_var)
        reps, nt = ch_bits.shape[0], ch_bits.shape[1] // self.tile
        gains = self.stream_gains(ch_bits)

        inv_nv = _f32(np.float32(1.0) / np.float32(nv))
        if self.mode == "none":
            p_eq = _f32(np.float32(ipu) / np.float32(NR))
            cap = None
            for gain in gains:
                c = torch.log2(1.0 + p_eq * gain * inv_nv)
                cap = c if cap is None else cap + c
            return self._guarded(cap, gains).reshape(reps, nt, -1)

        # branch-free water-filling over the K * NR stream gains
        total_power = _f32(np.float32(K) * np.float32(ipu))
        inv = [nv / torch.clamp(gain, min=EPS) for gain in gains]
        n = len(inv)
        rank = []
        for i in range(n):
            r_i = torch.zeros_like(inv[0])
            for j in range(n):
                if j != i:
                    r_i = r_i + (inv[j] < inv[i]).float() + \
                        ((inv[j] == inv[i]) & (j < i)).float()
            rank.append(r_i)
        mu_ks, feas = [], []
        for kk in range(n):
            cum_inv = sum((rank[i] <= kk).float() * inv[i] for i in range(n))
            worst = sum((rank[i] == kk).float() * inv[i] for i in range(n))
            mu_k = (total_power + cum_inv) / float(kk + 1)
            mu_ks.append(mu_k)
            feas.append((mu_k >= worst).float())
        kept = sum(feas)
        mu = sum(m * (kept == kk + 1).float() for kk, m in enumerate(mu_ks))
        powers = [torch.clamp(mu - v, min=0.0) for v in inv]

        if self.mode == "global":
            scale2 = 1.0
        else:
            user_p = [sum(powers[NR * k + t] for t in range(NR))
                      for k in range(K)]
            max_p = user_p[0]
            for up in user_p[1:]:
                max_p = torch.maximum(max_p, up)
            scale2 = ipu / torch.clamp(max_p, min=EPS)
        cap = None
        for p, gain in zip(powers, gains):
            c = torch.log2(1.0 + p * scale2 * gain * inv_nv)
            cap = c if cap is None else cap + c
        return self._guarded(cap, gains).reshape(reps, nt, -1)

    @staticmethod
    def _guarded(cap, gains):
        """Zero out degenerate draws, scale-relative."""
        smax = gains[0]
        smin = gains[0]
        for gain in gains[1:]:
            smax = torch.maximum(smax, gain)
            smin = torch.minimum(smin, gain)
        ok = torch.sqrt(smin) > 1e-6 * torch.sqrt(smax)
        return torch.where(torch.isfinite(cap) & ok, cap,
                           torch.zeros_like(cap))

    def simulate_block_reference(self, ch_bits: torch.Tensor,
                                 iPu: Optional[float] = None,
                                 noise_var: Optional[float] = None
                                 ) -> torch.Tensor:
        """(reps, num_tiles) float32 capacity sums of the plain version."""
        self.reference_count += 1
        return self.element_capacities(ch_bits, iPu, noise_var).sum(dim=-1)

    def prng_bits(self, reps: int, num_tiles: int, seed: int,
                  start: int) -> torch.Tensor:
        """The PRNG-mode channel bits of attempts ``[start, start + reps)``
        in the inject layout (what the kernel draws in registers)."""
        attempts = torch.arange(start, start + reps, dtype=torch.int64,
                                device=self.device)
        return philox.bd_stream_bits(seed, attempts, num_tiles, self.tile,
                                     self.lane, self.num_planes)

    def prng_reference(self, reps: int, num_tiles: int, seed: int,
                       start: int = 0, iPu: Optional[float] = None,
                       noise_var: Optional[float] = None) -> torch.Tensor:
        """The plain version in PRNG mode."""
        return self.simulate_block_reference(
            self.prng_bits(reps, num_tiles, seed, start), iPu, noise_var)

    # ------------------------------------------------------------------
    # Builders: the kernel on CUDA, the plain version on the CPU
    # ------------------------------------------------------------------

    def build(self, reps: int, num_tiles: int, mesh=None,
              axis: str = "mc"):
        """``run(seed, start=0, iPu=None, noise_var=None) -> (reps,
        num_tiles) float32`` capacity sums on ``self.device``, the channels
        drawn from the Philox streams of attempts ``[start, start + reps)``
        (``iPu`` / ``noise_var`` default to the constructor's). On CUDA the
        result is returned without synchronising.

        ``mesh``: a ``DeviceMesh`` to split the rep axis over (``reps``
        divisible by its ``axis`` size): rank ``i`` runs its ``reps /
        size`` reps from ``start + i * reps / size`` and the rows are
        all-gathered in rank order, bit for bit the unsharded call's."""
        _check_grid(reps, num_tiles)
        if mesh is not None:
            from ..parallel.mesh import shard_prng_build
            return shard_prng_build(self.build, reps, num_tiles, mesh, axis,
                                    start_arg=1)

        def run(seed: int, start: int = 0, iPu: Optional[float] = None,
                noise_var: Optional[float] = None):
            if self.device.type == "cuda":
                return self._launch(reps, num_tiles, None, iPu, noise_var,
                                    int(seed), int(start))
            if self.device.type == "cpu":
                return self.prng_reference(reps, num_tiles, int(seed),
                                           int(start), iPu, noise_var)
            raise RuntimeError(f"no route for device {self.device}")

        return run

    def build_inject(self, reps: int, num_tiles: int, mesh=None,
                     axis: str = "mc"):
        """``run(ch_bits, iPu=None, noise_var=None) -> (reps, num_tiles)
        float32`` with the channel bits in the JAX layout (reps,
        num_tiles * tile, num_planes * lane). A numpy uint32 array is moved
        to ``self.device``; a tensor keeps its device, which picks the
        route.

        ``mesh``: split the rep axis as in :meth:`build`; each rank takes
        its rows of the bit tensors and the rows are all-gathered."""
        _check_grid(reps, num_tiles)
        if mesh is not None:
            from ..parallel.mesh import shard_inject_build
            return shard_inject_build(self.build_inject, reps, num_tiles,
                                      mesh, axis, num_bits=1)
        want = (reps, num_tiles * self.tile, self.num_planes * self.lane)

        def run(ch_bits, iPu: Optional[float] = None,
                noise_var: Optional[float] = None):
            bits = _as_bits(ch_bits, self.device)
            if tuple(bits.shape) != want:
                raise ValueError(f"channel bits must be {want}, got "
                                 f"{tuple(bits.shape)}")
            if bits.device.type == "cuda":
                return self._launch(reps, num_tiles, bits, iPu, noise_var)
            if bits.device.type == "cpu":
                return self.simulate_block_reference(bits, iPu, noise_var)
            raise RuntimeError(f"no route for device {bits.device}")

        return run

    # ------------------------------------------------------------------
    # CUDA launches
    # ------------------------------------------------------------------

    def _launch(self, reps, num_tiles, bits, iPu, noise_var, seed=0,
                start=0):
        from . import _build
        ipu, nv = self._scalars(iPu, noise_var)
        dev = self.device if bits is None else bits.device
        lib = _build.load(self.geometry_build())
        parts = lib.mc_bd_num_parts(self.tile, self.lane)
        partial = torch.empty(reps * num_tiles * parts, dtype=torch.float32,
                              device=dev)
        out = torch.empty((reps, num_tiles), dtype=torch.float32, device=dev)
        scratch = _build.state_buffer(lib.mc_bd_scratch_bytes(
            reps, num_tiles, self.tile, self.lane), dev,
            f"MonteCarloBD(K={self.K}, Nr_u={self.Nr_u})")
        geom = (reps, num_tiles, self.tile, self.lane, self.K, self.Nr_u,
                MODES.index(self.mode), ipu, nv)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bits is None:
            rc = lib.mc_bd_prng(out.data_ptr(), partial.data_ptr(), *geom,
                                seed & 0xFFFFFFFF, start, scratch.data_ptr(),
                                stream)
        else:
            rc = lib.mc_bd_inject(bits.data_ptr(), out.data_ptr(),
                                  partial.data_ptr(), *geom, bits.stride(0),
                                  bits.stride(1), scratch.data_ptr(),
                                  stream)
        _build.check(rc, "mc_bd_prng" if bits is None else "mc_bd_inject")
        self.launch_count += 1
        return out


def _check_grid(reps: int, num_tiles: int) -> None:
    if reps < 1 or num_tiles < 1:
        raise ValueError("reps and num_tiles must be positive")


def from_jax_attrs(d: Dict[str, object],
                   device: DeviceLike = "cuda") -> MonteCarloBD:
    """The port's builder from a JAX ``MonteCarloBD``'s attributes
    (``vars(mc)``: ``_tile``, ``_lane``, ``_iPu``, ``_nv``, ``_K``, ``_NR``,
    ``_mode``). The kernel has no weights, so this is all its state."""
    return MonteCarloBD(tile=int(d["_tile"]), lane=int(d["_lane"]),
                        iPu=float(d["_iPu"]), noise_var=float(d["_nv"]),
                        K=int(d["_K"]), Nr_u=int(d["_NR"]),
                        mode=str(d["_mode"]), device=device)
