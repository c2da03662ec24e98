"""Max-SINR interference-alignment Monte Carlo kernel: one CUDA kernel runs
a whole fixed-iteration Max-SINR solve per element, from random bits to a
capacity sum per (rep, tile).

Counterpart of ``pyphysim_tpu/ops/ia_pallas.py`` ``MonteCarloMaxSinr``.
This module holds the builder's checks, the plain PyTorch version of the
kernel's math (``simulate_block_reference``, through ``ops/planes.py`` in
the order of ``_solve_block`` and ``_solve_block_general``), and the
wrappers that launch the CUDA kernel ``ops/csrc/mc_ia.cu`` (its source note
says what bounds it on the card and what its design does about that).

Per element: a K-user interference channel of N x N complex Gaussian
links, the deterministic 'svd'-style initialization, ``iterations``
forward / reverse Max-SINR filter updates (Cadambe eq. 28), and the sum
over users and streams of ``log2(1 + SINR)``, 0 for a non-finite draw.
Two bodies, as in the JAX kernel:

  * (N, Ns) = (2, 1), the bench point: 2x2 Hermitian ``(p, q, r)`` closed
    forms and the closed-form dominant right singular vector as the init;
  * any other (K, N, Ns): full-matrix Bkl, LDL^H solves and an
    ``init_iters``-step orthogonal-iteration init.

The CUDA kernel is instantiated for the geometry menu ``MENU``;
``iterations``, ``init_iters``, ``P`` and the noise variance are run-time
arguments. Two bit sources:

  * PRNG mode (:meth:`MonteCarloMaxSinr.build`): Philox4x32-10 streams of
    the absolute attempt (layout in ``ops/philox.py``), drawn in registers
    by the kernel and by ``philox.ia_stream_bits`` for the plain version.
  * Inject mode (:meth:`MonteCarloMaxSinr.build_inject`): one bit tensor in
    the JAX layout (reps, num_tiles * tile, num_planes * lane).

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
from .alamouti_kernel import _gauss
from .mc_kernel import _as_bits
from .planes import (EPS, cabs2, dominant_right_singular, gdotc,
                     herm2_add_outer, herm2_quad, herm2_solve, herm_add_outer,
                     herm_solve_cols_ldl, mat_H, mat_mul, orth_iter_init,
                     vnormalize)

__all__ = ["MonteCarloMaxSinr", "MENU", "from_jax_attrs"]

# (K, N, Ns) instantiated in mc_ia.cu: the closed form at K = 2, 3, 4 and
# the general body at the two points tests/test_ia_pallas.py pins
MENU = ((2, 2, 1), (3, 2, 1), (4, 2, 1), (3, 4, 1), (2, 4, 2))


def _f32(x) -> float:
    return float(np.float32(x))


class MonteCarloMaxSinr:
    """Builder for the single-kernel Max-SINR IA Monte Carlo sweep: ``K``
    users, square ``N = Nr = Nt`` antennas, ``Ns`` streams a user, 'svd'
    style init and a fixed iteration count. ``tile`` rows x ``lane`` lanes
    of independent realizations per tile; solves per call:
    ``reps * num_tiles * tile * lane``. ``launch_count`` counts CUDA kernel
    launches and ``reference_count`` calls of the plain version.
    """

    def __init__(self, tile: int = 8, lane: int = 512,
                 iterations: int = 10, P: float = 1.0,
                 K: int = 3, N: int = 2, Ns: int = 1,
                 init_iters: int = 10, device: DeviceLike = "cuda") -> None:
        if tile < 8 or tile % 8:
            raise ValueError("tile must be a multiple of 8")
        if lane < 128 or lane % 128:
            raise ValueError("lane must be a multiple of 128")
        if K < 2:
            raise ValueError("K must be >= 2")
        if N < 2:
            raise ValueError("N must be >= 2")
        if not 1 <= Ns <= N:
            raise ValueError("need 1 <= Ns <= N")
        if iterations < 0 or init_iters < 0:
            raise ValueError("iteration counts must be >= 0")
        self.device = require_cuda(device)
        if self.device.type == "cuda" and (K, N, Ns) not in MENU:
            raise ValueError(f"(K, N, Ns) = {(K, N, Ns)} is not in the CUDA "
                             f"kernel's geometry menu {MENU}")
        self.tile = int(tile)
        self.lane = int(lane)
        self.iterations = int(iterations)
        self.P = float(P)
        self.K = int(K)
        self.N = int(N)
        self.Ns = int(Ns)
        self.init_iters = int(init_iters)
        self.launch_count = 0
        self.reference_count = 0

    @property
    def closed_form(self) -> bool:
        """True at (N, Ns) = (2, 1), where the closed-form body runs."""
        return (self.N, self.Ns) == (2, 1)

    @property
    def num_planes(self) -> int:
        """Channel bit planes per element: K * K N x N complex matrices."""
        return self.K * self.K * self.N * self.N * 2

    @property
    def solves_per_grid_step(self) -> int:
        return self.tile * self.lane

    def prng_kernel_profile(self, reps: int, num_tiles: int
                            ) -> Dict[str, object]:
        """What ``ops/sass.py`` needs to count one PRNG-mode call's
        instructions at a closed-form point: the kernel instance's
        mangled-name pattern, the threads launched (one solve each), and
        its one loop, the Max-SINR iterations."""
        if not self.closed_form:
            raise ValueError("the SASS profile covers the closed-form body")
        return {"pattern": f"mc_ia_closed_kernelILi{self.K}ELb0EE",
                "threads": reps * num_tiles * self.tile * self.lane,
                "loops": 1, "loop_trips": self.iterations}

    # ------------------------------------------------------------------
    # The plain PyTorch version
    # ------------------------------------------------------------------

    def channels(self, ch_bits: torch.Tensor) -> torch.Tensor:
        """The channels of inject-layout bits: complex64 (reps, num_tiles,
        tile, lane, K, K, N, N), ``H[..., k, j, :, :]`` from transmitter
        ``j`` to receiver ``k``; each part N(0, 1/2)."""
        K, N = self.K, self.N
        reps, rows, _ = ch_bits.shape
        nt = rows // self.tile
        planes = ch_bits.reshape(reps, nt, self.tile, self.num_planes,
                                 self.lane).transpose(-1, -2)
        g = _gauss(planes)                       # (reps, nt, tile, lane, P)
        return torch.complex(g[..., 0::2], g[..., 1::2]).reshape(
            g.shape[:-1] + (K, K, N, N))

    def element_capacities(self, ch_bits: torch.Tensor,
                           noise_var: float) -> torch.Tensor:
        """Per-element sum capacities (reps, num_tiles, tile * lane),
        float32, 0 for a non-finite draw. ``ch_bits`` is the inject
        layout."""
        H = self.channels(ch_bits)
        nv = _f32(noise_var)
        if self.closed_form:
            cap = self._solve_closed(H, nv)
        else:
            cap = self._solve_general(H, nv)
        cap = torch.where(torch.isfinite(cap), cap, torch.zeros_like(cap))
        return cap.reshape(H.shape[0], H.shape[1], -1)

    def _solve_closed(self, H: torch.Tensor, nv: float) -> torch.Tensor:
        """``_solve_block`` at (N, Ns) = (2, 1), vectorized over the users:
        F and U are (..., K, 2)."""
        K, P = self.K, _f32(self.P)
        Hrev = mat_H(H.transpose(-4, -3))        # Hrev[k][j] = H[j][k]^H

        def bkl(ch, Fc):
            t = mat_mul(ch, Fc[..., None, :, :, None])[..., 0]  # (.., K, K, 2)
            B = (nv, 0.0, nv)
            for j in range(K):
                B = herm2_add_outer(B, t[..., :, j, :], P)
            d = t.diagonal(dim1=-3, dim2=-2).transpose(-1, -2)  # (.., K, 2)
            return (B[0] - P * cabs2(d[..., 0]),
                    B[1] - (d[..., 0] * d[..., 1].conj()) * P,
                    B[2] - P * cabs2(d[..., 1])), d

        def update(ch, Fc):
            B, d = bkl(ch, Fc)
            return vnormalize(herm2_solve(B, d))

        F = dominant_right_singular(
            H.diagonal(dim1=-4, dim2=-3).movedim(-1, -3))
        for _ in range(self.iterations):
            U = update(H, F)
            F = update(Hrev, U)
        U = update(H, F)

        B, d = bkl(H, F)
        num = P * cabs2(d[..., 0] * U[..., 0].conj() +
                        d[..., 1] * U[..., 1].conj())
        den = torch.clamp(herm2_quad(B, U).abs(), min=EPS)
        c = torch.log2(1.0 + num / den)
        cap = c[..., 0]
        for k in range(1, K):
            cap = cap + c[..., k]
        return cap

    def _solve_general(self, H: torch.Tensor, nv: float) -> torch.Tensor:
        """``_solve_block_general``, vectorized over the users: F and U are
        (..., K, N, Ns), their columns scaled by 1/sqrt(Ns)."""
        K, N, Ns = self.K, self.N, self.Ns
        P = _f32(self.P)
        p_rev = _f32(np.float32(P) / np.float32(Ns))
        inv_sqrt_ns = _f32(1.0 / math.sqrt(Ns))
        Hrev = mat_H(H.transpose(-4, -3))
        eye = nv * torch.eye(N, dtype=H.dtype, device=H.device)

        def first_and_d(ch, Fc, p):
            T = mat_mul(ch, Fc[..., None, :, :, :])   # (.., K, K, N, Ns)
            first = eye
            for j in range(K):
                for l in range(Ns):
                    first = herm_add_outer(first, T[..., :, j, :, l], p)
            return first, T.diagonal(dim1=-4, dim2=-3).movedim(-1, -3)

        def update(ch, Fc, p):
            first, D = first_and_d(ch, Fc, p)
            cols = []
            for l in range(Ns):
                d = D[..., l]                          # (.., K, N)
                x = herm_solve_cols_ldl(herm_add_outer(first, d, -p),
                                        d[..., None])[..., 0]
                cols.append(vnormalize(x) * inv_sqrt_ns)
            return torch.stack(cols, dim=-1)

        F = orth_iter_init(H.diagonal(dim1=-4, dim2=-3).movedim(-1, -3), Ns,
                           self.init_iters) * inv_sqrt_ns
        for _ in range(self.iterations):
            U = update(H, F, P)
            F = update(Hrev, U, p_rev)
        U = update(H, F, P)

        first, D = first_and_d(H, F, P)
        cs = []
        for l in range(Ns):
            d, u = D[..., l], U[..., l]
            Bkl = herm_add_outer(first, d, -P)
            num = P * cabs2(gdotc(u, d))
            w = mat_mul(Bkl, u[..., None])[..., 0]
            den = torch.clamp(gdotc(u, w).real.abs(), min=EPS)
            cs.append(torch.log2(1.0 + num / den))    # (.., K)
        cap = None
        for k in range(K):
            for l in range(Ns):
                c = cs[l][..., k]
                cap = c if cap is None else cap + c
        return cap

    def simulate_block_reference(self, ch_bits: torch.Tensor,
                                 noise_var: float) -> torch.Tensor:
        """(reps, num_tiles) float32 capacity sums of the plain version."""
        self.reference_count += 1
        return self.element_capacities(ch_bits, noise_var).sum(dim=-1)

    def prng_bits(self, reps: int, num_tiles: int, seed: int,
                  start: int) -> torch.Tensor:
        """The PRNG-mode channel bits of attempts ``[start, start + reps)``
        in the inject layout (what the kernel draws in registers)."""
        attempts = torch.arange(start, start + reps, dtype=torch.int64,
                                device=self.device)
        return philox.ia_stream_bits(seed, attempts, num_tiles, self.tile,
                                     self.lane, self.num_planes)

    def prng_reference(self, reps: int, num_tiles: int, seed: int,
                       noise_var: float, start: int = 0) -> torch.Tensor:
        """The plain version in PRNG mode."""
        return self.simulate_block_reference(
            self.prng_bits(reps, num_tiles, seed, start), noise_var)

    # ------------------------------------------------------------------
    # Builders: the kernel on CUDA, the plain version on the CPU
    # ------------------------------------------------------------------

    def build(self, reps: int, num_tiles: int, mesh=None,
              axis: str = "mc"):
        """``run(seed, noise_var, start=0) -> (reps, num_tiles) float32``
        capacity sums on ``self.device``, the channels drawn from the
        Philox streams of attempts ``[start, start + reps)``. On CUDA the
        result is returned without synchronising.

        ``mesh``: a ``DeviceMesh`` to split the rep axis over (``reps``
        divisible by its ``axis`` size): rank ``i`` runs its ``reps /
        size`` reps from ``start + i * reps / size`` and the rows are
        all-gathered in rank order, bit for bit the unsharded call's."""
        _check_grid(reps, num_tiles)
        if mesh is not None:
            from ..parallel.mesh import shard_prng_build
            return shard_prng_build(self.build, reps, num_tiles, mesh, axis,
                                    start_arg=2)

        def run(seed: int, noise_var: float, start: int = 0):
            if self.device.type == "cuda":
                return self._launch(reps, num_tiles, None, noise_var,
                                    int(seed), int(start))
            if self.device.type == "cpu":
                return self.prng_reference(reps, num_tiles, int(seed),
                                           noise_var, int(start))
            raise RuntimeError(f"no route for device {self.device}")

        return run

    def build_inject(self, reps: int, num_tiles: int, mesh=None,
                     axis: str = "mc"):
        """``run(ch_bits, noise_var) -> (reps, num_tiles) float32`` with the
        channel bits in the JAX layout (reps, num_tiles * tile,
        num_planes * lane). A numpy uint32 array is moved to
        ``self.device``; a tensor keeps its device, which picks the
        route.

        ``mesh``: split the rep axis as in :meth:`build`; each rank takes
        its rows of the bit tensors and the rows are all-gathered."""
        _check_grid(reps, num_tiles)
        if mesh is not None:
            from ..parallel.mesh import shard_inject_build
            return shard_inject_build(self.build_inject, reps, num_tiles,
                                      mesh, axis, num_bits=1)
        want = (reps, num_tiles * self.tile, self.num_planes * self.lane)

        def run(ch_bits, noise_var: float):
            bits = _as_bits(ch_bits, self.device)
            if tuple(bits.shape) != want:
                raise ValueError(f"channel bits must be {want}, got "
                                 f"{tuple(bits.shape)}")
            if bits.device.type == "cuda":
                return self._launch(reps, num_tiles, bits, noise_var)
            if bits.device.type == "cpu":
                return self.simulate_block_reference(bits, noise_var)
            raise RuntimeError(f"no route for device {bits.device}")

        return run

    # ------------------------------------------------------------------
    # CUDA launches
    # ------------------------------------------------------------------

    def _launch(self, reps, num_tiles, bits, noise_var, seed=0, start=0):
        from . import _build
        dev = self.device if bits is None else bits.device
        lib = _build.load()
        parts = lib.mc_ia_num_parts(self.tile, self.lane, self.N, self.Ns)
        partial = torch.empty(reps * num_tiles * parts, dtype=torch.float32,
                              device=dev)
        out = torch.empty((reps, num_tiles), dtype=torch.float32, device=dev)
        geom = (reps, num_tiles, self.tile, self.lane, self.K, self.N,
                self.Ns, self.iterations, self.init_iters, _f32(self.P),
                _f32(noise_var))
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bits is None:
            rc = lib.mc_ia_prng(out.data_ptr(), partial.data_ptr(), *geom,
                                seed & 0xFFFFFFFF, start, stream)
        else:
            rc = lib.mc_ia_inject(bits.data_ptr(), out.data_ptr(),
                                  partial.data_ptr(), *geom, bits.stride(0),
                                  bits.stride(1), stream)
        _build.check(rc, "mc_ia_prng" if bits is None else "mc_ia_inject")
        self.launch_count += 1
        return out


def _check_grid(reps: int, num_tiles: int) -> None:
    if reps < 1 or num_tiles < 1:
        raise ValueError("reps and num_tiles must be positive")


def from_jax_attrs(d: Dict[str, object],
                   device: DeviceLike = "cuda") -> MonteCarloMaxSinr:
    """The port's builder from a JAX ``MonteCarloMaxSinr``'s attributes
    (``vars(mc)``: ``_tile``, ``_lane``, ``_iters``, ``_P``, ``_K``, ``_N``,
    ``_Ns``, ``_init_iters``). The kernel has no weights, so this is all its
    state."""
    return MonteCarloMaxSinr(tile=int(d["_tile"]), lane=int(d["_lane"]),
                             iterations=int(d["_iters"]), P=float(d["_P"]),
                             K=int(d["_K"]), N=int(d["_N"]),
                             Ns=int(d["_Ns"]),
                             init_iters=int(d["_init_iters"]),
                             device=device)
