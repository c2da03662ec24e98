"""Small complex matrix helpers of the BD (and later IA) Monte Carlo
kernels, as plain torch functions.

Counterpart of ``pyphysim_tpu/ops/pallas_planes.py``. There a matrix was a
nested list of (re, im) planes; here it is a complex64 tensor ``(..., m,
n)`` batched over the leading dims, and each function accumulates in the
same order as the JAX helper (``acc = first term; acc = acc + next``), so
the plain versions agree with the JAX kernels to float32 rounding. The CUDA
kernels use the same helpers from ``ops/csrc/planes.cuh`` over register
arrays.

2x2 Hermitian matrices are ``(p, q, r)`` triples: real diagonal ``p``,
``r`` and the complex entry ``q`` above it.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["EPS", "cabs2", "mat_H", "mat_mul", "mat_sub", "gram_rows",
           "gram_full", "herm_solve_cols_ldl", "herm2_eigvals"]

EPS = 1e-30


def cabs2(a: torch.Tensor) -> torch.Tensor:
    """|a|^2 as a real tensor."""
    return a.real * a.real + a.imag * a.imag


def mat_H(M: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose of the last two dims."""
    return M.mH


def mat_mul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., m, k) x (..., k, n), summed over k in order."""
    acc = A[..., :, 0, None] * B[..., None, 0, :]
    for t in range(1, A.shape[-1]):
        acc = acc + A[..., :, t, None] * B[..., None, t, :]
    return acc


def mat_sub(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A - B


def gram_rows(M: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """M M^H of a (..., 2, n) matrix as a 2x2 Hermitian (p, q, r)."""
    p = cabs2(M[..., 0, 0])
    r = cabs2(M[..., 1, 0])
    q = M[..., 0, 0] * M[..., 1, 0].conj()
    for j in range(1, M.shape[-1]):
        p = p + cabs2(M[..., 0, j])
        r = r + cabs2(M[..., 1, j])
        q = q + M[..., 0, j] * M[..., 1, j].conj()
    return p, q, r


def gram_full(M: torch.Tensor) -> torch.Tensor:
    """M M^H of a (..., m, n) matrix as a full (..., m, m) Hermitian
    matrix, summed over n in order."""
    acc = M[..., :, 0, None] * M[..., None, :, 0].conj()
    for t in range(1, M.shape[-1]):
        acc = acc + M[..., :, t, None] * M[..., None, :, t].conj()
    return acc


def herm_solve_cols_ldl(B: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """B^-1 M for Hermitian positive-definite (..., n, n) B and (..., n, c)
    M, by a square-root-free LDL^H factorization unrolled over n: n
    reciprocals, everything else multiply-add. Degenerate pivots are
    floored at EPS only to keep the arithmetic finite; callers guard
    validity with their own scale-relative tests."""
    n = B.shape[-1]
    L = [[None] * n for _ in range(n)]
    D = [None] * n
    Dinv = [None] * n
    for j in range(n):
        d = B[..., j, j].real
        for k in range(j):
            d = d - cabs2(L[j][k]) * D[k]
        d = torch.clamp(d, min=EPS)
        D[j] = d
        Dinv[j] = 1.0 / d
        for i in range(j + 1, n):
            acc = B[..., i, j]
            for k in range(j):
                acc = acc - (L[i][k] * L[j][k].conj()) * D[k]
            L[i][j] = acc * Dinv[j]
    X = [M[..., i, :] for i in range(n)]
    # forward substitution: L z = M (unit diagonal)
    for i in range(n):
        for j in range(i):
            X[i] = X[i] - L[i][j][..., None] * X[j]
    # diagonal scale
    for i in range(n):
        X[i] = X[i] * Dinv[i][..., None]
    # back substitution: L^H x = z, (L^H)[i][j > i] = conj(L[j][i])
    for i in range(n - 1, -1, -1):
        for j in range(i + 1, n):
            X[i] = X[i] - X[j] * L[j][i].conj()[..., None]
    return torch.stack(X, dim=-2)


def herm2_eigvals(B) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both eigenvalues of a Hermitian 2x2 ``(p, q, r)``, (max, min)."""
    p, q, r = B
    mid = 0.5 * (p + r)
    h = 0.5 * (p - r)
    root = torch.sqrt(h * h + cabs2(q))
    return mid + root, mid - root
