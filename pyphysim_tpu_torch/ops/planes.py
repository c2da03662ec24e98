"""Small complex matrix helpers of the BD and Max-SINR IA Monte Carlo
kernels, as plain torch functions.

Counterpart of ``pyphysim_tpu/ops/pallas_planes.py``. There a matrix was a
nested list of (re, im) planes; here it is a complex64 tensor ``(..., m,
n)`` batched over the leading dims, and each function accumulates in the
same order as the JAX helper (``acc = first term; acc = acc + next``), so
the plain versions agree with the JAX kernels to float32 rounding. The CUDA
kernels use the same helpers from ``ops/csrc/planes.cuh`` over register
arrays.

2x2 Hermitian matrices are ``(p, q, r)`` triples: real diagonal ``p``,
``r`` and the complex entry ``q`` above it. A vector is a complex tensor
``(..., n)``; a set of column vectors an ``(..., n, c)`` matrix.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["EPS", "cabs2", "mat_H", "mat_mul", "mat_sub", "gram_rows",
           "gram_full", "herm_solve_cols_ldl", "herm2_eigvals",
           "herm2_add_outer", "herm2_solve", "herm2_quad", "herm_add_outer",
           "vnormalize", "gdotc", "mgs", "orth_iter_init",
           "dominant_right_singular"]

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


def herm2_add_outer(B, v: torch.Tensor, scale):
    """``B + scale v v^H`` for a Hermitian 2x2 ``(p, q, r)`` and a
    (..., 2) vector ``v``."""
    p, q, r = B
    v0, v1 = v[..., 0], v[..., 1]
    return (p + scale * cabs2(v0), q + (v0 * v1.conj()) * scale,
            r + scale * cabs2(v1))


def herm2_solve(B, v: torch.Tensor) -> torch.Tensor:
    """``B^-1 v`` for a Hermitian positive-definite 2x2 ``(p, q, r)`` by its
    adjugate, the determinant floored at EPS (callers normalize the
    result, so its scale cancels)."""
    p, q, r = B
    v0, v1 = v[..., 0], v[..., 1]
    inv = 1.0 / torch.clamp(p * r - cabs2(q), min=EPS)
    x0 = v0 * r - q * v1
    x1 = v1 * p - v0 * q.conj()
    return torch.stack([x0 * inv, x1 * inv], dim=-1)


def herm2_quad(B, v: torch.Tensor) -> torch.Tensor:
    """``re(v^H B v)`` for a Hermitian 2x2 ``(p, q, r)``."""
    p, q, r = B
    v0, v1 = v[..., 0], v[..., 1]
    cross = v1 * v0.conj()
    return (p * cabs2(v0) + r * cabs2(v1) +
            2.0 * (q.real * cross.real - q.imag * cross.imag))


def herm_add_outer(B: torch.Tensor, v: torch.Tensor, scale) -> torch.Tensor:
    """``B + scale v v^H`` for a full (..., n, n) matrix and a (..., n)
    vector (``scale`` a number or a tensor of the batch shape)."""
    if isinstance(scale, torch.Tensor):
        scale = scale[..., None, None]
    return B + (v[..., :, None] * v[..., None, :].conj()) * scale


def _norm2(v: torch.Tensor) -> torch.Tensor:
    acc = cabs2(v[..., 0])
    for i in range(1, v.shape[-1]):
        acc = acc + cabs2(v[..., i])
    return acc


def vnormalize(v: torch.Tensor) -> torch.Tensor:
    """``v / max(||v||, EPS)`` over the last dim, summed in order."""
    inv = 1.0 / torch.clamp(torch.sqrt(_norm2(v)), min=EPS)
    return v * inv[..., None]


def gdotc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^H b`` over the last dim, summed in order."""
    acc = b[..., 0] * a[..., 0].conj()
    for i in range(1, a.shape[-1]):
        acc = acc + b[..., i] * a[..., i].conj()
    return acc


def mgs(V: torch.Tensor) -> torch.Tensor:
    """Modified Gram-Schmidt of the columns of (..., n, c) ``V``, in
    order."""
    out = []
    for l in range(V.shape[-1]):
        v = V[..., l]
        for q in out:
            v = v - gdotc(q, v)[..., None] * q
        out.append(vnormalize(v))
    return torch.stack(out, dim=-1)


def orth_iter_init(M: torch.Tensor, ns: int, iters: int) -> torch.Tensor:
    """(..., n, ns) orthonormal columns after ``iters`` steps of orthogonal
    iteration on ``G = M^H M`` from the first ``ns`` unit vectors: the
    ``ns`` dominant right singular vectors of ``M`` once it converges."""
    G = mat_mul(mat_H(M), M)
    n = G.shape[-1]
    V = torch.eye(n, ns, dtype=G.dtype, device=G.device).expand(
        G.shape[:-2] + (n, ns))
    for _ in range(iters):
        V = mgs(mat_mul(G, V))
    return V


def dominant_right_singular(M: torch.Tensor) -> torch.Tensor:
    """(..., 2) dominant right singular vector of a (..., 2, 2) ``M``: the
    closed-form top eigenvector of ``M^H M`` (its phase convention is not
    LAPACK's). An already diagonal Gram matrix picks its larger axis."""
    m00, m01 = M[..., 0, 0], M[..., 0, 1]
    m10, m11 = M[..., 1, 0], M[..., 1, 1]
    p = cabs2(m00) + cabs2(m10)
    r = cabs2(m01) + cabs2(m11)
    q = m01 * m00.conj() + m11 * m10.conj()
    half = 0.5 * (p - r)
    lam = 0.5 * (p + r) + torch.sqrt(half * half + cabs2(q))
    w = lam - p
    ok = cabs2(q) + w * w > 1e-12 * torch.clamp(lam * lam, min=EPS)
    e0 = (p >= r).to(p.dtype)
    v0 = torch.where(ok, q, torch.complex(e0, torch.zeros_like(e0)))
    v1 = torch.complex(torch.where(ok, w, 1.0 - e0), torch.zeros_like(w))
    return vnormalize(torch.stack([v0, v1], dim=-1))
