"""Batched, fixed-iteration interference alignment on torch tensors.

Counterpart of ``pyphysim_tpu/ia/batched.py``. The host solvers in
:mod:`.algorithms` follow the reference's object API with data-dependent
convergence; for Monte Carlo these functions run a FIXED number of
iterations on a whole batch of channel realizations at once.

Channel layout: complex64 ``H`` of shape ``(..., K, K, Nr, Nt)`` (receiver
k, transmitter l), batched over the leading dims (the JAX package's
``vmap`` written out). Precoders ``F`` are ``(..., K, Nt, ns_max)``,
receive filters ``U`` ``(..., K, Nr, ns_max)``. The K / Ns loops are
Python loops (K and Ns are small), and each ``lax.scan`` is a Python loop.
Every function computes in full float32: TF32 matrix products are switched
off for its duration.

Small solves take a closed form where the math allows (n <= 2, no host
synchronisation); larger ones ``torch.linalg.solve_ex`` / ``inv_ex``. The
eigendecompositions (``torch.linalg.eigh``, ``svd``, ``eig``) check their
results on the host, so on the card they synchronise once per call.

Random starts take an explicit random source (a ``torch.Generator`` or an
``ops.streams.AttemptStreams``); the 'svd' and 'fix' inits are
deterministic.

Algorithm parity: [Cadambe2008] max-SINR iteration as the reference's
MaxSinrIASolver, with per-stream filters ``U_kl = B_kl^-1 H_kk V_kl`` in the
forward network and the same in the reverse network (``H_rev_kl =
H_lk^H``) for the precoders.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Tuple

import torch

from ..ops.streams import AttemptStreams
from ..utils.misc import full_precision, randn_c

__all__ = ["max_sinr_solve", "min_leakage_solve", "mmse_solve",
           "alt_min_solve", "alt_min_cost", "closed_form_solve",
           "brute_force_stream_solve", "greedy_stream_solve",
           "stream_combinations", "svd_init_precoders", "calc_sinrs",
           "sum_capacity", "calc_leakage", "random_unit_precoders"]


def _abs2(x: torch.Tensor) -> torch.Tensor:
    return x.real * x.real + x.imag * x.imag


def _hk(H: torch.Tensor, k: int, j: int) -> torch.Tensor:
    return H[..., k, j, :, :]


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _scale(P, j: int):
    """User j's power: a number, or a (...,) tensor broadcast over a
    matrix."""
    p = P[..., j] if isinstance(P, torch.Tensor) else P[j]
    return p[..., None, None] if isinstance(p, torch.Tensor) else p


def _rev(H: torch.Tensor) -> torch.Tensor:
    """The reverse network: ``H_rev[k, l] = H[l, k]^H``."""
    return H.transpose(-4, -3).mH


def _normalize_fro(f: torch.Tensor) -> torch.Tensor:
    return f / torch.sqrt(_abs2(f).sum(dim=(-2, -1), keepdim=True))


def _as_ns(Ns, K: int) -> Tuple[int, ...]:
    """Per-user stream counts as a tuple; an int means uniform. Tensors
    stay rectangular at the maximum count, and users with fewer streams
    carry zero precoder / filter columns."""
    if isinstance(Ns, int):
        return (int(Ns),) * K
    return tuple(int(n) for n in Ns)


def _pad_cols(x: torch.Tensor, total: int) -> torch.Tensor:
    """Zero-pad the last axis (stream columns) to ``total``."""
    missing = total - x.shape[-1]
    if missing == 0:
        return x
    return torch.nn.functional.pad(x, (0, missing))


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^-1 b`` for (..., n, n) ``a`` and (..., n, m) ``b``: closed forms
    at n <= 2 (a numerically singular ``a`` gives inf, which the callers'
    finiteness checks catch), ``torch.linalg.solve_ex`` above."""
    n = a.shape[-1]
    if n == 1:
        d2 = _abs2(a)
        inv = torch.where(d2 > 0.0, 1.0 / torch.clamp(d2, min=1e-30),
                          torch.full_like(d2, math.inf))
        return b * a.conj() * inv
    if n == 2:
        return _inv2x2(a) @ b
    return torch.linalg.solve_ex(a, b)[0]


def _inv2x2(a: torch.Tensor) -> torch.Tensor:
    """Adjugate over determinant, scaled by the largest |entry| first so
    the singularity test is scale-relative."""
    amax = torch.maximum(a.real.abs(), a.imag.abs()).amax(dim=(-2, -1))
    sc = (1.0 / torch.clamp(amax, min=1e-30))[..., None, None]
    an = a * sc
    a00, a01 = an[..., 0, 0], an[..., 0, 1]
    a10, a11 = an[..., 1, 0], an[..., 1, 1]
    det = a00 * a11 - a01 * a10
    d2 = _abs2(det)
    inv_mag = torch.where(d2 > 1e-12, 1.0 / torch.clamp(d2, min=1e-30),
                          torch.full_like(d2, math.inf))
    inv_det = det.conj() * inv_mag
    out = torch.stack([torch.stack([a11, -a01], dim=-1),
                       torch.stack([-a10, a00], dim=-1)], dim=-2)
    return out * inv_det[..., None, None] * sc


def random_unit_precoders(source, K: int, Nt: int, Ns,
                          batch_shape=()) -> torch.Tensor:
    """Random unit-Frobenius-norm precoders (..., K, Nt, ns_max); ``Ns`` an
    int or a per-user tuple (zero columns beyond each user's count).
    ``source`` is an ``AttemptStreams`` (one row per attempt) or a
    ``torch.Generator`` (then ``batch_shape`` leads)."""
    ns = _as_ns(Ns, K)
    ns_max = max(ns)
    lead = () if isinstance(source, AttemptStreams) else tuple(batch_shape)
    f = randn_c(source, *lead, K, Nt, ns_max)
    if len(set(ns)) > 1:
        mask = torch.tensor([[1.0] * n + [0.0] * (ns_max - n) for n in ns],
                            device=f.device)[:, None, :]
        f = f * mask
    return _normalize_fro(f)


def _bkl_covariances(H: torch.Tensor, F: torch.Tensor, k: int, noise_var,
                     P, Ns) -> List[torch.Tensor]:
    """Bkl (Cadambe eq. 28) for the active streams of user k, at total
    user power P[j] over unit-Frobenius precoders (the reference's
    ``full_F = sqrt(P) F``)."""
    K = H.shape[-4]
    ns = _as_ns(Ns, K)
    first = noise_var * _eye(H.shape[-2], H)
    for j in range(K):
        hf = _hk(H, k, j) @ F[..., j, :, :]
        first = first + (hf @ hf.mH) * _scale(P, j)
    hkk_f = _hk(H, k, k) @ F[..., k, :, :]
    out = []
    for l in range(ns[k]):
        v = hkk_f[..., :, l:l + 1]
        out.append(first - (v @ v.mH) * _scale(P, k))
    return out


def _update_filters(H, F, noise_var, P, Ns) -> torch.Tensor:
    """Per-stream max-SINR receive filters (..., K, Nr, ns_max); inactive
    stream columns stay zero."""
    K = H.shape[-4]
    ns = _as_ns(Ns, K)
    ns_max = max(ns)
    us = []
    for k in range(K):
        bkls = _bkl_covariances(H, F, k, noise_var, P, ns)
        hkk_f = _hk(H, k, k) @ F[..., k, :, :]
        cols = []
        for l in range(ns[k]):
            ukl = _solve(bkls[l], hkk_f[..., :, l:l + 1])
            cols.append(_normalize_fro(ukl))
        uk = _pad_cols(torch.cat(cols, dim=-1), ns_max)
        us.append(_normalize_fro(uk))
    return torch.stack(us, dim=-3)


@full_precision
def svd_init_precoders(H: torch.Tensor, Ns) -> torch.Tensor:
    """Deterministic 'svd' initialization: F_k = the ns_k dominant right
    singular vectors of the direct channel H_kk (one ``torch.linalg.svd``
    over every user), unit Frobenius norm, zero-padded to the maximum
    stream count."""
    K = H.shape[-4]
    ns = _as_ns(Ns, K)
    ns_max = max(ns)
    direct = H.diagonal(dim1=-4, dim2=-3).movedim(-1, -3)   # (..., K, Nr, Nt)
    v = torch.linalg.svd(direct)[2].mH
    fs = [_pad_cols(_normalize_fro(v[..., k, :, :ns[k]]), ns_max)
          for k in range(K)]
    return torch.stack(fs, dim=-3)


@full_precision
def max_sinr_solve(H: torch.Tensor, source=None, Ns=1, P: float = 1.0,
                   noise_var: float = 0.1, iterations: int = 20,
                   init: str = "random", F0: torch.Tensor = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration Max-SINR IA.

    ``H``: (..., K, K, Nr, Nt). ``Ns``: int or per-user tuple of stream
    counts. ``init``: 'random' (from ``source``), 'svd' (deterministic,
    the brute-force search's init) or 'fix' (start from ``F0``, unit-
    Frobenius precoders (..., K, Nt, ns_max)). Returns ``(F, U)``: F
    (..., K, Nt, ns_max) normalized precoders and U (..., K, Nr, ns_max)
    receive filters.

    The power convention is the reference's, asymmetric for Ns > 1: the
    forward Bkl at total user power P over ``F``, the reverse network at
    per-stream power P / Ns over the normalized filters.
    """
    K = H.shape[-4]
    ns = _as_ns(Ns, K)
    p_fwd = [P] * K
    p_rev = [P / n for n in ns]
    if init == "fix":
        if F0 is None:
            raise ValueError("init='fix' requires F0")
        F = F0
    elif init == "svd":
        F = svd_init_precoders(H, ns)
    else:
        if source is None:
            raise ValueError("init='random' requires a random source")
        F = random_unit_precoders(source, K, H.shape[-1], ns, H.shape[:-4])
    Hrev = _rev(H)
    for _ in range(iterations):
        U = _update_filters(H, F, noise_var, p_fwd, ns)
        F = _update_filters(Hrev, U, noise_var, p_rev, ns)
    U = _update_filters(H, F, noise_var, p_fwd, ns)
    return F, U


def _interference_covariances(H, F, P) -> torch.Tensor:
    """``Q_k = sum_{j != k} P_j H_kj F_j F_j^H H_kj^H``, (..., K, Nr, Nr)."""
    K = H.shape[-4]
    qs = []
    for k in range(K):
        q = torch.zeros(H.shape[:-4] + (H.shape[-2],) * 2, dtype=H.dtype,
                        device=H.device)
        for j in range(K):
            if j == k:
                continue
            hf = _hk(H, k, j) @ F[..., j, :, :]
            q = q + (hf @ hf.mH) * _scale(P, j)
        qs.append(q)
    return torch.stack(qs, dim=-3)


@full_precision
def calc_leakage(H: torch.Tensor, F: torch.Tensor, U: torch.Tensor,
                 P: float = 1.0) -> torch.Tensor:
    """Total interference leakage ``sum_k tr(U_k^H Q_k U_k)`` (real), the
    cost the Min-Leakage solver minimizes."""
    K = H.shape[-4]
    Q = _interference_covariances(H, F, [P] * K)
    total = 0.0
    for k in range(K):
        m = U[..., k, :, :].mH @ (Q[..., k, :, :] @ U[..., k, :, :])
        total = total + m.real.diagonal(dim1=-2, dim2=-1).sum(-1)
    return total


@full_precision
def min_leakage_solve(H: torch.Tensor, source, Ns: int = 1, P: float = 1.0,
                      iterations: int = 20
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration Min-Leakage IA ([Cadambe2008] alg. 1): receive
    filters are the ``Ns`` least dominant eigenvectors of the interference
    covariance ``Q_k``, precoders the same update in the reverse network.
    Noise does not enter the cost. Returns ``(F, U)``."""
    K = H.shape[-4]
    p_vec = [P] * K
    F = random_unit_precoders(source, K, H.shape[-1], Ns, H.shape[:-4])
    Hrev = _rev(H)

    def least_eigvecs(Hdir, F_cur):
        v = torch.linalg.eigh(_interference_covariances(Hdir, F_cur,
                                                        p_vec))[1]
        return _normalize_fro(v[..., :Ns])        # ascending eigenvalues

    for _ in range(iterations):
        U = least_eigvecs(H, F)
        F = least_eigvecs(Hrev, U)
    return F, least_eigvecs(H, F)


def _mmse_precoder(A: torch.Tensor, rhs: torch.Tensor, P,
                   bisect_iters: int = 40) -> torch.Tensor:
    """``V = (A + mu I)^-1 rhs`` with the smallest ``mu >= 0`` such that
    ``||V||_F^2 <= P`` ([Peters2011]): one eigendecomposition of the
    Hermitian PSD ``A``, then a fixed-iteration bisection on the explicit,
    decreasing ``||V(mu)||^2 = sum |b|^2 / (lam + mu)^2``."""
    lam, q = torch.linalg.eigh(A)
    b = q.mH @ rhs
    b2 = _abs2(b)
    lam = torch.clamp(lam, min=0.0)

    def norm2(mu):
        d = (lam + mu)[..., :, None]
        return (b2 / (d * d)).sum(dim=(-2, -1))

    mu_hi = torch.sqrt(b2.sum(dim=(-2, -1)) / P) + 1e-12
    lo, hi = torch.zeros_like(mu_hi), mu_hi
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        too_big = norm2(mid[..., None]) > P
        lo = torch.where(too_big, mid, lo)
        hi = torch.where(too_big, hi, mid)
    mu = torch.where(norm2(torch.zeros_like(hi)[..., None]) <= P,
                     torch.zeros_like(hi), hi)
    d = 1.0 / (lam + mu[..., None])
    return q @ (b * d[..., :, None])


@full_precision
def mmse_solve(H: torch.Tensor, source, Ns: int = 1, P: float = 1.0,
               noise_var: float = 0.1, iterations: int = 20
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration MMSE interference alignment ([Peters2011]):
    receive filters ``U_k = (sum_i H_ki V_i V_i^H H_ki^H + noise I)^-1
    H_kk V_k`` and power-constrained MMSE precoders
    ``V_i = (sum_k H_ki^H U_k U_k^H H_ki + mu_i I)^-1 H_ii^H U_i``.
    Returns ``(F, U)``: F the full (power-scaled) precoders, U the MMSE
    filters (not normalized)."""
    K = H.shape[-4]
    Nr, Nt = H.shape[-2], H.shape[-1]
    F = random_unit_precoders(source, K, Nt, Ns, H.shape[:-4]) * \
        math.sqrt(P)

    def update_U(F_cur):
        us = []
        for k in range(K):
            cov = noise_var * _eye(Nr, H)
            for i in range(K):
                hv = _hk(H, k, i) @ F_cur[..., i, :, :]
                cov = cov + hv @ hv.mH
            us.append(_solve(cov, _hk(H, k, k) @ F_cur[..., k, :, :]))
        return torch.stack(us, dim=-3)

    def update_F(U):
        vs = []
        for i in range(K):
            a = torch.zeros(H.shape[:-4] + (Nt, Nt), dtype=H.dtype,
                            device=H.device)
            for k in range(K):
                hu = _hk(H, k, i).mH @ U[..., k, :, :]
                a = a + hu @ hu.mH
            vs.append(_mmse_precoder(a, _hk(H, i, i).mH @ U[..., i, :, :],
                                     P))
        return torch.stack(vs, dim=-3)

    for _ in range(iterations):
        F = update_F(update_U(F))
    return F, update_U(F)


def _alt_min_update_C(H, F, p_vec, Ns: int) -> torch.Tensor:
    """Interference subspaces: C_k = the dominant Nr - Ns eigenvectors of
    Q_k, (..., K, Nr, Nr - Ns)."""
    v = torch.linalg.eigh(_interference_covariances(H, F, p_vec))[1]
    return v[..., Ns:]                                # dominant Nr - Ns


def _alt_min_update_F(H, C, Ns: int) -> torch.Tensor:
    """F_l = the least Ns eigenvectors of ``sum_{k != l} H_kl^H Y_k H_kl``
    with ``Y_k = I - C_k C_k^H``, unit Frobenius norm."""
    K, Nr, Nt = H.shape[-4], H.shape[-2], H.shape[-1]
    Ys = [_eye(Nr, H) - C[..., k, :, :] @ C[..., k, :, :].mH
          for k in range(K)]
    ms = []
    for l in range(K):
        m = torch.zeros(H.shape[:-4] + (Nt, Nt), dtype=H.dtype,
                        device=H.device)
        for k in range(K):
            if k == l:
                continue
            hkl = _hk(H, k, l)
            m = m + hkl.mH @ (Ys[k] @ hkl)
        ms.append(m)
    v = torch.linalg.eigh(torch.stack(ms, dim=-3))[1]
    return _normalize_fro(v[..., :Ns])


def _alt_min_update_U(H, F, C, Ns: int) -> torch.Tensor:
    """Zero-forcing receive filters: rows of ``inv([H_kk F_k, C_k])``,
    returned as column filters ``U = W_H^H``."""
    K = H.shape[-4]
    tilde = torch.stack([torch.cat([_hk(H, k, k) @ F[..., k, :, :],
                                    C[..., k, :, :]], dim=-1)
                         for k in range(K)], dim=-3)
    w_h = (_inv2x2(tilde) if tilde.shape[-1] == 2
           else torch.linalg.inv_ex(tilde)[0])[..., :Ns, :]
    return w_h.mH.resolve_conj()


@full_precision
def alt_min_solve(H: torch.Tensor, source, Ns: int = 1, P: float = 1.0,
                  iterations: int = 20, F0: torch.Tensor = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration alternating minimization IA
    ([PetersHeathAltMin2009]): C (dominant eigenvectors of Q_k), F (least
    eigenvectors of the out-of-subspace interference operator) and the ZF
    receive filter from ``[H_kk F_k, C_k]^-1``, in the host solver's
    order. ``F0`` (..., K, Nt, Ns) fixes the init. Returns ``(F, U)`` with
    ``U = W_H^H``."""
    K, Nt = H.shape[-4], H.shape[-1]
    p_vec = [P] * K
    F = F0 if F0 is not None else random_unit_precoders(
        source, K, Nt, Ns, H.shape[:-4])
    C = _alt_min_update_C(H, F, p_vec, Ns)
    for _ in range(iterations):
        C = _alt_min_update_C(H, F, p_vec, Ns)
        F = _alt_min_update_F(H, C, Ns)
    return F, _alt_min_update_U(H, F, C, Ns)


@full_precision
def alt_min_cost(H: torch.Tensor, F: torch.Tensor,
                 P: float = 1.0) -> torch.Tensor:
    """Interference energy outside the interference subspaces,
    ``sum_{k != l} ||(I - C_k C_k^H) H_kl sqrt(P) F_l||_F^2`` with C
    recomputed from F."""
    K, Nr = H.shape[-4], H.shape[-2]
    Ns = F.shape[-1]
    C = _alt_min_update_C(H, F, [P] * K, Ns)
    cost = 0.0
    for k in range(K):
        y = _eye(Nr, H) - C[..., k, :, :] @ C[..., k, :, :].mH
        for l in range(K):
            if l == k:
                continue
            out = y @ (_hk(H, k, l) @ F[..., l, :, :] * math.sqrt(P))
            cost = cost + _abs2(out).sum(dim=(-2, -1))
    return cost


def _select(stacked: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """``stacked[best[...], ...]`` for (C, ..., K, n, m) candidates."""
    idx = best[None, ..., None, None, None].expand(
        (1,) + stacked.shape[1:])
    return torch.gather(stacked, 0, idx)[0]


@full_precision
def closed_form_solve(H: torch.Tensor, Ns: int = 1, P: float = 1.0,
                      noise_var: float = 0.1, use_best_init: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-user closed-form IA [CadambeDoF2008]:
    ``E = H31^-1 H32 H12^-1 H13 H23^-1 H21``; F0 spans ``Ns`` eigenvectors
    of E (with ``use_best_init`` every subset is tried and the best sum
    capacity kept); F1 / F2 follow from F0 through the cross links; W_k
    are the least eigenvectors of the residual interference Gram matrices.
    The eigenvectors of E come from ``torch.linalg.eig``, whose order is
    not the JAX package's: the two agree on the best subset's capacity.
    With Ns >= 2 the W_k span a null space of dimension Nr - Ns >= 2:
    any basis of it aligns, but the per-stream SINRs follow the basis that
    the eigh backend picks (LAPACK and cuSOLVER pick different ones).

    ``H``: (..., 3, 3, Nr, Nt). Returns ``(F, U)``, (..., 3, Nt, Ns) and
    (..., 3, Nr, Ns)."""
    if H.shape[-4] != 3 or H.shape[-3] != 3:
        raise AssertionError(
            "The closed form IA solution only works in a MIMO-IC "
            "scenario with 3 users.")
    Nt = H.shape[-1]
    e = _solve(_hk(H, 2, 0), _hk(H, 2, 1)) @ (
        _solve(_hk(H, 0, 1), _hk(H, 0, 2)) @ _solve(_hk(H, 1, 2),
                                                    _hk(H, 1, 0)))
    eigvecs = torch.linalg.eig(e)[1]

    def candidate(cols):
        f0 = _normalize_fro(eigvecs[..., :, list(cols)])
        f1 = _normalize_fro(_solve(_hk(H, 2, 1), _hk(H, 2, 0) @ f0))
        f2 = _normalize_fro(_solve(_hk(H, 1, 2), _hk(H, 1, 0) @ f0))
        F = torch.stack([f0, f1, f2], dim=-3)
        # W_k = the least Ns eigenvectors of the dominant interferer's
        # Gram matrix: source 1 for user 0, else 0
        grams = []
        for k, src in enumerate((1, 0, 0)):
            aa = _hk(H, k, src) @ F[..., src, :, :]
            grams.append(aa @ aa.mH)
        U = torch.linalg.eigh(torch.stack(grams, dim=-3))[1][..., :Ns]
        return F, U, sum_capacity(calc_sinrs(H, F, U, noise_var, P))

    if not use_best_init:
        F, U, _ = candidate(tuple(range(Ns)))
        return F, U
    cands = [candidate(c) for c in itertools.combinations(range(Nt), Ns)]
    best = torch.stack([c[2] for c in cands], dim=-1).argmax(dim=-1)
    return (_select(torch.stack([c[0] for c in cands]), best),
            _select(torch.stack([c[1] for c in cands]), best))


@full_precision
def calc_sinrs(H: torch.Tensor, F: torch.Tensor, U: torch.Tensor,
               noise_var, P: float = 1.0, Ns=None) -> torch.Tensor:
    """Per-stream SINRs (..., K, ns_max) (Cadambe2008 eq. 28/29). ``Ns``:
    optional per-user stream counts; inactive (zero-padded) streams report
    SINR 0."""
    K = H.shape[-4]
    ns = _as_ns(F.shape[-1] if Ns is None else Ns, K)
    ns_max = F.shape[-1]
    rows = []
    for k in range(K):
        bkls = _bkl_covariances(H, F, k, noise_var, [P] * K, ns)
        hkk_f = _hk(H, k, k) @ F[..., k, :, :]
        vals = []
        for l in range(ns[k]):
            ukl = U[..., k, :, l:l + 1]
            num = P * _abs2(ukl.mH @ hkk_f[..., :, l:l + 1])[..., 0, 0]
            den = (ukl.mH @ (bkls[l] @ ukl)).real[..., 0, 0]
            vals.append(num / den.abs())
        vals += [torch.zeros_like(vals[0])] * (ns_max - ns[k])
        rows.append(torch.stack(vals, dim=-1))
    return torch.stack(rows, dim=-2)


def sum_capacity(sinrs: torch.Tensor) -> torch.Tensor:
    """``sum log2(1 + sinr)`` over streams and users."""
    return torch.log2(1.0 + sinrs).sum(dim=(-2, -1))


def stream_combinations(max_Ns, K: int) -> Tuple[Tuple[int, ...], ...]:
    """The candidates of :func:`brute_force_stream_solve`: the cartesian
    product of per-user stream counts ``1..max_Ns_k``.

    >>> stream_combinations(2, 2)
    ((1, 1), (1, 2), (2, 1), (2, 2))
    """
    per_user = [range(1, n + 1) for n in _as_ns(max_Ns, K)]
    return tuple(itertools.product(*per_user))


@full_precision
def brute_force_stream_solve(H: torch.Tensor, source=None, max_Ns=2,
                             P: float = 1.0, noise_var: float = 0.1,
                             iterations: int = 20, solver=max_sinr_solve):
    """Exhaustive per-user stream-count search: every combination of
    :func:`stream_combinations` solved from the deterministic 'svd' init,
    the best sum capacity wins. Returns ``(F, U, best_index,
    capacities)``, F / U padded to the global maximum stream count,
    ``capacities`` (..., C) one entry per combination."""
    K = H.shape[-4]
    combos = stream_combinations(max_Ns, K)
    ns_glob = max(max(c) for c in combos)
    Fs, Us, caps = [], [], []
    for comb in combos:
        F, U = solver(H, source, Ns=comb, P=P, noise_var=noise_var,
                      iterations=iterations, init="svd")
        caps.append(sum_capacity(calc_sinrs(H, F, U, noise_var, P,
                                            Ns=comb)))
        Fs.append(_pad_cols(F, ns_glob))
        Us.append(_pad_cols(U, ns_glob))
    caps = torch.stack(caps, dim=-1)
    best = caps.argmax(dim=-1)
    return (_select(torch.stack(Fs), best), _select(torch.stack(Us), best),
            best, caps)


# ---------------------------------------------------------------------------
# Greedy stream search
# ---------------------------------------------------------------------------

def _bkl_first_part(H, F, k: int, noise_var, P_vec) -> torch.Tensor:
    """``noise_var I + sum_j P_j H_kj F_j F_j^H H_kj^H``; deleted (zero)
    precoder columns add nothing."""
    first = noise_var * _eye(H.shape[-2], H)
    for j in range(H.shape[-4]):
        hf = _hk(H, k, j) @ F[..., j, :, :]
        first = first + (hf @ hf.mH) * _scale(P_vec, j)
    return first


def _masked_update_filters(H, F, noise_var, P_vec) -> torch.Tensor:
    """:func:`_update_filters` over all ``ns_max`` columns: a deleted
    stream is a zero precoder column and gives a zero filter column
    (``B^-1 0 = 0`` through the guarded normalization)."""
    K = H.shape[-4]
    us = []
    for k in range(K):
        first = _bkl_first_part(H, F, k, noise_var, P_vec)
        hkk_f = _hk(H, k, k) @ F[..., k, :, :]
        cols = []
        for l in range(F.shape[-1]):
            v = hkk_f[..., :, l:l + 1]
            ukl = _solve(first - (v @ v.mH) * _scale(P_vec, k), v)
            nrm = torch.sqrt(_abs2(ukl).sum(dim=(-2, -1), keepdim=True))
            cols.append(torch.where(nrm <= 0, torch.zeros_like(ukl),
                                    ukl / torch.clamp(nrm, min=1e-30)))
        us.append(_normalize_fro(torch.cat(cols, dim=-1)))
    return torch.stack(us, dim=-3)


def _masked_sinrs(H, F, U, noise_var, P: float = 1.0) -> torch.Tensor:
    """Per-stream SINRs over all ``ns_max`` columns, 0 for deleted
    (zero-column) streams."""
    K = H.shape[-4]
    rows = []
    for k in range(K):
        first = _bkl_first_part(H, F, k, noise_var, [P] * K)
        hkk_f = _hk(H, k, k) @ F[..., k, :, :]
        vals = []
        for l in range(F.shape[-1]):
            v = hkk_f[..., :, l:l + 1]
            bkl = first - (v @ v.mH) * P
            ukl = U[..., k, :, l:l + 1]
            num = P * _abs2(ukl.mH @ v)[..., 0, 0]
            den = torch.clamp((ukl.mH @ (bkl @ ukl)).real[..., 0, 0].abs(),
                              min=1e-30)
            active = _abs2(F[..., k, :, l]).sum(-1) > 0
            vals.append(torch.where(active, num / den,
                                    torch.zeros_like(num)))
        rows.append(torch.stack(vals, dim=-1))
    return torch.stack(rows, dim=-2)


@full_precision
def greedy_stream_solve(H: torch.Tensor, source=None, Ns=2, P: float = 1.0,
                        noise_var: float = 0.1, iterations: int = 20,
                        init: str = "svd", candidate_init: str = "fix"):
    """Greedy worst-stream deletion.

    Solve at the full stream allocation, then repeatedly delete the
    worst-SINR stream among users that still have more than one and
    re-solve while the sum capacity does not decrease; stop on the first
    strictly worse deletion (rolled back) or when every user is down to one
    stream. The deletion loop is a fixed ``sum(Ns) - K`` steps whose state
    advances through ``where`` selects gated by a keep-going flag, so the
    data-dependent search runs on a whole batch.

    ``candidate_init``: ``"fix"`` re-solves each candidate from the
    surviving precoders (the reference's default); ``"svd"`` re-solves
    from the svd init at the candidate's canonical allocation, exactly the
    solve :func:`brute_force_stream_solve` performs for it, so greedy <=
    brute force by construction.

    Returns ``(F, U, mask, capacities)``: the best precoders / filters, the
    (..., K, ns_max) 0/1 mask of surviving streams and the capacity
    trajectory (..., 1 + steps). The achieved capacity is
    ``capacities.max(-1)``.
    """
    if candidate_init not in ("fix", "svd"):
        raise ValueError(f"unknown candidate_init {candidate_init!r}")
    K = H.shape[-4]
    ns = _as_ns(Ns, K)
    ns_max = max(ns)
    F, U = max_sinr_solve(H, source, ns, P=P, noise_var=noise_var,
                          iterations=iterations, init=init)
    dt = F.real.dtype
    mask = torch.tensor([[1.0] * n + [0.0] * (ns_max - n) for n in ns],
                        dtype=dt, device=H.device).expand(
        F.shape[:-3] + (K, ns_max))
    cap = sum_capacity(_masked_sinrs(H, F, U, noise_var, P))
    caps = [cap]
    bF, bU, bmask = F, U, mask
    keep = torch.ones(cap.shape, dtype=torch.bool, device=H.device)
    p_fwd = [P] * K
    Hrev = _rev(H)
    F_svd = svd_init_precoders(H, ns) if candidate_init == "svd" else None
    iota = torch.arange(ns_max, device=H.device)

    def sel(cond, a, b):
        return torch.where(cond[..., None, None, None], a, b)

    for _ in range(sum(ns) - K):
        sinr = _masked_sinrs(H, F, U, noise_var, P)
        counts = mask.sum(-1)                               # (..., K)
        deletable = counts > 1
        flat = torch.where((mask > 0) & deletable[..., :, None], sinr,
                           torch.full_like(sinr, math.inf)).reshape(
            sinr.shape[:-2] + (K * ns_max,))
        idx = flat.argmin(dim=-1)
        can = deletable.any(dim=-1)
        if candidate_init == "svd":
            user_oh = torch.nn.functional.one_hot(idx // ns_max, K).to(dt)
            canon = torch.clamp(counts - user_oh, min=1.0)
            new_mask = (iota < canon[..., :, None]).to(dt)
            F0 = _normalize_fro(F_svd * new_mask[..., :, None, :])
        else:
            del_oh = torch.nn.functional.one_hot(idx, K * ns_max).to(
                dt).reshape(mask.shape)
            new_mask = mask * (1.0 - del_oh)
            F0 = F * new_mask[..., :, None, :]                # 'fix' init
        p_rev = P / torch.clamp(new_mask.sum(-1), min=1.0)  # (..., K)
        F2 = F0
        for _ in range(iterations):
            U2 = _masked_update_filters(H, F2, noise_var, p_fwd)
            F2 = _masked_update_filters(Hrev, U2, noise_var, p_rev)
        U2 = _masked_update_filters(H, F2, noise_var, p_fwd)
        cap2 = sum_capacity(_masked_sinrs(H, F2, U2, noise_var, P))

        go = keep & can
        # the reference restores only when strictly worse: a tie keeps
        # deleting
        accept = go & (cap2 >= cap)
        bF, bU = sel(accept, F2, bF), sel(accept, U2, bU)
        bmask = torch.where(accept[..., None, None], new_mask, bmask)
        F, U = sel(go, F2, F), sel(go, U2, U)
        mask = torch.where(go[..., None, None], new_mask, mask)
        cap = torch.where(go, cap2, cap)
        caps.append(cap)
        keep = accept
    return bF, bU, bmask, torch.stack(caps, dim=-1)
