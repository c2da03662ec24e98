"""Batched Block Diagonalization on complex64 tensors.

Counterpart of the BD part of ``pyphysim_tpu/comm/batched.py``: one call
computes the [Spencer2004] BD precoders of a whole batch of joint CoMP
channels ``H (..., K * Nr_u, Nt_total)``:

1. per user k, the precoder lives in the null space of the other users'
   stacked rows ``tilde_H_k``, reached by the projector route
   ``T_k = H_k (I - tilde_H^H B^-1 tilde_H)`` with ``B = tilde_H
   tilde_H^H`` (no full-matrices SVD);
2. the user's streams are the top ``min(Nr_u, nS)`` right singular
   directions of ``T_k``, taken from the small Gram side ``T_k T_k^H``:
   ``V = T^H U / s`` is orthonormal, lies in the null space and aligns the
   streams (``nS = Nt_total - (K - 1) Nr_u``);
3. power loading: global water-filling, per-BS normalized water-filling,
   or equal per-BS power, all branch-free.

The solve and the eigendecomposition are ``torch.linalg`` (``solve_ex``,
so a singular draw gives non-finite values instead of an exception, and
``eigh``), in full float32: TF32 is switched off for the call. Degeneracy
guards are scale-relative and the floors are 1e-30, in the normal float32
range. Whitening and the stream-sacrifice family (``enhanced_bd_batched``)
are not ported yet.

The null-space basis has an arbitrary phase per column, so the precoders
are not element-wise equal to the JAX package's; the block-diagonalized
channel, the singular values, the power constraints and the capacities are.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch

from .waterfilling import doWF_jit

__all__ = ["bd_precoders_batched", "bd_receive_filter_batched",
           "bd_blocks_no_power_batched"]


def _full_precision(fn):
    """Run ``fn`` with TF32 matrix products switched off (restored after)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    return wrapper


def _user_rows(H: torch.Tensor, k: int, nr_u: int) -> torch.Tensor:
    return H[..., k * nr_u:(k + 1) * nr_u, :]


def _other_rows(H: torch.Tensor, k: int, nr_u: int) -> torch.Tensor:
    return torch.cat([H[..., :k * nr_u, :], H[..., (k + 1) * nr_u:, :]],
                     dim=-2)


def _stream_null_blocks(H: torch.Tensor, K: int):
    """Per-user stream-aligned orthonormal null-space blocks, in
    DESCENDING effective-singular-value order.

    Returns ``(blocks, sigmas, (nr_u, nS))``: per user a (..., Nt_total, r)
    block and its descending (..., r) singular values, ``r = min(Nr_u,
    nS)``."""
    nr_tot, nt_tot = H.shape[-2], H.shape[-1]
    if nr_tot % K:
        raise ValueError("channel rows must divide by the user count")
    nr_u = nr_tot // K
    nS = nt_tot - (K - 1) * nr_u
    if nS <= 0:
        raise ValueError(
            f"No null-space dimensions left: Nt_total={nt_tot} <= "
            f"(K-1)*Nr_u={(K - 1) * nr_u}")
    r = min(nr_u, nS)
    blocks: List[torch.Tensor] = []
    sigmas: List[torch.Tensor] = []
    for k in range(K):
        tilde = _other_rows(H, k, nr_u)                  # (m, Nt)
        Hk = _user_rows(H, k, nr_u)
        B = tilde @ tilde.mH                             # (m, m) HPD Gram
        X, _ = torch.linalg.solve_ex(B, tilde)           # B^-1 tilde_H
        T = Hk - (Hk @ tilde.mH) @ X                     # Hk P_null(tilde)
        w, U = torch.linalg.eigh(T @ T.mH)               # ascending
        w = w.flip(-1)[..., :r]
        U = U.flip(-1)[..., :, :r]
        s = torch.sqrt(torch.clamp(w, min=0.0))
        V = T.mH @ U                                     # (Nt, r)
        blocks.append(V / torch.clamp(s, min=1e-30)[..., None, :])
        sigmas.append(s)
    return blocks, sigmas, (nr_u, nS)


def _block_power(blk: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Frobenius norm of each (..., m, n) block."""
    return torch.sqrt((blk.real ** 2 + blk.imag ** 2).sum(
        dim=(-2, -1), keepdim=keepdim))


@_full_precision
def bd_precoders_batched(H: torch.Tensor, num_users: int, iPu: float,
                         noise_var: float = 0.0, mode: str = "normalized"
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Block-diagonalization precoders for a batch of joint channels.

    ``H`` (..., K * Nr_u, Nt_total) complex; ``iPu`` the power of each
    base station; ``noise_var`` the noise variance of the water-filling
    modes. ``mode``: ``"global"`` (water-filling over all streams),
    ``"normalized"`` (then rescaled so the most loaded BS transmits exactly
    iPu) or ``"none"`` (equal per-BS power).

    Returns ``(newH, Ms, Sigma)``: ``newH = H @ Ms`` is block-diagonal,
    ``Ms`` (..., Nt_total, K * kept) the precoders, ``Sigma`` (...,
    K * kept) the per-stream effective singular values before power
    loading.
    """
    K = int(num_users)
    if H.shape[-2] % K != 0:
        raise ValueError(
            "Number of rows of the channel must be a multiple of the "
            "number of users.")
    blocks, sigmas, (nr_u, nS) = _stream_null_blocks(H, K)
    kept = min(nr_u, nS)
    Ms_bad = torch.cat([b[..., :, :kept] for b in blocks], dim=-1)
    Sigma = torch.cat([s[..., :kept] for s in sigmas], dim=-1)

    if mode in ("global", "normalized"):
        opt_p, _ = doWF_jit(Sigma ** 2, K * iPu, noise_var)
        Ms = Ms_bad * torch.sqrt(opt_p)[..., None, :]
        if mode == "normalized":
            norms = torch.stack(
                [_block_power(Ms[..., :, k * kept:(k + 1) * kept])
                 for k in range(K)], dim=-1)
            max_norm = norms.max(dim=-1).values
            scale = iPu ** 0.5 / torch.clamp(max_norm, min=1e-30)
            Ms = Ms * scale[..., None, None]
    elif mode == "none":
        parts = []
        for k in range(K):
            blk = Ms_bad[..., :, k * kept:(k + 1) * kept]
            norm = _block_power(blk, keepdim=True)
            parts.append(blk * (iPu ** 0.5 / torch.clamp(norm, min=1e-30)))
        Ms = torch.cat(parts, dim=-1)
    else:
        raise ValueError(f"Unknown mode: {mode!r}")

    return H @ Ms, Ms, Sigma


@_full_precision
def bd_receive_filter_batched(newH: torch.Tensor) -> torch.Tensor:
    """Zero-forcing receive filter: the pseudo-inverse of the
    block-diagonalized channel, batched."""
    return torch.linalg.pinv(newH)


def _canonicalize_phases(x: torch.Tensor) -> torch.Tensor:
    """Rotate each column so its largest-magnitude entry is real positive,
    which makes a basis with arbitrary per-column phases deterministic."""
    mag2 = x.real ** 2 + x.imag ** 2                   # (..., m, n)
    pivot = torch.gather(x, -2, mag2.argmax(dim=-2, keepdim=True))
    mag = torch.sqrt(torch.clamp(pivot.real ** 2 + pivot.imag ** 2,
                                 min=1e-30))
    return x * (pivot.conj() / mag)


@_full_precision
def _bd_conditioning_ok(H: torch.Tensor, sigmas) -> torch.Tensor:
    """Degenerate-draw detector, scale-invariant: a draw is healthy when
    every user's ASCENDING singular values are well conditioned relative
    to each other and carry real gain relative to the channel's own
    Frobenius norm (which catches e.g. duplicated users)."""
    fro = torch.sqrt((H.real ** 2 + H.imag ** 2).sum(dim=(-2, -1)))
    ok = None
    for s in sigmas:
        u = (s[..., 0] > 1e-6 * s[..., -1]) & (s[..., -1] > 1e-5 * fro)
        ok = u if ok is None else (ok & u)
    return ok


@_full_precision
def bd_blocks_no_power_batched(H: torch.Tensor, num_users: int):
    """Per-user null-space precoder blocks WITHOUT power scaling, columns
    in ASCENDING effective-singular-value order with canonical phases.
    Returns ``(blocks, sigmas)``: per user a (..., Nt_total, r) block and
    its ascending (..., r) singular values, ``r = min(Nr_u, nS)``."""
    desc_blocks, desc_sigmas, _ = _stream_null_blocks(H, int(num_users))
    blocks = [_canonicalize_phases(b.flip(-1)) for b in desc_blocks]
    sigmas = [s.flip(-1) for s in desc_sigmas]
    return blocks, sigmas
