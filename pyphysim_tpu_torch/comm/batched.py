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
range. Every pseudo-inverse is ``utils.misc.pinv``, which drops singular
values at or below 1e-3 of the largest as the JAX package's does.

The external-interference family is here too: whitening BD
(``whitening_bd_batched``) and stream-sacrifice BD
(``enhanced_bd_batched``, metrics None / naive / fixed / capacity /
effective_throughput), the batched counterparts of the host
``WhiteningBD`` and ``EnhancedBD``. The candidate stream counts are a
static loop; the best one per draw is chosen by ``argmax`` and
``torch.where``.

The null-space basis has an arbitrary phase per column, so the precoders
are not element-wise equal to the JAX package's; the block-diagonalized
channel, the singular values, the power constraints and the capacities are.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..subspace.projections import calcProjectionMatrix
from ..utils.conversion import linear2dB
from ..utils.misc import calc_whitening_matrix, full_precision, pinv
from .waterfilling import doWF_jit

__all__ = ["bd_precoders_batched", "bd_receive_filter_batched",
           "bd_blocks_no_power_batched", "whitening_matrix_batched",
           "whitening_bd_batched", "enhanced_bd_batched",
           "ENHANCED_METRICS"]

# the stream-sacrifice metrics of enhanced_bd_batched (None: no reduction)
ENHANCED_METRICS = (None, "naive", "fixed", "capacity",
                    "effective_throughput")


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


@full_precision
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


@full_precision
def bd_receive_filter_batched(newH: torch.Tensor) -> torch.Tensor:
    """Zero-forcing receive filter: the pseudo-inverse of the
    block-diagonalized channel, batched (singular values at or below 1e-3
    of the largest dropped, ``utils.misc.pinv``)."""
    return pinv(newH)


def _canonicalize_phases(x: torch.Tensor) -> torch.Tensor:
    """Rotate each column so its largest-magnitude entry is real positive,
    which makes a basis with arbitrary per-column phases deterministic."""
    mag2 = x.real ** 2 + x.imag ** 2                   # (..., m, n)
    pivot = torch.gather(x, -2, mag2.argmax(dim=-2, keepdim=True))
    mag = torch.sqrt(torch.clamp(pivot.real ** 2 + pivot.imag ** 2,
                                 min=1e-30))
    return x * (pivot.conj() / mag)


@full_precision
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


@full_precision
def bd_blocks_no_power_batched(H: torch.Tensor, num_users: int):
    """Per-user null-space precoder blocks WITHOUT power scaling, columns
    in ASCENDING effective-singular-value order with canonical phases.
    Returns ``(blocks, sigmas)``: per user a (..., Nt_total, r) block and
    its ascending (..., r) singular values, ``r = min(Nr_u, nS)``."""
    desc_blocks, desc_sigmas, _ = _stream_null_blocks(H, int(num_users))
    blocks = [_canonicalize_phases(b.flip(-1)) for b in desc_blocks]
    sigmas = [s.flip(-1) for s in desc_sigmas]
    return blocks, sigmas


# ---------------------------------------------------------------------------
# External-interference BD family (whitening / stream sacrifice), batched
# ---------------------------------------------------------------------------


@full_precision
def whitening_matrix_batched(R: torch.Tensor) -> torch.Tensor:
    """Batched ``calc_whitening_matrix``: ``W = V diag(w)^-1/2`` from the
    eigendecomposition of each covariance, eigenvalues floored for
    singular covariances."""
    return calc_whitening_matrix(R)


def _block_diag_c(blocks) -> torch.Tensor:
    """Block-diagonal (..., sum m, sum n) tensor from (..., m, n) blocks."""
    rows = sum(b.shape[-2] for b in blocks)
    cols = sum(b.shape[-1] for b in blocks)
    out = blocks[0].new_zeros(blocks[0].shape[:-2] + (rows, cols))
    r = c = 0
    for b in blocks:
        out[..., r:r + b.shape[-2], c:c + b.shape[-1]] = b
        r += b.shape[-2]
        c += b.shape[-1]
    return out


def _all_finite(x: torch.Tensor, dims: int) -> torch.Tensor:
    """Per draw: every entry of the trailing ``dims`` dims is finite."""
    return torch.isfinite(x).flatten(-dims).all(dim=-1)


@full_precision
def whitening_bd_batched(H: torch.Tensor, R: torch.Tensor, num_users: int,
                         iPu: float):
    """Whiten, block-diagonalize, fold the whitening into the receive
    filter, batched (the host ``WhiteningBD.block_diagonalize_no_
    waterfilling``).

    ``H`` (..., K * Nr_u, Nt_total): the joint channel WITHOUT the external
    interference columns; ``R`` (..., K, Nr_u, Nr_u): each user's
    ext-int-plus-noise covariance. Returns ``(Ms, Wk, valid)``: per-user
    precoders (..., K, Nt_total, r), ``r = min(Nr_u, nS)`` streams a user,
    each at power ``iPu``; composite receive filters (..., K, r, Nr_u); a
    finite-and-well-conditioned mask per draw."""
    K = int(num_users)
    nr_u = H.shape[-2] // K
    whiteners = [whitening_matrix_batched(R[..., k, :, :]).mH
                 for k in range(K)]                     # W^H applied
    bigW = _block_diag_c(whiteners)
    Hw = bigW @ H
    blocks, sigmas = bd_blocks_no_power_batched(Hw, K)
    scaled = [b * (iPu ** 0.5 / torch.clamp(_block_power(b, keepdim=True),
                                            min=1e-30))
              for b in blocks]
    Ms = torch.cat(scaled, dim=-1)
    big_Wrx = pinv(Hw @ Ms) @ bigW
    nS = Ms.shape[-1] // K
    Wk = torch.stack(
        [big_Wrx[..., k * nS:(k + 1) * nS, k * nr_u:(k + 1) * nr_u]
         for k in range(K)], dim=-3)
    finite = _all_finite(Wk, 3) & _all_finite(Ms, 2)
    return (torch.stack(scaled, dim=-3), Wk,
            finite & _bd_conditioning_ok(Hw, sigmas))


def _linear_sinrs(Wk: torch.Tensor, Heq_red: torch.Tensor,
                  Rk: torch.Tensor) -> torch.Tensor:
    """Per-stream SINRs of receive filter ``Wk`` on the reduced channel
    ``Heq_red`` under the ext-int-plus-noise covariance ``Rk`` (the host
    ``EnhancedBD._calc_linear_SINRs``)."""
    mtP = Wk @ Heq_red                                  # (..., ns, ns)
    p = mtP.real ** 2 + mtP.imag ** 2
    desired = torch.diagonal(p, dim1=-2, dim2=-1)
    internal = p.sum(dim=-1) - desired
    ext = torch.diagonal(Wk @ (Rk @ Wk.mH), dim1=-2, dim2=-1).real.abs()
    return desired / torch.clamp(internal + ext, min=1e-30)


def _select(cands, best: torch.Tensor) -> torch.Tensor:
    """``cands[best]`` per draw: ``cands`` a list of (..., *tail) tensors,
    ``best`` a (...,) index tensor."""
    out = cands[0]
    for c in range(1, len(cands)):
        hit = (best == c).reshape(best.shape + (1,) * (out.dim() -
                                                       best.dim()))
        out = torch.where(hit, cands[c], out)
    return out


@full_precision
def enhanced_bd_batched(H: torch.Tensor, R: torch.Tensor, num_users: int,
                        iPu: float, metric=None, num_streams: int = 1,
                        modulator=None, packet_length: int = 60):
    """Stream-sacrifice BD under external interference, batched (the host
    ``EnhancedBD.block_diagonalize_no_waterfilling``).

    ``metric``: None (no reduction); ``"fixed"`` / ``"naive"`` (keep
    ``num_streams`` through the ext-int reduction basis / the identity's
    first columns); ``"capacity"`` (the candidate count of largest Shannon
    sum capacity); ``"effective_throughput"`` (of largest ``modulator``
    spectral efficiency at ``packet_length``). Every candidate count
    1..Nr_u is computed; ``argmax`` picks one per draw.

    ``H`` (..., K * Nr_u, Nt_total): the joint channel without the ext-int
    columns, ``Nt_total >= K * Nr_u`` (each user keeps Nr_u BD streams,
    the space the covariance-derived reduction basis lives in); ``R``
    (..., K, Nr_u, Nr_u): the ext-int-plus-noise covariances.

    Returns ``(MsPk, Wk, Ns, sinrs, valid)``: zero-padded per-user
    precoders (..., K, Nt_total, Nr_u), receive filters (..., K, Nr_u,
    Nr_u), stream counts (..., K) as floats, per-stream SINRs (..., K,
    Nr_u) (0 for dropped streams), and a mask of the healthy draws."""
    K = int(num_users)
    nr_tot, nt_tot = H.shape[-2], H.shape[-1]
    nr_u = nr_tot // K
    nS = nt_tot - (K - 1) * nr_u
    if nS < nr_u:
        raise ValueError(
            "enhanced_bd_batched needs Nt_total >= K*Nr_u so every user "
            f"keeps Nr_u streams; got null dim nS={nS} < Nr_u={nr_u}")
    if metric == "None":
        metric = None
    if metric not in ENHANCED_METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    ntk = nr_u                      # candidate stream counts 1..ntk
    if metric in ("fixed", "naive") and not 1 <= num_streams <= ntk:
        raise ValueError(f"num_streams must be in 1..{ntk}")
    if metric == "effective_throughput" and modulator is None:
        raise ValueError("effective_throughput requires a modulator")
    blocks, sigmas = bd_blocks_no_power_batched(H, K)
    eye = torch.eye(ntk, dtype=H.dtype, device=H.device)
    sqrt_ipu = float(iPu) ** 0.5
    batch = H.shape[:-2]

    def candidate(Ms_k, Heq_k, Rk, V_asc, ns: int):
        if metric == "naive":
            Pk = eye[:, :ns]
        elif ns == ntk and metric != "fixed":
            Pk = eye                 # all streams: the identity
        else:
            Pk = V_asc[..., :, :ns]
        MsPk_red = Ms_k @ Pk
        norm = torch.clamp(_block_power(MsPk_red, keepdim=True) / sqrt_ipu,
                           min=1e-30)
        Heq_red = (Heq_k @ Pk) / norm
        if ns == ntk:
            Wk = pinv(Heq_red)
        else:
            Pbar = calcProjectionMatrix(Pk)
            Wk = pinv(Pbar @ Heq_red) @ Pbar
        sinr = _linear_sinrs(Wk, Heq_red, Rk)
        pad = ntk - ns                # zero columns / rows / SINRs
        return (torch.nn.functional.pad(MsPk_red / norm, (0, pad)),
                torch.nn.functional.pad(Wk, (0, 0, 0, pad)),
                torch.nn.functional.pad(sinr, (0, pad)))

    Ms_users, W_users, Ns_users, sinr_users, ok_users = [], [], [], [], []
    for k in range(K):
        Ms_k = blocks[k]
        Rk = R[..., k, :, :]
        Heq_k = _user_rows(H, k, nr_u) @ Ms_k
        V_asc = None
        if metric not in (None, "naive"):
            # the ext-int reduction basis: the covariance's eigenvectors in
            # ascending order (its right singular vectors, R being PSD),
            # phases canonical as the host helper makes them
            V_asc = _canonicalize_phases(torch.linalg.eigh(Rk)[1])
        if metric is None or metric in ("fixed", "naive"):
            ns = ntk if metric is None else num_streams
            Ms_p, Wk_p, sinr_p = candidate(Ms_k, Heq_k, Rk, V_asc, ns)
            ns_sel = torch.full(batch, float(ns), dtype=H.real.dtype,
                                device=H.device)
        else:
            cands = [candidate(Ms_k, Heq_k, Rk, V_asc, ns)
                     for ns in range(1, ntk + 1)]
            if metric == "capacity":
                vals = [torch.log2(1.0 + s).sum(dim=-1) for _, _, s in cands]
            else:
                vals = [modulator.calcTheoreticalSpectralEfficiency(
                    linear2dB(torch.clamp(s[..., :ns], min=1e-30)),
                    packet_length).sum(dim=-1)
                    for ns, (_, _, s) in enumerate(cands, start=1)]
            best = torch.argmax(torch.stack(vals, dim=-1), dim=-1)
            Ms_p, Wk_p, sinr_p = (_select([c[i] for c in cands], best)
                                  for i in range(3))
            ns_sel = best.to(H.real.dtype) + 1.0
        Ms_users.append(Ms_p)
        W_users.append(Wk_p)
        Ns_users.append(ns_sel)
        sinr_users.append(sinr_p)
        ok_users.append(_all_finite(Wk_p, 2))

    valid = torch.stack(ok_users, dim=-1).all(dim=-1) & \
        _bd_conditioning_ok(H, sigmas)
    return (torch.stack(Ms_users, dim=-3), torch.stack(W_users, dim=-3),
            torch.stack(Ns_users, dim=-1), torch.stack(sinr_users, dim=-2),
            valid)
