"""Block diagonalization multiuser precoding, on the host.

Counterpart of ``pyphysim_tpu/comm/blockdiagonalization.py``:
  * :class:`BlockDiagonalizer` — [Spencer2004] BD: per user, null space of
    the stacked other-user channels via least right singular vectors
    (blockdiagonalization.py:272-363), global water-filling power scaling
    (:365-401), per-BS normalized scaling (:403-464), no-waterfilling
    equal-power variant (:510-565), ZF receive filter (:567-584).
  * :class:`BDWithExtIntBase` / :class:`WhiteningBD` — BD + external
    interference whitening (:666-837).
  * :class:`EnhancedBD` — BD with stream sacrifice to dodge external
    interference; metric = None / fixed / naive / capacity /
    effective_throughput (:839-1469).

Implementation is host-side numpy (these are per-realization precoder
computations, typically amortized over many symbols); the channel inputs
accept numpy complex matrices or tensors (copied to the host at entry).
Every pseudo-inverse is ``utils.misc.pinv``: singular values at or below
1e-3 of the largest are dropped, as in the batched solvers
(``comm/batched.py``), which are the Monte Carlo hot path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.linalg import block_diag

import torch

from ..subspace.projections import calcProjectionMatrix
from ..utils.conversion import linear2dB, single_matrix_to_matrix_of_matrices
from ..utils.misc import (calc_shannon_sum_capacity, calc_whitening_matrix,
                          least_right_singular_vectors, pinv)
from . import waterfilling

__all__ = ["BlockDiagonalizer", "BDWithExtIntBase", "WhiteningBD",
           "EnhancedBD", "block_diagonalize", "calc_receive_filter"]


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def block_diagonalize(mtChannel, num_users: int, iPu: float,
                      noise_var: float):
    """Convenience wrapper (blockdiagonalization.py:39-76)."""
    bd = BlockDiagonalizer(num_users, iPu, noise_var)
    return bd.block_diagonalize(mtChannel)


def calc_receive_filter(newH) -> np.ndarray:
    """ZF receive filter for the block-diagonalized channel."""
    return BlockDiagonalizer.calc_receive_filter(newH)


def _calc_stream_reduction_matrix(Re_k, kept_streams: int) -> np.ndarray:
    """Matrix whose columns are the ``kept_streams`` least significant
    right singular vectors of the ext-int covariance
    (blockdiagonalization.py:120-144), per-column phases canonicalized
    (largest-|entry| pivot real positive) so the construction is
    deterministic across backends and matches the batched device solver
    — the singular-vector phase is a pure gauge here (the receive
    filter compensates it exactly)."""
    V0 = least_right_singular_vectors(_as_np(Re_k), kept_streams)[0]
    piv = V0[np.abs(V0).argmax(axis=0), np.arange(V0.shape[1])]
    return V0 * np.conj(piv / np.maximum(np.abs(piv), 1e-30))


def _calc_effective_throughput(sinrs, modulator,
                               packet_length: int) -> float:
    """Sum spectral efficiency at the given SINRs
    (blockdiagonalization.py:147-175)."""
    se = modulator.calcTheoreticalSpectralEfficiency(
        linear2dB(np.asarray(sinrs)), packet_length)
    return float(np.sum(se))


class BlockDiagonalizer:
    """[Spencer2004] block diagonalization with water-filling options.

    Example (mirrors the reference doctest at
    blockdiagonalization.py:226-255): the equivalent channel ``H @ Ms``
    is block-diagonal and the per-user power constraint holds.

    >>> import numpy as np
    >>> rng = np.random.RandomState(0)
    >>> H = rng.randn(4, 4) + 1j * rng.randn(4, 4)
    >>> bd = BlockDiagonalizer(num_users=2, iPu=1.0, noise_var=1e-3)
    >>> newH, Ms = bd.block_diagonalize(H)
    >>> bool(np.abs(newH[:2, 2:]).max() < 1e-10)   # off-diagonal nulled
    True
    >>> bool(np.abs(newH[2:, :2]).max() < 1e-10)
    True
    >>> float(np.linalg.norm(Ms) ** 2) <= 2.0 + 1e-9  # total power
    True
    """

    def __init__(self, num_users: int, iPu: float,
                 noise_var: float) -> None:
        self.num_users = int(num_users)
        self.iPu = float(iPu)
        self.noise_var = float(noise_var)

    # -- core nulling ------------------------------------------------------

    def _calc_BD_matrix_no_power_scaling(
            self, mtChannel) -> Tuple[np.ndarray, np.ndarray]:
        """Null-space precoder per user, no power scaling
        (blockdiagonalization.py:272-363)."""
        H = _as_np(mtChannel)
        iNr = H.shape[0]
        if iNr % self.num_users != 0:
            raise ValueError(
                "`block_diagonalize`: Number of rows of the channel must "
                "be a multiple of the number of users.")
        iNrU = iNr // self.num_users
        Ms_bad = []
        Sigma: List[float] = []
        self._last_stream_widths = []
        for user in range(self.num_users):
            tilde_H = self._get_tilde_channel(H, user)
            # Null-space dimension of the other users' stacked rows. The
            # reference computes ``iNr - rank`` (blockdiagonalization.py
            # :335-338), which equals ``Nt_total - rank`` in its square
            # Nt_u == Nr_u scenario; the Nt_total form is the one that
            # stays the actual null dimension for non-square geometries
            # (Nt_u > Nr_u), where the precoder may then pick the best
            # ``Nr_u`` stream directions from the WHOLE null space
            # instead of an arbitrary LAPACK-basis-dependent subspace.
            null_dim = H.shape[1] - np.linalg.matrix_rank(tilde_H)
            if null_dim <= 0:
                raise ValueError(
                    "No null-space dimensions left for user "
                    f"{user}: Nt_total={H.shape[1]} <= "
                    f"rank(tilde_H)={H.shape[1] - null_dim}")
            tilde_V0 = least_right_singular_vectors(tilde_H, null_dim)[0]
            H_user = self._get_sub_channel(H, user)
            kept = min(iNrU, null_dim)
            _, V1, S = least_right_singular_vectors(
                H_user @ tilde_V0, null_dim - kept)
            self._last_stream_widths.append(V1.shape[1])
            # Canonical per-column phase (largest-|entry| pivot made real
            # positive): the SVD's phase freedom is physically meaningful
            # once EnhancedBD mixes these columns through the ext-int
            # reduction basis; pinning it makes the construction
            # deterministic across LAPACK/device backends and lets the
            # batched device solver (comm/batched.py) agree with this one
            # per-realization. BD itself is invariant to it.
            blk = tilde_V0 @ V1
            piv = blk[np.abs(blk).argmax(axis=0), np.arange(blk.shape[1])]
            blk = blk * np.conj(piv / np.maximum(np.abs(piv), 1e-30))
            Ms_bad.append(blk)
            Sigma.extend(np.asarray(S).tolist())
        return np.hstack(Ms_bad), np.asarray(Sigma)

    # -- power scalings ----------------------------------------------------

    def _perform_global_waterfilling_power_scaling(
            self, Ms_bad: np.ndarray, Sigma: np.ndarray) -> np.ndarray:
        total_power = self.num_users * self.iPu
        opt_p = waterfilling.doWF(Sigma ** 2, total_power,
                                  self.noise_var)[0]
        return Ms_bad @ np.diag(np.sqrt(opt_p))

    def _perform_normalized_waterfilling_power_scaling(
            self, Ms_bad: np.ndarray, Sigma: np.ndarray) -> np.ndarray:
        Ms_good = self._perform_global_waterfilling_power_scaling(
            Ms_bad, Sigma)
        max_sqrt_p = 0.0
        # per-user blocks by the ACTUAL stream widths — rank-deficient
        # draws can make them ragged, so a uniform total//K split would
        # group the wrong columns
        col = 0
        for width in self._last_stream_widths:
            um = Ms_good[:, col:col + width]
            col += width
            max_sqrt_p = max(max_sqrt_p, float(np.linalg.norm(um, "fro")))
        return Ms_good * np.sqrt(self.iPu) / max_sqrt_p

    # -- public API --------------------------------------------------------

    def block_diagonalize(self, mtChannel) -> Tuple[np.ndarray, np.ndarray]:
        """BD with per-BS-normalized water-filling
        (blockdiagonalization.py:466-509). Returns ``(newH, Ms)``."""
        H = _as_np(mtChannel)
        Ms_bad, Sigma = self._calc_BD_matrix_no_power_scaling(H)
        Ms_good = self._perform_normalized_waterfilling_power_scaling(
            Ms_bad, Sigma)
        return H @ Ms_good, Ms_good

    def block_diagonalize_no_waterfilling(
            self, mtChannel) -> Tuple[np.ndarray, np.ndarray]:
        """BD with equal per-BS power (blockdiagonalization.py:510-565).
        Per-user column blocks are the actual stream widths (== Nt_u in
        the reference's square scenario)."""
        H = _as_np(mtChannel)
        Ms_bad, _ = self._calc_BD_matrix_no_power_scaling(H)
        Ms_good = np.empty_like(Ms_bad)
        col = 0
        for width in self._last_stream_widths:
            um = Ms_bad[:, col:col + width]
            Ms_good[:, col:col + width] = \
                um * np.sqrt(self.iPu) / np.linalg.norm(um, "fro")
            col += width
        assert col == Ms_bad.shape[1]
        return H @ Ms_good, Ms_good

    @staticmethod
    def calc_receive_filter(newH) -> np.ndarray:
        """ZF: pseudo-inverse of the block-diagonalized channel
        (blockdiagonalization.py:567-584)."""
        return pinv(_as_np(newH))

    # -- helpers -----------------------------------------------------------

    def _get_tilde_channel(self, H: np.ndarray, user: int) -> np.ndarray:
        others = [i for i in range(self.num_users) if i != user]
        return self._get_sub_channel(H, others)

    def _get_sub_channel(self, H: np.ndarray, desired_users) -> np.ndarray:
        iNrU = H.shape[0] // self.num_users
        if isinstance(desired_users, int):
            desired_users = [desired_users]
        rows: List[int] = []
        for u in desired_users:
            rows.extend(range(iNrU * u, iNrU * (u + 1)))
        return H[rows, :]


class BDWithExtIntBase(BlockDiagonalizer):
    """BD base with external interference whitening
    (blockdiagonalization.py:666-721)."""

    def __init__(self, num_users: int, iPu: float, noise_var: float,
                 pe: float) -> None:
        super().__init__(num_users, iPu, noise_var)
        self.pe = float(pe)

    def calc_whitening_matrices(self, mu_channel) -> List[np.ndarray]:
        """Per-user whitening filters (conjugate transpose applied) from
        the ext-int-plus-noise covariance."""
        K = mu_channel.K
        R_all_k = mu_channel.calc_cov_matrix_extint_plus_noise(self.pe)
        return [calc_whitening_matrix(_as_np(R_all_k[k])).conj().T
                for k in range(K)]


class WhiteningBD(BDWithExtIntBase):
    """Whiten -> BD -> composite receive filter
    (blockdiagonalization.py:722-837)."""

    @staticmethod
    def _calc_receive_filter_with_whitening(
            newH: np.ndarray, whitening_filter: np.ndarray,
            Nr: np.ndarray, widths: np.ndarray) -> np.ndarray:
        K = Nr.size
        big_W = BlockDiagonalizer.calc_receive_filter(newH) @ \
            whitening_filter
        # big_W rows are STREAMS (per-user widths; == Nt in the
        # reference's square scenario, blockdiagonalization.py:769-779),
        # columns are receive antennas
        aux = single_matrix_to_matrix_of_matrices(big_W, widths, Nr)
        Wk_all = np.empty(K, dtype=np.ndarray)
        for k in range(K):
            Wk_all[k] = aux[k, k]
        return Wk_all

    def block_diagonalize_no_waterfilling(  # type: ignore[override]
            self, mu_channel) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        Nr = mu_channel.Nr
        H = _as_np(mu_channel.big_H_no_ext_int)
        whitening_all_k = self.calc_whitening_matrices(mu_channel)
        big_whitening = block_diag(*whitening_all_k)
        newH, Ms = BlockDiagonalizer.block_diagonalize_no_waterfilling(
            self, big_whitening @ H)
        # per-user column blocks by the ACTUAL stream widths (== Nt in
        # the reference's square scenario; min(Nr_u, null_dim) generally)
        widths = np.asarray(self._last_stream_widths)
        Ms_all = single_matrix_to_matrix_of_matrices(Ms, None, widths)
        Wk_all = self._calc_receive_filter_with_whitening(
            newH, big_whitening, Nr, widths)
        return Ms_all, Wk_all, widths.copy()


class EnhancedBD(BDWithExtIntBase):
    """BD with stream sacrifice to dodge external interference
    (blockdiagonalization.py:839-1469)."""

    def __init__(self, num_users: int, iPu: float, noise_var: float,
                 pe: float) -> None:
        super().__init__(num_users, iPu, noise_var, pe)
        self._metric_func_name = "None"
        self._metric_func = None
        self._metric_func_extra_args: Dict = {}

    # -- metric selection (blockdiagonalization.py:887-1043) --------------

    def set_ext_int_handling_metric(
            self, metric: Optional[str],
            metric_func_extra_args_dict: Optional[Dict] = None) -> None:
        extra = metric_func_extra_args_dict or {}
        if metric is None or metric == "None":
            self._metric_func_name = "None"
            self._metric_func = None
            self._metric_func_extra_args = {}
        elif metric == "capacity":
            self._metric_func_name = "capacity"
            self._metric_func = calc_shannon_sum_capacity
            self._metric_func_extra_args = {}
        elif metric in ("naive", "fixed"):
            if "num_streams" not in extra:
                raise AttributeError(
                    f"The '{metric}' metric requires that "
                    "metric_func_extra_args_dict is provided and has the "
                    "'num_streams' key")
            self._metric_func_name = metric
            self._metric_func = None
            self._metric_func_extra_args = {
                "num_streams": extra["num_streams"]}
        elif metric == "effective_throughput":
            if "modulator" not in extra or "packet_length" not in extra:
                raise AttributeError(
                    "The 'effective_throughput' metric requires that "
                    "metric_func_extra_args_dict is provided and has the "
                    "'modulator' and 'packet_length' keys")
            self._metric_func_name = "effective_throughput"
            self._metric_func = _calc_effective_throughput
            self._metric_func_extra_args = {
                "modulator": extra["modulator"],
                "packet_length": extra["packet_length"]}
        else:
            raise AttributeError(
                f"The `metric` attribute can only be one of {{None, "
                f"'capacity', 'naive', 'fixed', 'effective_throughput'}}, "
                f"but a value of '{metric}' was given")

    @property
    def metric_name(self) -> str:
        return self._metric_func_name

    # -- filters and SINR (blockdiagonalization.py:1056-1139) -------------

    @staticmethod
    def calc_receive_filter_user_k(Heq_k_P: np.ndarray,
                                   P: Optional[np.ndarray] = None
                                   ) -> np.ndarray:
        if P is None:
            return pinv(Heq_k_P)
        overbar_P = calcProjectionMatrix(P)
        return pinv(overbar_P @ Heq_k_P) @ overbar_P

    @staticmethod
    def _calc_linear_SINRs(Heq_k_red: np.ndarray, Wk: np.ndarray,
                           Re_k: np.ndarray) -> np.ndarray:
        mtP = Wk @ Heq_k_red
        desired = np.abs(np.diagonal(mtP)) ** 2
        internal = np.sum(np.abs(mtP - np.diagflat(np.diagonal(mtP))) ** 2,
                          axis=1)
        ext_plus_noise = np.diagonal(Wk @ _as_np(Re_k) @ Wk.conj().T).real
        return desired / (internal + np.abs(ext_plus_noise))

    # -- the three solver branches ----------------------------------------

    def _perform_BD_no_waterfilling_no_stream_reduction(self, mu_channel):
        K, Nr = mu_channel.K, mu_channel.Nr
        newH, Ms_good = BlockDiagonalizer.block_diagonalize_no_waterfilling(
            self, _as_np(mu_channel.big_H_no_ext_int))
        # split by the ACTUAL per-user stream widths (== Nt in the
        # reference's square scenario, blockdiagonalization.py:1139-1201)
        widths = np.asarray(self._last_stream_widths)
        MsPk = single_matrix_to_matrix_of_matrices(Ms_good, None, widths)
        newH_blocks = single_matrix_to_matrix_of_matrices(newH, Nr, widths)
        Wk_all = np.empty(K, dtype=np.ndarray)
        for k in range(K):
            Wk_all[k] = self.calc_receive_filter_user_k(
                newH_blocks[k, k], None)
        return MsPk, Wk_all, widths.copy()

    def _perform_BD_no_waterfilling_fixed_or_naive_reduction(
            self, mu_channel):
        K, Nr = mu_channel.K, mu_channel.Nr
        H = _as_np(mu_channel.big_H_no_ext_int)
        Re = mu_channel.calc_cov_matrix_extint_plus_noise(self.pe)
        Ms_bad, _ = self._calc_BD_matrix_no_power_scaling(H)
        widths = np.asarray(self._last_stream_widths)
        Ms_ks = single_matrix_to_matrix_of_matrices(Ms_bad, None, widths)
        H_ks = single_matrix_to_matrix_of_matrices(H, Nr)
        num_streams = self._metric_func_extra_args["num_streams"]
        MsPk = np.empty(K, dtype=np.ndarray)
        Wk_all = np.empty(K, dtype=np.ndarray)
        Ns_all = np.empty(K, dtype=int)
        for k in range(K):
            wk = widths[k]
            Heq_k = H_ks[k] @ Ms_ks[k]
            if self.metric_name == "naive":
                Pk = np.eye(wk)[:, :num_streams]
            else:
                self._require_cov_basis_coherent(wk, Nr[k])
                Pk = _calc_stream_reduction_matrix(Re[k], num_streams)
            norm_term = (np.linalg.norm(Ms_ks[k] @ Pk, "fro") /
                         np.sqrt(self.iPu))
            Heq_k_red = Heq_k @ (Pk / norm_term)
            Wk_all[k] = self.calc_receive_filter_user_k(Heq_k_red, Pk)
            MsPk[k] = (Ms_ks[k] @ Pk) / norm_term
            Ns_all[k] = num_streams
        return MsPk, Wk_all, Ns_all

    @staticmethod
    def _require_cov_basis_coherent(width: int, nr_k: int) -> None:
        """The ext-int stream-reduction basis lives in the per-user
        STREAM space, obtained from the (Nr_k x Nr_k) covariance
        (blockdiagonalization.py:120-144) — coherent only when the BD
        stream width equals Nr_k (true whenever Nt_total >= K * Nr_u,
        including non-square Nt_u > Nr_u geometries)."""
        if width != nr_k:
            raise ValueError(
                "Covariance-based stream reduction needs the BD stream "
                f"width ({width}) to equal the user's receive antenna "
                f"count ({nr_k}); use the 'naive' metric or add transmit "
                "antennas")

    def _perform_BD_no_waterfilling_decide_number_streams(self, mu_channel):
        K, Nr = mu_channel.K, mu_channel.Nr
        H = _as_np(mu_channel.big_H_no_ext_int)
        Re = mu_channel.calc_cov_matrix_extint_plus_noise(self.pe)
        Ms_bad, _ = self._calc_BD_matrix_no_power_scaling(H)
        widths = np.asarray(self._last_stream_widths)
        Ms_ks = single_matrix_to_matrix_of_matrices(Ms_bad, None, widths)
        H_ks = single_matrix_to_matrix_of_matrices(H, Nr)
        MsPk = np.empty(K, dtype=np.ndarray)
        Wk_all = np.empty(K, dtype=np.ndarray)
        Ns_all = np.empty(K, dtype=int)
        for k in range(K):
            Ntk = widths[k]  # candidate stream counts live in 1..width
            self._require_cov_basis_coherent(Ntk, Nr[k])
            Rek = _as_np(Re[k])
            Heq_k = H_ks[k] @ Ms_ks[k]
            metric_values = np.zeros(Ntk)
            Pk_all = np.empty(Ntk, dtype=np.ndarray)
            norms = np.empty(Ntk)
            Wk_cand = np.empty(Ntk, dtype=np.ndarray)
            for idx in range(Ntk):
                Ns_k = idx + 1
                Pk = (np.eye(Ntk) if idx == Ntk - 1 else
                      _calc_stream_reduction_matrix(Rek, Ns_k))
                Pk_all[idx] = Pk
                norms[idx] = (np.linalg.norm(Ms_ks[k] @ Pk, "fro") /
                              np.sqrt(self.iPu))
                Heq_k_red = Heq_k @ (Pk / norms[idx])
                Wk_cand[idx] = self.calc_receive_filter_user_k(Heq_k_red, Pk)
                sinrs = self._calc_linear_SINRs(Heq_k_red, Wk_cand[idx],
                                                Rek)
                metric_values[idx] = self._metric_func(
                    sinrs, **self._metric_func_extra_args)
            best = int(np.argmax(metric_values))
            MsPk[k] = (Ms_ks[k] @ Pk_all[best]) / norms[best]
            Wk_all[k] = Wk_cand[best]
            Ns_all[k] = Pk_all[best].shape[1]
        return MsPk, Wk_all, Ns_all

    def block_diagonalize_no_waterfilling(  # type: ignore[override]
            self, mu_channel):
        """Main entry (blockdiagonalization.py:1413-1469): dispatch on the
        configured metric. Returns ``(MsPk_all, Wk_all, Ns_all)``."""
        if self._metric_func_name == "None":
            return self._perform_BD_no_waterfilling_no_stream_reduction(
                mu_channel)
        if self._metric_func_name in ("naive", "fixed"):
            return \
                self._perform_BD_no_waterfilling_fixed_or_naive_reduction(
                    mu_channel)
        return self._perform_BD_no_waterfilling_decide_number_streams(
            mu_channel)
