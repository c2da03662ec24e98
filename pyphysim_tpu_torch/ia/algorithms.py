"""Interference alignment algorithms, on the host in numpy.

Counterpart of ``pyphysim_tpu/ia/algorithms.py`` (itself the counterpart
of ``pyphysim/ia/algorithms.py``), over the port's
``MultiUserChannelMatrix``:
  * :class:`ClosedFormIASolver` — 3-user closed form [CadambeDoF2008]:
    ``E = H31^-1 H32 H12^-1 H13 H23^-1 H21``, F0 from eigenvectors of E
    (algorithms.py:42-265),
  * :class:`IterativeIASolverBaseClass` — init (random / closed_form /
    alt_min / svd / fix) + ``_step = _updateF; _updateW`` loop with
    relative-change convergence up to ``max_iterations``
    (algorithms.py:271-879),
  * :class:`AlternatingMinIASolver` — [PetersHeathAltMin2009]
    (algorithms.py:885-1126),
  * :class:`MinLeakageIASolver` (algorithms.py:1132-1237),
  * :class:`MaxSinrIASolver` — [Cadambe2008] per-stream max-SINR filters
    in forward and reverse networks (algorithms.py:1243-1504),
  * :class:`MMSEIASolver` — [Peters2011] MMSE with per-user Lagrange
    multiplier found by Newton iteration (algorithms.py:1510-1847),
  * :class:`GreedStreamIASolver` / :class:`BruteForceStreamIASolver` —
    meta-algorithms searching over stream counts (algorithms.py:1853-2234).
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import numpy as np
from scipy import optimize

from ..utils.misc import (get_principal_component_matrix, leig, peig,
                          update_inv_sum_diag)
from .iabase import IASolverBaseClass

__all__ = ["ClosedFormIASolver", "IterativeIASolverBaseClass",
           "AlternatingMinIASolver", "MinLeakageIASolver",
           "MaxSinrIASolver", "MMSEIASolver", "GreedStreamIASolver",
           "BruteForceStreamIASolver"]


def _obj_array(items) -> np.ndarray:
    """1-D object array of (possibly same-shaped) arrays — np.array with
    dtype=object would merge same-shaped entries into one 3D block."""
    out = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        out[i] = item
    return out


class ClosedFormIASolver(IASolverBaseClass):
    """3-user closed-form IA [CadambeDoF2008]."""

    def __init__(self, multiUserChannel, use_best_init: bool = True) -> None:
        super().__init__(multiUserChannel)
        self._use_best_init = bool(use_best_init)

    def _calc_E(self) -> np.ndarray:
        H31 = self._get_channel(2, 0)
        H32 = self._get_channel(2, 1)
        H12 = self._get_channel(0, 1)
        H13 = self._get_channel(0, 2)
        H23 = self._get_channel(1, 2)
        H21 = self._get_channel(1, 0)
        return np.linalg.solve(H31, H32) @ (
            np.linalg.solve(H12, H13) @ np.linalg.solve(H23, H21))

    def _calc_all_F_initializations(self, Ns: int) -> List[np.ndarray]:
        E = self._calc_E()
        eigenvectors = np.linalg.eig(E)[1]
        return [eigenvectors[:, list(comb)]
                for comb in itertools.combinations(
                    range(eigenvectors.shape[1]), Ns)]

    def _updateF(self, F0: Optional[np.ndarray] = None) -> None:
        self._clear_precoder_filter()
        self._F = np.zeros(3, dtype=np.ndarray)
        if F0 is None:
            E = self._calc_E()
            F0 = np.linalg.eig(E)[1][:, :int(self.Ns[0])]
        self._F[0] = F0
        self._F[1] = np.linalg.pinv(self._get_channel(2, 1)) @ \
            (self._get_channel(2, 0) @ F0)
        self._F[2] = np.linalg.pinv(self._get_channel(1, 2)) @ \
            (self._get_channel(1, 0) @ F0)
        for k in range(3):
            self._F[k] = self._F[k] / np.linalg.norm(self._F[k], "fro")

    def _updateW(self) -> None:
        self._clear_receive_filter()
        self._W = np.zeros(3, dtype=np.ndarray)
        A0 = self._get_channel(0, 1) @ self.F[1]
        self._W[0] = leig(A0 @ A0.conj().T, int(self.Ns[0]))[0]
        A1 = self._get_channel(1, 0) @ self.F[0]
        self._W[1] = leig(A1 @ A1.conj().T, int(self.Ns[1]))[0]
        A2 = self._get_channel(2, 0) @ self.F[0]
        self._W[2] = leig(A2 @ A2.conj().T, int(self.Ns[2]))[0]

    def solve(self, Ns, P=None) -> None:
        """Find the 3-user closed-form IA solution; with
        ``use_best_init`` try every eigenvector subset of E and keep the
        best sum capacity (algorithms.py:194-265)."""
        if self.K != 3:
            raise AssertionError(
                "The ClosedFormIASolver class only works in a MIMO-IC "
                "scenario with 3 users.")
        if isinstance(Ns, (int, np.integer)):
            Ns = np.full(3, int(Ns))
        self._Ns = np.asarray(Ns, dtype=int)
        self.P = P
        if self._use_best_init:
            best_capacity = -np.inf
            best_F, best_W = None, None
            for F0 in self._calc_all_F_initializations(int(self._Ns[0])):
                self._updateF(F0)
                self._updateW()
                capacity = self.calc_sum_capacity()
                if capacity > best_capacity:
                    best_capacity = capacity
                    best_F, best_W = self._F, self._W
            self._F, self._W = best_F, best_W
            self._full_F = None
        else:
            self._updateF()
            self._updateW()


class IterativeIASolverBaseClass(IASolverBaseClass):
    """Template for iterative IA solvers (algorithms.py:271-879)."""

    def __init__(self, multiUserChannel) -> None:
        super().__init__(multiUserChannel)
        self.max_iterations = 50
        self.relative_factor = 1e-6
        self._runned_iterations = 0
        self._initialize_with = "random"
        # optional solver used for the 'closed_form'/'alt_min' inits
        self._closed_form_ia_solver: Optional[ClosedFormIASolver] = None

    @property
    def initialize_with(self) -> str:
        return self._initialize_with

    @initialize_with.setter
    def initialize_with(self, value: str) -> None:
        options = ("random", "closed_form", "alt_min", "fix", "svd")
        if value not in options:
            raise RuntimeError(f"unknown initialization option: {value!r}")
        self._initialize_with = value

    @property
    def runned_iterations(self) -> int:
        return self._runned_iterations

    def clear(self) -> None:
        super().clear()
        self._runned_iterations = 0

    # -- template steps ----------------------------------------------------

    def _updateF(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _updateW(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _step(self) -> None:
        self._updateF()
        self._updateW()

    def _before_initialize_W_func(self) -> None:
        """Hook run before the initial receive-filter computation."""

    # -- initializations (algorithms.py:460-632) --------------------------

    def randomizeF(self, Ns, P=None) -> None:
        self._runned_iterations = 0
        super().randomizeF(Ns, P)

    def _initialize_F_randomly_and_find_W(self, Ns, P) -> None:
        self.randomizeF(Ns, P)
        self._before_initialize_W_func()
        self._updateW()

    def _initialize_F_with_svd_and_find_W(self, Ns, P) -> None:
        """F = dominant right singular vectors of the direct channel."""
        if isinstance(Ns, (int, np.integer)):
            Ns = np.full(self.K, int(Ns))
        Ns = np.asarray(Ns, dtype=int)
        self.P = P
        self._clear_precoder_filter()
        self._F = np.empty(self.K, dtype=np.ndarray)
        for k in range(self.K):
            _, _, vh = np.linalg.svd(self._get_channel(k, k))
            f = vh.conj().T[:, :int(Ns[k])]
            self._F[k] = f / np.linalg.norm(f, "fro")
        self._Ns = Ns.copy()
        self._before_initialize_W_func()
        self._updateW()

    def _dont_initialize_F_and_only_and_find_W(self, Ns=None,
                                               P=None) -> None:
        """'fix' mode: keep the current F (must have been set); the
        stream counts are read off the precoder shapes
        (algorithms.py:546-566)."""
        if self._F is None:
            raise RuntimeError(
                "The 'fix' initialization requires that the precoders "
                "were already set (e.g. by a previous solve)")
        self._Ns = np.array([f.shape[1] for f in self._F])
        self._before_initialize_W_func()
        self._updateW()

    def _initialize_F_and_W_from_closed_form(self, Ns, P) -> None:
        solver = ClosedFormIASolver(self._multiUserChannel,
                                    use_best_init=True)
        solver.solve(Ns, P)
        self.P = P
        self._F = solver.F
        self._Ns = solver.Ns.copy()
        self._before_initialize_W_func()
        self._W = solver.W

    def _initialize_F_and_W_from_alt_min(self, Ns, P) -> None:
        solver = AlternatingMinIASolver(self._multiUserChannel)
        solver.max_iterations = self.max_iterations
        solver.solve(Ns, P)
        self.P = P
        self._F = solver.F
        self._Ns = solver.Ns.copy()
        self._before_initialize_W_func()
        self._W = np.empty(self.K, dtype=np.ndarray)
        for k in range(self.K):
            self._W[k] = solver.W[k]

    def _solve_init(self, Ns, P) -> None:
        self.P = P
        options = {
            "random": self._initialize_F_randomly_and_find_W,
            "alt_min": self._initialize_F_and_W_from_alt_min,
            "closed_form": self._initialize_F_and_W_from_closed_form,
            "fix": self._dont_initialize_F_and_only_and_find_W,
            "svd": self._initialize_F_with_svd_and_find_W,
        }
        options[self.initialize_with](Ns, P)

    # -- finalize (algorithms.py:665-752) ---------------------------------

    def _solve_finalize(self) -> None:
        """Drop zero-energy precoder dimensions via principal
        components."""
        mod_users = []
        num_sig = []
        full_F = self.full_F  # make sure it exists
        for k in range(self.K):
            if self.Ns[k] > 1:
                S = np.linalg.svd(self._F[k], compute_uv=False)
                if S.max() / max(S.min(), 1e-30) > 1e4:
                    mod_users.append(k)
                    n = int(np.count_nonzero(S > S.max() / 1e4))
                    num_sig.append(n)
                    new_F = get_principal_component_matrix(self._F[k], n)
                    self._F[k] = new_F / np.linalg.norm(new_F, "fro")
                    if full_F is not None and full_F[k] is not None:
                        norm = np.linalg.norm(full_F[k], "fro")
                        new_full = get_principal_component_matrix(
                            full_F[k], n)
                        self._full_F[k] = (new_full /
                                           np.linalg.norm(new_full, "fro")
                                           * norm)
                    self._Ns[k] = n
        if mod_users:
            if self._W is not None:
                for k, n in zip(mod_users, num_sig):
                    self._W[k] = get_principal_component_matrix(
                        self._W[k], n)
                self._W_H = None
            elif self._W_H is not None:
                for k, n in zip(mod_users, num_sig):
                    W = self._W_H[k].conj().T
                    self._W_H[k] = get_principal_component_matrix(
                        W, n).conj().T

    @classmethod
    def _is_diff_significant(cls, F_old, F_new,
                             relative_factor: float) -> bool:
        """True if any precoder entry moved more than
        ``relative_factor * min |F_new|`` (algorithms.py:755-800)."""
        for k in range(F_old.size):
            min_value = np.abs(F_new[k]).min()
            if np.abs(F_new[k] - F_old[k]).max() > \
                    min_value * relative_factor:
                return True
        return False

    def solve(self, Ns, P=None) -> int:
        """Iterate ``_step`` until convergence or ``max_iterations``;
        returns the number of iterations run (algorithms.py:802-879)."""
        if isinstance(Ns, (int, np.integer)):
            Ns = np.full(self.K, int(Ns))
        self._solve_init(Ns, P)
        for _ in range(self.max_iterations):
            F_old = _obj_array([f.copy() for f in self._F])
            self._runned_iterations += 1
            self._step()
            F_new = _obj_array(list(self._F))
            if not self._is_diff_significant(F_old, F_new,
                                             self.relative_factor):
                break
        self._solve_finalize()
        return self._runned_iterations


class AlternatingMinIASolver(IterativeIASolverBaseClass):
    """[PetersHeathAltMin2009] alternating minimization."""

    def __init__(self, multiUserChannel) -> None:
        super().__init__(multiUserChannel)
        self._C: Optional[np.ndarray] = None

    @IterativeIASolverBaseClass.initialize_with.setter
    def initialize_with(self, value: str) -> None:
        if value == "closed_form":
            raise RuntimeError(
                "Can't initialize the AlternatingMinIASolver with the "
                "closed form algorithm")
        IterativeIASolverBaseClass.initialize_with.fset(self, value)

    def get_cost(self) -> float:
        """Total interference energy OUTSIDE the interference subspace
        (algorithms.py:937-963)."""
        cost = 0.0
        for l in range(self.K):
            for k in range(self.K):
                if k == l:
                    continue
                HF = self._get_channel(k, l) @ self.full_F[l]
                Y = (np.eye(int(self.Nr[k])) -
                     self._C[k] @ self._C[k].conj().T)
                cost += np.linalg.norm(Y @ HF, "fro") ** 2
        return float(cost)

    def _before_initialize_W_func(self) -> None:
        self._updateC()

    def _step(self) -> None:
        self._updateC()
        self._updateF()
        self._updateW()

    def _updateC(self) -> None:
        """C_k = dominant Nr-Ns eigenvectors of the interference
        covariance (the interference subspace)."""
        Ni = self.Nr - self._Ns
        self._C = np.empty(self.K, dtype=np.ndarray)
        for k in range(self.K):
            self._C[k] = peig(self.calc_Q(k), int(Ni[k]))[0]

    def _updateF(self) -> None:
        self._clear_precoder_filter()
        newF = np.zeros(self.K, dtype=np.ndarray)
        Y = [np.eye(int(self.Nr[k])) - self._C[k] @ self._C[k].conj().T
             for k in range(self.K)]
        for l, k in itertools.permutations(range(self.K), 2):
            H = self._get_channel(k, l)
            term = H.conj().T @ Y[k] @ H
            newF[l] = newF[l] + term
        self._F = np.empty(self.K, dtype=np.ndarray)
        for k in range(self.K):
            f = leig(newF[k], int(self._Ns[k]))[0]
            self._F[k] = f / np.linalg.norm(f, "fro")

    def _updateW(self) -> None:
        """ZF receive filter from [tilde_H = [Hkk Fk, Ck]]
        (algorithms.py:1097-1126)."""
        self._clear_receive_filter()
        newW_H = np.zeros(self.K, dtype=np.ndarray)
        for k in range(self.K):
            tildeHi = np.hstack(
                [self._get_channel(k, k) @ self._F[k], self._C[k]])
            newW_H[k] = np.linalg.inv(tildeHi)[:int(self._Ns[k])]
        self._W_H = newW_H

    def _solve_finalize(self) -> None:
        pass  # ZF inverse keeps dimensions; nothing to drop


class MinLeakageIASolver(IterativeIASolverBaseClass):
    """Minimum interference leakage (algorithms.py:1132-1237)."""

    def get_cost(self) -> float:
        cost = 0.0
        for k in range(self.K):
            Qk = self.calc_Q(k)
            Wk = self._W[k]
            cost += np.trace(np.abs(Wk.conj().T @ Qk @ Wk))
        return float(cost)

    def _calc_Uk_all_k(self) -> np.ndarray:
        Uk = np.empty(self.K, dtype=np.ndarray)
        for k in range(self.K):
            Uk[k] = leig(self.calc_Q(k), int(self._Ns[k]))[0]
        return Uk

    def _calc_Uk_all_k_rev(self) -> np.ndarray:
        Uk = np.empty(self.K, dtype=np.ndarray)
        for k in range(self.K):
            Uk[k] = leig(self.calc_Q_rev(k), int(self._Ns[k]))[0]
        return Uk

    def _updateF(self) -> None:
        self._clear_precoder_filter()
        self._F = self._calc_Uk_all_k_rev()

    def _updateW(self) -> None:
        self._clear_receive_filter()
        self._W = self._calc_Uk_all_k()


class MaxSinrIASolver(IterativeIASolverBaseClass):
    """[Cadambe2008] max-SINR per-stream filters."""

    def _calc_Bkl_cov_matrix_first_part_rev(self, k: int) -> np.ndarray:
        P = self.P
        first = np.zeros((int(self.Nt[k]),) * 2, dtype=complex)
        for j in range(self.K):
            Hkj = self._get_channel_rev(k, j)
            Vj = self._W[j]
            first += (float(P[j]) / self._Ns[j]) * \
                (Hkj @ Vj @ Vj.conj().T @ Hkj.conj().T)
        return first

    def _calc_Bkl_cov_matrix_second_part_rev(self, k: int,
                                             l: int) -> np.ndarray:
        P = self.P
        Hkk = self._get_channel_rev(k, k)
        Vkl = self._W[k][:, l:l + 1]
        return (float(P[k]) / self._Ns[k]) * \
            (Hkk @ Vkl @ Vkl.conj().T @ Hkk.conj().T)

    def _calc_Bkl_cov_matrix_all_l_rev(self, k: int) -> np.ndarray:
        first = self._calc_Bkl_cov_matrix_first_part_rev(k)
        eye = np.eye(int(self.Nt[k]))
        out = np.empty(int(self._Ns[k]), dtype=np.ndarray)
        for l in range(int(self._Ns[k])):
            out[l] = (first -
                      self._calc_Bkl_cov_matrix_second_part_rev(k, l) +
                      self.noise_var * eye)
        return out

    @classmethod
    def _calc_Ukl(cls, Hkk: np.ndarray, Vk: np.ndarray, Bkl: np.ndarray,
                  l: int) -> np.ndarray:
        Vkl = Vk[:, l:l + 1]
        Ukl = np.linalg.solve(Bkl, Hkk @ Vkl)
        return Ukl / np.linalg.norm(Ukl, "fro")

    @classmethod
    def _calc_Uk(cls, Hkk: np.ndarray, Vk: np.ndarray,
                 Bkl_all_l: np.ndarray) -> np.ndarray:
        num_streams = Bkl_all_l.size
        Uk = np.zeros((Bkl_all_l[0].shape[0], num_streams), dtype=complex)
        for l in range(num_streams):
            Uk[:, l] = cls._calc_Ukl(Hkk, Vk, Bkl_all_l[l], l)[:, 0]
        return Uk / np.linalg.norm(Uk, "fro")

    def _calc_Uk_all_k(self) -> np.ndarray:
        Uk = np.empty(self.K, dtype=np.ndarray)
        for k in range(self.K):
            Hkk = self._get_channel(k, k)
            Bkl = self._calc_Bkl_cov_matrix_all_l(k, self.noise_var)
            Uk[k] = self._calc_Uk(Hkk, self.full_F[k], Bkl)
        return Uk

    def _calc_Uk_all_k_rev(self) -> np.ndarray:
        Uk = np.empty(self.K, dtype=np.ndarray)
        for k in range(self.K):
            Hkk = self._get_channel_rev(k, k)
            Vk = self._W[k] * np.sqrt(self.P[k])
            Bkl = self._calc_Bkl_cov_matrix_all_l_rev(k)
            Uk[k] = self._calc_Uk(Hkk, Vk, Bkl)
        return Uk

    def _updateF(self) -> None:
        self._clear_precoder_filter()
        self._F = self._calc_Uk_all_k_rev()

    def _updateW(self) -> None:
        self._clear_receive_filter()
        self._W = self._calc_Uk_all_k()


class MMSEIASolver(IterativeIASolverBaseClass):
    """[Peters2011] MMSE IA with per-user power constraint via a Lagrange
    multiplier found by Newton iteration."""

    def __init__(self, multiUserChannel) -> None:
        super().__init__(multiUserChannel)
        self._mu: Optional[np.ndarray] = None

    def _solve_init(self, Ns, P) -> None:
        super()._solve_init(Ns, P)
        self._mu = np.zeros(self.K)

    def _calc_Uk(self, k: int) -> np.ndarray:
        Hkk = self._get_channel(k, k)
        Vk = self.full_F[k]
        total = np.zeros((int(self.Nr[k]),) * 2, dtype=complex)
        for i in range(self.K):
            aux = self._get_channel(k, i) @ self.full_F[i]
            total += aux @ aux.conj().T
        total += self.noise_var * np.eye(int(self.Nr[k]))
        return np.linalg.solve(total, Hkk @ Vk)

    def _updateW(self) -> None:
        self._clear_receive_filter()
        self._W = np.empty(self.K, dtype=np.ndarray)
        for k in range(self.K):
            self._W[k] = self._calc_Uk(k)

    @staticmethod
    def _calc_Vi_for_a_given_mu(sum_term: np.ndarray, mu_i: float,
                                H_herm_U: np.ndarray) -> np.ndarray:
        n = sum_term.shape[0]
        return np.linalg.solve(sum_term + mu_i * np.eye(n), H_herm_U)

    @staticmethod
    def _calc_Vi_for_a_given_mu2(inv_sum_term: np.ndarray, mu_i: float,
                                 H_herm_U: np.ndarray) -> np.ndarray:
        n = inv_sum_term.shape[0]
        new_inv = update_inv_sum_diag(inv_sum_term, mu_i * np.ones(n))
        return new_inv @ H_herm_U

    def _calc_Vi(self, i: int,
                 mu_i: Optional[float] = None) -> np.ndarray:
        Hii_herm_U = self._get_channel(i, i).conj().T @ self.W[i]
        sum_term = np.zeros((int(self.Nt[i]),) * 2, dtype=complex)
        for k in range(self.K):
            aux = self._get_channel(k, i).conj().T @ self.W[k]
            sum_term += aux @ aux.conj().T

        # diagonal loading for (near-)singular matrices
        S = np.linalg.svd(sum_term, compute_uv=False)
        load_factor = 0.0
        if S.max() / max(S.min(), 1e-30) > 5e4:
            load_factor = S.mean() / 100.0
            sum_term = sum_term + np.eye(sum_term.shape[0]) * load_factor

        if mu_i is not None:
            self._mu[i] = mu_i
            return self._calc_Vi_for_a_given_mu(sum_term, mu_i, Hii_herm_U)

        def cost(mu: float, st, hu, p) -> float:
            vi = self._calc_Vi_for_a_given_mu(st, mu, hu)
            return float(np.linalg.norm(vi, "fro") ** 2 - p)

        scale = np.linalg.norm(Hii_herm_U)
        Hii_herm_U = Hii_herm_U / scale
        sum_term = sum_term / scale

        if cost(0.0, sum_term, Hii_herm_U, self.P[i]) <= 0:
            self._mu[i] = 0.0
            return self._calc_Vi_for_a_given_mu(sum_term, 0.0, Hii_herm_U)
        mu = optimize.newton(cost, 0.0,
                             args=(sum_term, Hii_herm_U, float(self.P[i])),
                             maxiter=200)
        if abs(mu) > 1e20:
            mu = optimize.newton(
                cost, 0.0, args=(sum_term * 10, Hii_herm_U * 10,
                                 float(self.P[i])), maxiter=200) / 10.0
            if cost(mu, sum_term, Hii_herm_U, self.P[i]) > self.P[i] / 1e6:
                raise RuntimeError(
                    "Could not find a good Lagrange multiplier")
        self._mu[i] = float(mu) + load_factor
        return self._calc_Vi_for_a_given_mu(sum_term, float(mu),
                                            Hii_herm_U)

    def _updateF(self) -> None:
        self._mu = -np.ones(self.K)
        Vi = np.empty(self.K, dtype=np.ndarray)
        norm_Vi = np.empty(self.K, dtype=np.ndarray)
        for k in range(self.K):
            Vi[k] = self._calc_Vi(k)
            norm_Vi[k] = Vi[k] / np.linalg.norm(Vi[k], "fro")
        self._clear_precoder_filter()
        self._full_F = Vi
        self._F = norm_Vi


class GreedStreamIASolver:
    """Meta-solver: iteratively delete the worst-SINR stream while the sum
    capacity improves (algorithms.py:1853-2051)."""

    def __init__(self, iasolver_obj) -> None:
        self._iasolver = iasolver_obj
        self._runned_iterations = 0
        self.every_sum_capacity: List[float] = []

    @property
    def iasolver(self):
        return self._iasolver

    @property
    def runned_iterations(self) -> int:
        return self._runned_iterations

    def solve(self, Ns, P=None) -> int:
        self._runned_iterations = 0
        self.every_sum_capacity = []
        ia = self._iasolver
        self._runned_iterations += ia.solve(Ns, P)
        self.every_sum_capacity.append(ia.calc_sum_capacity())
        best_F = _obj_array([f.copy() for f in ia.F])
        best_full_F = _obj_array([f.copy() for f in ia.full_F])
        best_W_H = _obj_array([w.copy() for w in ia.W_H])
        best_Ns = ia.Ns.copy()

        keep_going = True
        while keep_going and np.sum(ia.Ns) > ia.K:
            user, stream = self._find_index_stream_with_worst_sinr()
            new_F = [f.copy() for f in ia.F]
            kept = [s for s in range(new_F[user].shape[1]) if s != stream]
            new_F[user] = new_F[user][:, kept]
            if new_F[user].shape[1] == 0:
                break
            ia.clear()
            ia.set_precoders(F=new_F, P=P)
            ia.initialize_with = "fix"
            self._runned_iterations += ia.solve(
                np.array([f.shape[1] for f in new_F]), P)
            self.every_sum_capacity.append(ia.calc_sum_capacity())
            if self.every_sum_capacity[-1] > self.every_sum_capacity[-2]:
                best_F = _obj_array([f.copy() for f in ia.F])
                best_full_F = _obj_array([f.copy() for f in ia.full_F])
                best_W_H = _obj_array([w.copy() for w in ia.W_H])
                best_Ns = ia.Ns.copy()
            else:
                keep_going = False
        ia.clear()
        ia.set_precoders(F=list(best_F), full_F=list(best_full_F), P=P)
        ia.set_receive_filters(W_H=list(best_W_H))
        ia._Ns = best_Ns
        return self._runned_iterations

    def _find_index_stream_with_worst_sinr(self):
        sinrs = self._iasolver.calc_SINR()
        worst_user = min(range(len(sinrs)),
                         key=lambda k: np.min(sinrs[k]))
        worst_stream = int(np.argmin(sinrs[worst_user]))
        return worst_user, worst_stream


class BruteForceStreamIASolver:
    """Meta-solver: try every per-user stream-count combination, keep the
    best sum capacity (algorithms.py:2057-2234). Uses svd initialization
    for determinism."""

    def __init__(self, iasolver_obj) -> None:
        self._iasolver = iasolver_obj
        self._runned_iterations = 0
        self._stream_combinations: Sequence = ()
        self._every_sum_capacity: List[float] = []
        self._best_F = None
        self._best_W_H = None
        self._best_Ns = None

    @property
    def iasolver(self):
        return self._iasolver

    @property
    def runned_iterations(self) -> int:
        return self._runned_iterations

    @property
    def stream_combinations(self) -> Sequence:
        return self._stream_combinations

    @property
    def every_sum_capacity(self) -> List[float]:
        return self._every_sum_capacity

    def clear(self) -> None:
        self._runned_iterations = 0
        self._stream_combinations = ()
        self._every_sum_capacity = []
        self._best_F = self._best_W_H = self._best_Ns = None

    def solve(self, Ns, P=None) -> int:
        ia = self._iasolver
        self.clear()
        ia.initialize_with = "svd"
        K = ia.K
        if isinstance(Ns, (int, np.integer)):
            max_Ns = [int(Ns)] * K
        else:
            max_Ns = [int(n) for n in Ns]
        per_user = [range(1, n + 1) for n in max_Ns]
        self._stream_combinations = tuple(itertools.product(*per_user))
        best_capacity = -np.inf
        for comb in self._stream_combinations:
            ia.clear()
            self._runned_iterations += ia.solve(np.array(comb), P)
            self._every_sum_capacity.append(ia.calc_sum_capacity())
            if self._every_sum_capacity[-1] > best_capacity:
                best_capacity = self._every_sum_capacity[-1]
                self._best_F = _obj_array([f.copy() for f in ia.F])
                self._best_W_H = _obj_array([w.copy() for w in ia.W_H])
                self._best_Ns = ia.Ns.copy()
        ia.clear()
        ia.set_precoders(F=list(self._best_F), P=P)
        ia.set_receive_filters(W_H=list(self._best_W_H))
        ia._Ns = self._best_Ns
        return self._runned_iterations
