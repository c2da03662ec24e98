"""Base class for interference alignment solvers.

Counterpart of ``pyphysim_tpu/ia/iabase.py`` (itself the counterpart of
``pyphysim/ia/iabase.py:26-1020``): shared state
(normalized precoders F, receive filters W, powers P, stream counts Ns)
over a :class:`~pyphysim_tpu_torch.channels.multiuser.MultiUserChannelMatrix`,
reverse-network channels ``H_rev_kl = H_lk^H`` (iabase.py:567-597),
interference covariances Q / Q_rev (iabase.py:600-667), Cadambe2008
eq. (28) Bkl matrices, per-stream SINR and sum capacity
(iabase.py:828-996, 814-825).

Implementation note: IA solves are small-matrix iterative algorithms with
data-dependent convergence and (for MMSE) scalar root finding. They run on
the host in numpy, as the JAX package's do, reading channel blocks out of
the port's (possibly device) MultiUserChannelMatrix. Monte Carlo
parallelism comes from the batched fixed-iteration solvers in
:mod:`.batched` and the Max-SINR kernel (``ops/ia_kernel.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..utils.conversion import linear2dB
from ..utils.misc import randn_c_RS

__all__ = ["IASolverBaseClass"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class IASolverBaseClass:
    """Shared machinery of all IA solvers."""

    def __init__(self, multiUserChannel) -> None:
        from ..channels.multiuser import MultiUserChannelMatrix
        if not isinstance(multiUserChannel, MultiUserChannelMatrix):
            raise ValueError(
                "multiUserChannel must be an object of the "
                "MultiUserChannelMatrix class (or a subclass)")
        self._multiUserChannel = multiUserChannel
        self._F: Optional[np.ndarray] = None
        self._full_F: Optional[np.ndarray] = None
        self._W: Optional[np.ndarray] = None
        self._W_H: Optional[np.ndarray] = None
        self._full_W_H: Optional[np.ndarray] = None
        self._full_W: Optional[np.ndarray] = None
        self._P: Optional[np.ndarray] = None
        self._Ns: Optional[np.ndarray] = None
        self._noise_var: Optional[float] = None
        self._rs = np.random.RandomState()

    def set_precoder_seed(self, seed: int) -> None:
        """Seed the RandomState used for random precoder initialization.

        The reference seeds only the channel (multiuser.py:670,
        set_channel_seed) and leaves precoder init on OS entropy; for
        reproducible solver runs (and order-independent tests) the init
        stream needs its own seed too.
        """
        self._rs = np.random.RandomState(seed)

    # -- clearing ----------------------------------------------------------

    def _clear_receive_filter(self) -> None:
        self._W = None
        self._W_H = None
        self._full_W_H = None
        self._full_W = None

    def _clear_precoder_filter(self) -> None:
        self._F = None
        self._full_F = None

    def clear(self) -> None:
        """Clear the IA solution (keep the channel)."""
        self._clear_receive_filter()
        self._clear_precoder_filter()
        self._P = None
        self._Ns = None

    def get_cost(self) -> float:
        """Cost of the current solution (-1 when the algorithm has no
        notion of cost)."""
        return -1.0

    # -- properties --------------------------------------------------------

    @property
    def noise_var(self) -> float:
        if self._noise_var is None:
            nv = self._multiUserChannel.noise_var
            return 0.0 if nv is None else float(nv)
        return self._noise_var

    @noise_var.setter
    def noise_var(self, value: Optional[float]) -> None:
        self._noise_var = value

    @property
    def F(self) -> Optional[np.ndarray]:
        """Normalized (unit Frobenius norm) precoders."""
        return self._F

    @property
    def full_F(self) -> Optional[np.ndarray]:
        """Precoders with power applied: ``F * sqrt(P)``."""
        if self._full_F is None and self._F is not None:
            self._full_F = np.empty(self.K, dtype=np.ndarray)
            for k in range(self.K):
                self._full_F[k] = self._F[k] * np.sqrt(self.P[k])
        return self._full_F

    def set_precoders(self, F=None, full_F=None, P=None) -> None:
        """Install external precoders (iabase.py:203-258)."""
        if F is None and full_F is None:
            raise RuntimeError("Either 'F' or 'full_F' must be provided.")
        if P is not None:
            self.P = P
        self._clear_receive_filter()
        K = self.K
        if full_F is not None:
            self._full_F = np.empty(K, dtype=np.ndarray)
            for k in range(K):
                self._full_F[k] = _np(full_F[k])
        if F is not None:
            self._F = np.empty(K, dtype=np.ndarray)
            for k in range(K):
                self._F[k] = _np(F[k])
        else:
            self._F = np.empty(K, dtype=np.ndarray)
            for k in range(K):
                fk = self._full_F[k]
                self._F[k] = fk / np.linalg.norm(fk, "fro")
        self._Ns = np.array([self._F[k].shape[1] for k in range(K)])

    @property
    def W(self) -> Optional[np.ndarray]:
        """Receive filters (before conjugate transpose)."""
        if self._W is None and self._W_H is not None:
            self._W = np.empty(self.K, dtype=np.ndarray)
            for k in range(self.K):
                self._W[k] = self._W_H[k].conj().T
        return self._W

    @property
    def W_H(self) -> Optional[np.ndarray]:
        if self._W_H is None and self._W is not None:
            self._W_H = np.empty(self.K, dtype=np.ndarray)
            for k in range(self.K):
                self._W_H[k] = self._W[k].conj().T
        return self._W_H

    @property
    def full_W_H(self) -> Optional[np.ndarray]:
        """Receive filters scaled so that ``W_H H F`` has unit diagonal
        (compensating the direct-channel gain, iabase.py:299-329)."""
        if self._full_W_H is None and self.W_H is not None:
            self._full_W_H = np.empty(self.K, dtype=np.ndarray)
            for k in range(self.K):
                W_H = self.W_H[k]
                H_eq = W_H @ self._calc_equivalent_channel(k)
                self._full_W_H[k] = np.linalg.solve(H_eq, W_H)
        return self._full_W_H

    @property
    def full_W(self) -> Optional[np.ndarray]:
        if self._full_W is None and self.full_W_H is not None:
            self._full_W = np.empty(self.K, dtype=np.ndarray)
            for k in range(self.K):
                self._full_W[k] = self.full_W_H[k].conj().T
        return self._full_W

    def set_receive_filters(self, W=None, W_H=None) -> None:
        if W is None and W_H is None:
            raise RuntimeError("Either 'W' or 'W_H' must be provided.")
        if W is not None and W_H is not None:
            raise RuntimeError("Either 'W' or 'W_H' must be provided "
                               "(not both).")
        self._clear_receive_filter()
        K = self.K
        if W is not None:
            self._W = np.empty(K, dtype=np.ndarray)
            for k in range(K):
                self._W[k] = _np(W[k])
        else:
            self._W_H = np.empty(K, dtype=np.ndarray)
            for k in range(K):
                self._W_H[k] = _np(W_H[k])

    def _calc_equivalent_channel(self, k: int) -> np.ndarray:
        """``H_kk @ full_F_k`` (iabase.py:381-414)."""
        return self._get_channel(k, k) @ self.full_F[k]

    @property
    def P(self) -> np.ndarray:
        if self._P is None:
            return np.ones(self.K)
        return self._P

    @P.setter
    def P(self, value: Optional[Union[float, Sequence[float]]]) -> None:
        if value is None:
            self._P = None
        elif np.isscalar(value):
            if value <= 0:
                raise ValueError("P cannot be negative or equal to zero.")
            self._P = np.full(self.K, float(value))
        else:
            value = np.asarray(value, dtype=float)
            if value.size != self.K:
                raise ValueError("P must have K elements")
            if np.any(value <= 0):
                raise ValueError("P cannot be negative or equal to zero.")
            self._P = value

    @property
    def Ns(self) -> Optional[np.ndarray]:
        return self._Ns

    @property
    def K(self) -> int:
        return self._multiUserChannel.K

    @property
    def Nr(self) -> np.ndarray:
        return self._multiUserChannel.Nr

    @property
    def Nt(self) -> np.ndarray:
        return self._multiUserChannel.Nt

    # -- randomization -----------------------------------------------------

    def randomizeF(self, Ns, P=None) -> None:
        """Random unit-norm precoders (iabase.py:511-548)."""
        self._clear_precoder_filter()
        if isinstance(Ns, (int, np.integer)):
            Ns = np.full(self.K, int(Ns))
        Ns = np.asarray(Ns, dtype=int)
        self.P = P
        self._F = np.empty(self.K, dtype=np.ndarray)
        for k in range(self.K):
            f = randn_c_RS(self._rs, int(self.Nt[k]), int(Ns[k]))
            self._F[k] = f / np.linalg.norm(f, "fro")
        self._Ns = Ns.copy()

    # -- channel access ----------------------------------------------------

    def _get_channel(self, k: int, l: int) -> np.ndarray:
        return _np(self._multiUserChannel.get_Hkl(k, l))

    def _get_channel_rev(self, k: int, l: int) -> np.ndarray:
        """Reverse network: ``H_rev_kl = H_lk^H`` (iabase.py:567-597)."""
        return self._get_channel(l, k).conj().T

    # -- covariances -------------------------------------------------------

    def calc_Q(self, k: int) -> np.ndarray:
        """Interference covariance at receiver k (no noise):
        ``sum_{j != k} H_kj full_F_j full_F_j^H H_kj^H``."""
        Qk = np.zeros((int(self.Nr[k]),) * 2, dtype=complex)
        for j in range(self.K):
            if j == k:
                continue
            HF = self._get_channel(k, j) @ self.full_F[j]
            Qk += HF @ HF.conj().T
        return Qk

    def calc_Q_rev(self, k: int) -> np.ndarray:
        """Reverse-network interference covariance (uses W as reverse
        precoders, iabase.py:635-667)."""
        P = self.P
        Qk = np.zeros((int(self.Nt[k]),) * 2, dtype=complex)
        W = self.W
        for j in range(self.K):
            if j == k:
                continue
            HW = self._get_channel_rev(k, j) @ W[j]
            Qk += (float(P[j]) / self._Ns[j]) * (HW @ HW.conj().T)
        return Qk

    def calc_remaining_interference_percentage(
            self, k: int, Qk: Optional[np.ndarray] = None) -> float:
        """Fraction of interference energy leaking into the receive
        subspace (iabase.py:670-716)."""
        if Qk is None:
            Qk = self.calc_Q(k)
        Wk = self.W[k]
        leaked = np.trace(np.abs(Wk.conj().T @ Qk @ Wk))
        total = np.trace(np.abs(Qk))
        if total == 0:
            return 0.0
        return float(np.abs(leaked) / np.abs(total))

    # -- SINR (Cadambe2008 eq. 28) ----------------------------------------

    def _calc_Bkl_cov_matrix_first_part(self, k: int) -> np.ndarray:
        first = np.zeros((int(self.Nr[k]),) * 2, dtype=complex)
        for j in range(self.K):
            aux = self._get_channel(k, j) @ self.full_F[j]
            first += aux @ aux.conj().T
        return first

    def _calc_Bkl_cov_matrix_second_part(self, k: int,
                                         l: int) -> np.ndarray:
        Hkk = self._get_channel(k, k)
        Vkl = self.full_F[k][:, l:l + 1]
        aux = Hkk @ Vkl
        return aux @ aux.conj().T

    def _calc_Bkl_cov_matrix_all_l(self, k: int,
                                   noise_power: Optional[float] = None
                                   ) -> np.ndarray:
        if noise_power is None:
            noise_power = self.noise_var
        first = self._calc_Bkl_cov_matrix_first_part(k)
        eye = np.eye(int(self.Nr[k]))
        out = np.empty(int(self._Ns[k]), dtype=np.ndarray)
        for l in range(int(self._Ns[k])):
            out[l] = (first -
                      self._calc_Bkl_cov_matrix_second_part(k, l) +
                      noise_power * eye)
        return out

    def _calc_SINR_k(self, k: int, Bkl_all_l: np.ndarray) -> np.ndarray:
        Hkk = self._get_channel(k, k)
        Vk = self.full_F[k]
        Uk = self.W[k]
        ns = int(self._Ns[k])
        sinrs = np.empty(ns, dtype=float)
        for l in range(ns):
            Vkl = Vk[:, l:l + 1]
            Ukl = Uk[:, l:l + 1]
            aux = Ukl.conj().T @ Hkk @ Vkl
            num = (aux @ aux.conj().T).item()
            den = (Ukl.conj().T @ Bkl_all_l[l] @ Ukl).item()
            sinrs[l] = np.abs(num / den)
        return sinrs

    def calc_SINR_old(self) -> np.ndarray:
        """Deprecated per-stream SINR from the aggregate equalized powers
        ``diag|W_H H F|^2`` over interference + noise amplification
        (parity: iabase.py:717-766; kept because the reference keeps it —
        use :meth:`calc_SINR` for the correct Bkl-based SINR)."""
        K = self.K
        out = np.empty(K, dtype=np.ndarray)
        for j in range(K):
            Wj_H = self.W_H[j]
            numerator = 0.0
            denominator = 0.0
            for i in range(K):
                aux = Wj_H @ self._get_channel(j, i) @ self.F[i]
                if i == j:
                    numerator = numerator + np.diag(
                        np.abs(aux @ aux.conj().T))
                else:
                    denominator = denominator + aux
            denominator = denominator @ denominator.conj().T
            denominator = denominator + \
                self.noise_var * (Wj_H @ Wj_H.conj().T)
            out[j] = numerator / np.diag(np.abs(denominator))
        return out

    def calc_SINR(self) -> np.ndarray:
        """Per-stream SINRs (linear) of all users."""
        out = np.empty(self.K, dtype=np.ndarray)
        for k in range(self.K):
            Bkl = self._calc_Bkl_cov_matrix_all_l(k, self.noise_var)
            out[k] = self._calc_SINR_k(k, Bkl)
        return out

    def calc_SINR_in_dB(self) -> np.ndarray:
        out = np.empty(self.K, dtype=np.ndarray)
        for k in range(self.K):
            Bkl = self._calc_Bkl_cov_matrix_all_l(k, self.noise_var)
            out[k] = linear2dB(self._calc_SINR_k(k, Bkl))
        return out

    def calc_sum_capacity(self) -> float:
        """``sum log2(1 + SINR)`` over all streams (iabase.py:814-825)."""
        return float(np.sum(np.log2(1.0 + np.hstack(self.calc_SINR()))))

    # -- abstract ----------------------------------------------------------

    def solve(self, Ns, P=None):  # pragma: no cover - abstract
        raise NotImplementedError
