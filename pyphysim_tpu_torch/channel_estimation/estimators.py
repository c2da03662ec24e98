"""LS and MMSE channel estimators (Fodor et al. 2014 formulations).

Counterpart of ``pyphysim_tpu/channel_estimation/estimators.py``,
vectorized over leading realization axes. Two input families:

* numpy complex arrays — the host route (numpy's LAPACK, as the JAX
  package's numpy route);
* complex64 tensors — on their device, batched over the leading axes. The
  small Hermitian Gram matrices are inverted with ``torch.linalg.inv``
  (where the JAX package's device route has ``cplx.hpd_inv``), and every
  matrix product runs with TF32 off (``utils.misc.full_precision``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.misc import full_precision

__all__ = ["compute_ls_estimation", "compute_theoretical_ls_MSE",
           "compute_mmse_estimation", "compute_theoretical_mmse_MSE"]


def _any_tensor(*arrays) -> bool:
    return any(isinstance(a, torch.Tensor) for a in arrays)


def _tensors(*arrays):
    """The arguments as complex64 tensors on the first tensor's device."""
    dev = next(a.device for a in arrays if isinstance(a, torch.Tensor))
    return [torch.as_tensor(a).to(dev, torch.complex64) for a in arrays]


def compute_ls_estimation(Y_p, s):
    """LS channel estimate ``Y s^H (s s^H)^-1``.

    ``Y_p``: (..., Nr, num_pilots); ``s``: (Nt, num_pilots) shared or
    (..., Nt, num_pilots) per realization. Returns (..., Nr, Nt).
    """
    if _any_tensor(Y_p, s):
        return _ls_tensor(*_tensors(Y_p, s))
    sH = np.conj(np.swapaxes(s, -1, -2))
    gram = np.matmul(s, sH)
    return np.matmul(np.matmul(Y_p, sH), np.linalg.inv(gram))


@full_precision
def _ls_tensor(Y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    sH = s.mH
    return (Y @ sH) @ torch.linalg.inv(s @ sH)


def compute_theoretical_ls_MSE(Nr: int, noise_power: float, alpha: float,
                               pilot_power: float,
                               num_pilots: int) -> float:
    """``Nr sigma^2 / (alpha^2 P Np)``."""
    return Nr * noise_power / ((alpha ** 2) * pilot_power * num_pilots)


def compute_mmse_estimation(Y_p, s, noise_power: float, C):
    """MMSE channel estimate for a SIMO channel (Nt must be 1):
    ``inv(sigma^2 I + Np C) C (Y s^H) * Np / (s s^H)``.

    ``Y_p``: (..., Nr, num_pilots); ``s``: (1, num_pilots) or
    (..., 1, num_pilots); ``C``: (Nr, Nr) channel covariance.
    """
    if s.shape[-2] != 1:
        raise AssertionError(
            "compute_mmse_estimation only supports Nt == 1")
    if _any_tensor(Y_p, s, C):
        return _mmse_tensor(*_tensors(Y_p, s, C), noise_power)
    num_pilots = Y_p.shape[-1]
    Nr = Y_p.shape[-2]
    sH = np.conj(np.swapaxes(s, -1, -2))          # (..., Np, 1)
    y_corr = np.matmul(Y_p, sH)                   # (..., Nr, 1)
    pilot_energy = np.matmul(s, sH)[..., 0, 0]    # (...,)
    filt = np.matmul(np.linalg.inv(noise_power * np.eye(Nr) +
                                   num_pilots * C), C)
    est = np.matmul(filt, y_corr)                  # (..., Nr, 1)
    return est * (num_pilots / pilot_energy)[..., None, None] if \
        np.ndim(pilot_energy) else est * (num_pilots / pilot_energy)


@full_precision
def _mmse_tensor(Y: torch.Tensor, s: torch.Tensor, C: torch.Tensor,
                 noise_power: float) -> torch.Tensor:
    num_pilots, Nr = Y.shape[-1], Y.shape[-2]
    sH = s.mH                                      # (..., Np, 1)
    y_corr = Y @ sH                                # (..., Nr, 1)
    # the pilot energy s s^H is real and positive (sum |s_i|^2)
    pilot_energy = (s @ sH).real[..., 0, 0]        # (...,)
    eye = torch.eye(Nr, dtype=C.dtype, device=C.device)
    filt = torch.linalg.inv(eye * noise_power + C * num_pilots) @ C
    return (filt @ y_corr) * (num_pilots / pilot_energy)[..., None, None]


def compute_theoretical_mmse_MSE(Nr: int, noise_power: float, alpha: float,
                                 pilot_power: float, num_pilots: int,
                                 C) -> float:
    """``tr[C inv(I + alpha^2 P Np / sigma^2 C)]`` (``C`` numpy or a
    tensor)."""
    C = np.asarray(C.cpu()) if isinstance(C, torch.Tensor) else C
    return float(np.real(np.trace(C @ np.linalg.inv(
        np.eye(Nr) + alpha ** 2 * pilot_power * num_pilots / noise_power *
        C))))
