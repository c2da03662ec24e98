"""Subspace metrics: principal angles and chordal distances.

Counterpart of ``pyphysim_tpu/subspace/metrics.py``: numpy on the host
(real or complex), complex tensors batched over the leading dims. Numpy
in, a number or numpy out; a tensor in, a tensor out.
"""

from __future__ import annotations

import numpy as np
import torch

from .projections import calcProjectionMatrix

__all__ = [
    "calc_principal_angles", "calc_chordal_distance_from_principal_angles",
    "calc_chordal_distance", "calc_chordal_distance_2"
]


def _is_tensor(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


def calc_principal_angles(matrix1, matrix2):
    """Principal angles between the column spaces of ``matrix1`` and
    ``matrix2``: orthonormalize both (QR); the singular values of
    ``Q1^H Q2`` are the angles' cosines, clipped against rounding before
    the arccos.

    >>> a = calc_principal_angles(np.eye(3)[:, :1], np.eye(3)[:, 1:2])
    >>> round(float(a[0]), 6)
    1.570796
    """
    if _is_tensor(matrix1, matrix2):
        q1 = torch.linalg.qr(torch.as_tensor(matrix1))[0]
        q2 = torch.linalg.qr(torch.as_tensor(matrix2))[0]
        s = torch.linalg.svdvals(q1.mH @ q2)
        return torch.arccos(torch.clamp(s, 0.0, 1.0))
    q1 = np.linalg.qr(np.asarray(matrix1))[0]
    q2 = np.linalg.qr(np.asarray(matrix2))[0]
    s = np.linalg.svd(q1.conj().T @ q2, full_matrices=False)[1]
    return np.arccos(np.clip(s, -1.0, 1.0))


def calc_chordal_distance_from_principal_angles(principalAngles):
    """Chordal distance ``sqrt(sum sin^2(angles))``."""
    if isinstance(principalAngles, torch.Tensor):
        return torch.sqrt((torch.sin(principalAngles) ** 2).sum(dim=-1))
    return float(np.sqrt(np.sum(np.sin(np.asarray(principalAngles)) ** 2)))


def calc_chordal_distance(matrix1, matrix2):
    """Chordal distance from orthonormal bases:
    ``||Q1 Q1^H - Q2 Q2^H||_F / sqrt(2)``.

    >>> A = np.array([[1., 2], [3, 4], [5, 6]])
    >>> B = np.array([[1., 5], [3, 7], [5, -1]])
    >>> round(calc_chordal_distance(A, B), 6)
    0.516811
    """
    if _is_tensor(matrix1, matrix2):
        q1 = torch.linalg.qr(torch.as_tensor(matrix1))[0]
        q2 = torch.linalg.qr(torch.as_tensor(matrix2))[0]
        d = q1 @ q1.mH - q2 @ q2.mH
        return torch.sqrt((d.abs() ** 2).sum(dim=(-2, -1)) / 2.0)
    q1 = np.linalg.qr(np.asarray(matrix1))[0]
    q2 = np.linalg.qr(np.asarray(matrix2))[0]
    d = q1 @ q1.conj().T - q2 @ q2.conj().T
    return float(np.linalg.norm(d, "fro") / np.sqrt(2.0))


def calc_chordal_distance_2(matrix1, matrix2):
    """Chordal distance from projection matrices:
    ``||P1 - P2||_F / sqrt(2)``, the value of :func:`calc_chordal_distance`
    by another construction."""
    p1 = calcProjectionMatrix(matrix1)
    p2 = calcProjectionMatrix(matrix2)
    if _is_tensor(p1, p2):
        d = torch.as_tensor(p1) - torch.as_tensor(p2)
        return torch.sqrt((d.abs() ** 2).sum(dim=(-2, -1)) / 2.0)
    return float(np.linalg.norm(p1 - p2, "fro") / np.sqrt(2.0))
