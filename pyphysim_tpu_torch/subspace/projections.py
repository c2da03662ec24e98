"""Subspace projections.

Counterpart of ``pyphysim_tpu/subspace/projections.py``: numpy arrays on
the host, complex tensors (batched over the leading dims, on their device)
for the batched solvers. Numpy in, numpy out; a tensor in, a tensor out.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Projection", "calcProjectionMatrix",
           "calcOrthogonalProjectionMatrix"]


def _eye_like(Q):
    if isinstance(Q, torch.Tensor):
        return torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
    return np.eye(Q.shape[-1])


def calcProjectionMatrix(A):
    """Projection matrix onto the column space of ``A``:
    ``A (A^H A)^-1 A^H``.

    >>> P = calcProjectionMatrix(np.array([[1.0], [1.0]]))
    >>> P.tolist()
    [[0.5, 0.5], [0.5, 0.5]]
    """
    if isinstance(A, torch.Tensor):
        # solve_ex: no host sync for the error check on the card
        return A @ torch.linalg.solve_ex(A.mH @ A, A.mH)[0]
    A = np.asarray(A)
    A_H = A.conj().T
    return A @ np.linalg.inv(A_H @ A) @ A_H


def calcOrthogonalProjectionMatrix(A):
    """Projection onto the orthogonal complement of the column space of
    ``A``: ``I - calcProjectionMatrix(A)``."""
    Q = calcProjectionMatrix(A)
    return _eye_like(Q) - Q


class Projection:
    """Project, reflect and orthogonally project onto the column space of
    ``A``."""

    def __init__(self, A) -> None:
        self.Q = calcProjectionMatrix(A)
        self.oQ = calcOrthogonalProjectionMatrix(A)

    def project_matrix(self, M):
        return self.Q @ M

    def reflect_matrix(self, M):
        return (_eye_like(self.Q) - 2 * self.Q) @ M

    def project_matrix_onto_orthogonal_space(self, M):
        return self.oQ @ M

    # the reference's names
    project = project_matrix
    reflect = reflect_matrix
    oProject = project_matrix_onto_orthogonal_space

    calcProjectionMatrix = staticmethod(calcProjectionMatrix)
    calcOrthogonalProjectionMatrix = staticmethod(
        calcOrthogonalProjectionMatrix)
