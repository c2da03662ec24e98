"""Subspace utilities: projections, principal angles, chordal distances."""

from .projections import (Projection, calcOrthogonalProjectionMatrix,  # noqa: F401
                          calcProjectionMatrix)
from .metrics import (calc_principal_angles,  # noqa: F401
                      calc_chordal_distance_from_principal_angles,
                      calc_chordal_distance, calc_chordal_distance_2)
