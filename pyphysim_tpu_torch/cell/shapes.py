"""Geometric shapes on the complex plane.

Counterpart of ``pyphysim_tpu/cell/shapes.py`` (a numpy copy: the port
imports nothing of the JAX package): positions are
complex numbers (x + jy); shapes have a position, a radius and a rotation,
expose their vertices, point-inclusion tests, border-point computation and
matplotlib plotting. Host-side numpy (scenario geometry is configuration).
"""

from __future__ import annotations

import cmath
import math
from typing import Any, Optional

import numpy as np

__all__ = ["Coordinate", "Shape", "Hexagon", "Rectangle", "Circle",
           "from_complex_array_to_real_matrix"]


def from_complex_array_to_real_matrix(a: np.ndarray) -> np.ndarray:
    """(N,) complex -> (N, 2) real [x, y] matrix."""
    a = np.asarray(a)
    return np.column_stack([a.real, a.imag])


class Coordinate:
    """A position on the complex plane."""

    def __init__(self, pos: complex, **kwargs: Any) -> None:
        self._pos = complex(pos)
        super().__init__(**kwargs)

    @property
    def pos(self) -> complex:
        return self._pos

    @pos.setter
    def pos(self, value: complex) -> None:
        self._pos = complex(value)

    def calc_dist(self, other: "Coordinate") -> float:
        """Euclidean distance to another coordinate."""
        return abs(self.pos - other.pos)

    def move_by_relative_coordinate(self, rel_pos: complex) -> None:
        self.pos = self.pos + rel_pos

    def move_by_relative_polar_coordinate(self, radius: float,
                                          angle: float) -> None:
        """Move by ``radius`` at ``angle`` (radians)."""
        self.move_by_relative_coordinate(radius * cmath.exp(1j * angle))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.pos})"


class Shape(Coordinate):
    """A closed shape: position + radius + rotation, defined by its
    vertices."""

    def __init__(self, pos: complex, radius: float,
                 rotation: float = 0.0, **kwargs: Any) -> None:
        super().__init__(pos=pos, **kwargs)
        self._radius = float(radius)
        self._rotation = float(rotation)
        self.fill_face_bool = False
        self.fill_color = "r"
        self.fill_opacity = 0.1

    @property
    def radius(self) -> float:
        return self._radius

    @radius.setter
    def radius(self, value: float) -> None:
        self._radius = float(value)

    @property
    def rotation(self) -> float:
        return self._rotation

    @rotation.setter
    def rotation(self, value: float) -> None:
        self._rotation = float(value)

    # -- vertices ----------------------------------------------------------

    def _get_vertex_positions(self) -> np.ndarray:  # pragma: no cover
        """Vertices for radius, WITHOUT translation/rotation."""
        raise NotImplementedError

    @property
    def vertices_no_trans_no_rotation(self) -> np.ndarray:
        return self._get_vertex_positions()

    @property
    def vertices(self) -> np.ndarray:
        """Vertices with rotation and translation applied."""
        verts = self._get_vertex_positions()
        return self.calc_rotated_pos(verts, self._rotation) + self.pos

    @staticmethod
    def calc_rotated_pos(cur_pos, angle: float):
        """Rotate point(s) by ``angle`` degrees around the origin."""
        return cur_pos * cmath.exp(1j * math.pi * angle / 180.0)

    # -- geometry ----------------------------------------------------------

    def is_point_inside_shape(self, point: complex) -> bool:
        """Point-in-polygon test against the shape's vertices, by the
        even-odd rule: a ray from the point to +x crosses the border an
        odd number of times (numpy alone, so that it runs where matplotlib
        is not installed)."""
        v = self.vertices
        xi, yi = v.real, v.imag
        xj, yj = np.roll(xi, 1), np.roll(yi, 1)
        x, y = point.real, point.imag
        with np.errstate(divide="ignore", invalid="ignore"):
            x_cross = xi + (y - yi) * (xj - xi) / (yj - yi)
        crosses = ((yi > y) != (yj > y)) & (x < x_cross)
        return bool(np.count_nonzero(crosses) % 2)

    def get_border_point(self, angle: float,
                         ratio: Optional[float] = None) -> complex:
        """Point on the segment center->border at ``angle`` degrees;
        ``ratio`` in (0, 1] selects how far along the segment."""
        if ratio is None:
            ratio = 1.0
        angle_rad = math.pi * angle / 180.0
        direction = cmath.exp(1j * angle_rad)
        # Find the polygon edge intersected by the ray and intersect
        # analytically.
        verts = self.vertices
        n = len(verts)
        best: Optional[complex] = None
        best_t = math.inf
        for i in range(n):
            a = verts[i] - self.pos
            b = verts[(i + 1) % n] - self.pos
            e = b - a
            denom = direction.real * e.imag - direction.imag * e.real
            if abs(denom) < 1e-15:
                continue
            t = (a.real * e.imag - a.imag * e.real) / denom
            if t <= 0:
                continue
            # cross both sides of t*d = a + s*e with d: s = (a x d)/(d x e)
            s = (a.real * direction.imag - a.imag * direction.real) / denom
            if -1e-9 <= s <= 1 + 1e-9 and t < best_t:
                best_t = t
                best = self.pos + t * direction
        if best is None:  # pragma: no cover - degenerate shape
            best = self.pos + self._radius * direction
        return (1 - ratio) * self.pos + ratio * best

    # -- plotting ----------------------------------------------------------

    def plot(self, ax: Any = None) -> None:  # pragma: no cover
        import matplotlib.pyplot as plt
        stand_alone = ax is None
        if ax is None:
            _, ax = plt.subplots()
            ax.set_aspect("equal")
        verts = np.append(self.vertices, self.vertices[0])
        if self.fill_face_bool:
            ax.fill(verts.real, verts.imag, color=self.fill_color,
                    alpha=self.fill_opacity)
        ax.plot(verts.real, verts.imag, "k")
        if stand_alone:
            plt.show()

    def __repr__(self) -> str:
        return (f"{self.__class__.__name__}(pos={self.pos},"
                f"radius={self._radius},rotation={self._rotation})")


class Hexagon(Shape):
    """Regular hexagon, reference orientation (shapes.py:582-604):
    vertices at -120 + 60k degrees — flat top/bottom edges, vertices on
    the x-axis. Border users placed by angle land on the same edge or
    vertex as in the reference (a 30-degree-rotated hexagon changes
    every geometry-driven scenario's path losses)."""

    @property
    def height(self) -> float:
        """Distance from center to edge middle: ``r * sqrt(3)/2``."""
        return self._radius * math.sqrt(3.0) / 2.0

    def _get_vertex_positions(self) -> np.ndarray:
        angles = -2.0 * math.pi / 3.0 + \
            np.arange(6) * (math.pi / 3.0)
        return self._radius * np.exp(1j * angles)


class Rectangle(Shape):
    """Axis-aligned rectangle defined by two opposite corners."""

    def __init__(self, first: complex, second: complex,
                 rotation: float = 0.0) -> None:
        pos = (first + second) / 2
        self._lower = complex(min(first.real, second.real),
                              min(first.imag, second.imag))
        self._upper = complex(max(first.real, second.real),
                              max(first.imag, second.imag))
        radius = abs(self._upper - pos)
        super().__init__(pos=pos, radius=radius, rotation=rotation)

    @property
    def width(self) -> float:
        return self._upper.real - self._lower.real

    @property
    def height(self) -> float:
        return self._upper.imag - self._lower.imag

    def _get_vertex_positions(self) -> np.ndarray:
        w2, h2 = self.width / 2, self.height / 2
        return np.array([-w2 - 1j * h2, w2 - 1j * h2, w2 + 1j * h2,
                         -w2 + 1j * h2])

    def is_point_inside_shape(self, point: complex) -> bool:
        # fast axis-aligned test (valid when rotation == 0)
        if self._rotation == 0.0:
            return bool(self._lower.real <= point.real <= self._upper.real
                        and self._lower.imag <= point.imag
                        <= self._upper.imag)
        return super().is_point_inside_shape(point)

    def __repr__(self) -> str:
        return (f"Rectangle({self._lower},{self._upper})")


class Circle(Shape):
    """Circle (vertices are a fine polygonal approximation)."""

    def __init__(self, pos: complex, radius: float) -> None:
        super().__init__(pos=pos, radius=radius)

    def _get_vertex_positions(self) -> np.ndarray:
        angles = np.linspace(0, 2 * math.pi, 180, endpoint=False)
        return self._radius * np.exp(1j * angles)

    def get_border_point(self, angle: float,
                         ratio: Optional[float] = None) -> complex:
        if ratio is None:
            ratio = 1.0
        return self.pos + ratio * self._radius * cmath.exp(
            1j * math.pi * angle / 180.0)

    def is_point_inside_shape(self, point: complex) -> bool:
        return abs(point - self.pos) < self._radius
