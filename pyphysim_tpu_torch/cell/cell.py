"""Cells, clusters and grids of cells.

Counterpart of ``pyphysim_tpu/cell/cell.py`` (a numpy copy: the port
imports nothing of the JAX package): nodes and access
points with users, hexagonal / 3-sector / square / wrap-around cells,
clusters of N in {1,2,3,4,7,13,19} cells (N = i^2+ij+j^2 layouts), user
dropping, inter-cell geometry and grids of clusters. Host-side geometry
(pure configuration for path-loss/scheduling studies).
"""

from __future__ import annotations

import cmath
import itertools
import math
from typing import Any, Iterator, List, Optional, Sequence, Union

import numpy as np

from . import shapes

__all__ = ["Node", "AccessPoint", "CellBase", "Cell", "Cell3Sec",
           "CellSquare", "CellWrap", "Cluster", "Grid"]


class Node(shapes.Coordinate):
    """A network node (user) on the complex plane."""

    def __init__(self, pos: complex, plot_marker: str = "*",
                 marker_color: str = "r",
                 cell_id: Optional[Union[str, int]] = None,
                 parent_pos: Optional[complex] = None) -> None:
        super().__init__(pos)
        self.plot_marker = plot_marker
        self.marker_color = marker_color
        self.cell_id = cell_id
        self._relative_pos: Optional[complex] = (
            pos - parent_pos if parent_pos is not None else None)

    @property
    def relative_pos(self) -> Optional[complex]:
        """Position relative to the parent (cell) center."""
        return self._relative_pos

    def set_parent_pos(self, parent_pos: complex) -> None:
        self._relative_pos = self.pos - parent_pos

    def plot_node(self, ax: Optional[Any] = None) -> None:  # pragma: no cover
        import matplotlib.pyplot as plt
        if ax is None:
            _, ax = plt.subplots()
        ax.plot(self.pos.real, self.pos.imag,
                marker=self.plot_marker, color=self.marker_color)


class AccessPoint(Node):
    """A node that serves users."""

    def __init__(self, pos: complex, ap_id: Optional[Union[str,
                                                           int]] = None):
        super().__init__(pos, plot_marker="^", marker_color="b",
                         cell_id=ap_id)
        self._users: List[Node] = []
        self.id = ap_id

    @property
    def num_users(self) -> int:
        return len(self._users)

    @property
    def users(self) -> List[Node]:
        return self._users

    def delete_all_users(self) -> None:
        self._users = []

    def add_user(self, new_user: Node) -> None:
        new_user.cell_id = self.id
        new_user.set_parent_pos(self.pos)
        self._users.append(new_user)

    def plot(self, ax: Optional[Any] = None) -> None:  # pragma: no cover
        """Plot the access point marker, its id and its users
        (reference cell.py:292-311)."""
        import matplotlib.pyplot as plt
        stand_alone = ax is None
        if ax is None:
            _, ax = plt.subplots()
        self.plot_node(ax)
        if self.id is not None:
            ax.text(np.real(self.pos), np.imag(self.pos), str(self.id),
                    ha="center", va="center")
        for user in self._users:
            user.plot_node(ax)
        if stand_alone:
            plt.draw()

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(pos={self.pos},ap_id={self.id})"


class CellBase(shapes.Shape, AccessPoint):
    """Base class of all cell types: a shape that serves users."""

    def __init__(self, pos: complex, radius: float,
                 cell_id: Optional[Union[str, int]] = None,
                 rotation: float = 0.0) -> None:
        shapes.Shape.__init__(self, pos=pos, radius=radius,
                              rotation=rotation)
        self._users = []
        self.id = cell_id
        self.id_fontsize: Optional[int] = None  # None -> matplotlib default
        self.plot_marker = "^"
        self.marker_color = "b"
        self._relative_pos = None

    def __repr__(self) -> str:
        return (f"{self.__class__.__name__}(pos={self.pos},"
                f"radius={self.radius},cell_id={self.id})")

    # -- users -------------------------------------------------------------

    def add_user(self, new_user: Node,
                 relative_pos_bool: bool = True) -> None:
        """Add a user; its position is interpreted relative to the cell
        center when ``relative_pos_bool`` (parity: cell.py:363-402).
        Raises ValueError if the user falls outside the cell."""
        if relative_pos_bool:
            new_user.pos = new_user.pos * self.radius + self.pos
        if not self.is_point_inside_shape(new_user.pos):
            raise ValueError("User position is outside the cell -> "
                             "User not added")
        new_user.cell_id = self.id
        new_user.set_parent_pos(self.pos)
        self._users.append(new_user)

    def add_border_user(self, angles, ratio: Optional[float] = None,
                        user_color: Optional[str] = None) -> None:
        """Add users at the cell border at the given angle(s)
        (cell.py:403-464)."""
        angles = np.atleast_1d(angles)
        for angle in angles:
            ratio_v = self._validate_ratio(ratio if ratio is not None
                                           else 1.0)
            pos = self.get_border_point(float(angle), ratio_v)
            user = Node(pos)
            if user_color is not None:
                user.marker_color = user_color
            self.add_user(user, relative_pos_bool=False)

    def add_random_user(self, user_color: Optional[str] = None,
                        min_dist_ratio: float = 0.0) -> None:
        """Add one uniformly dropped user, at least ``min_dist_ratio`` of
        the radius away from the center (cell.py:465-508)."""
        while True:
            pos = (self.pos +
                   complex(2 * (np.random.rand() - 0.5),
                           2 * (np.random.rand() - 0.5)) * self.radius)
            if not self.is_point_inside_shape(pos):
                continue
            if abs(pos - self.pos) < min_dist_ratio * self.radius:
                continue
            break
        user = Node(pos)
        if user_color is not None:
            user.marker_color = user_color
        self.add_user(user, relative_pos_bool=False)

    def add_random_users(self, num_users: int,
                         user_color: Optional[str] = None,
                         min_dist_ratio: float = 0.0) -> None:
        for _ in range(num_users):
            self.add_random_user(user_color, min_dist_ratio)

    @staticmethod
    def _validate_ratio(ratio: float) -> float:
        if not 0 < ratio <= 1:
            raise ValueError("ratio must be between 0 and 1")
        return ratio

    def plot_border(self, ax: Optional[Any] = None) -> None:  # pragma: no cover
        self.plot(ax)

    def plot(self, ax: Optional[Any] = None) -> None:  # pragma: no cover
        import matplotlib.pyplot as plt
        stand_alone = ax is None
        if ax is None:
            _, ax = plt.subplots()
            ax.set_aspect("equal")
        shapes.Shape.plot(self, ax)
        if self.id is not None:
            ax.text(np.real(self.pos), np.imag(self.pos), str(self.id),
                    ha="center", va="center", fontsize=self.id_fontsize)
        for user in self._users:
            user.plot_node(ax)
        if stand_alone:
            plt.show()


class Cell(shapes.Hexagon, CellBase):
    """Hexagonal cell."""

    def __init__(self, pos: complex, radius: float,
                 cell_id: Optional[Union[str, int]] = None,
                 rotation: float = 0.0) -> None:
        CellBase.__init__(self, pos, radius, cell_id, rotation)


class CellSquare(shapes.Rectangle, CellBase):
    """Square cell."""

    def __init__(self, pos: complex, side_length: float,
                 cell_id: Optional[Union[str, int]] = None,
                 rotation: float = 0.0) -> None:
        half = side_length / 2.0
        shapes.Rectangle.__init__(self,
                                  pos - half - 1j * half,
                                  pos + half + 1j * half, rotation)
        self._users = []
        self.id = cell_id
        self.plot_marker = "^"
        self.marker_color = "b"
        self._relative_pos = None

    def add_user(self, new_user: Node,
                 relative_pos_bool: bool = True) -> None:
        if relative_pos_bool:
            new_user.pos = new_user.pos * self.width / 2 + self.pos
        if not self.is_point_inside_shape(new_user.pos):
            raise ValueError("User position is outside the cell -> "
                             "User not added")
        new_user.cell_id = self.id
        new_user.set_parent_pos(self.pos)
        self._users.append(new_user)


class Cell3Sec(CellBase):
    """Cell composed of 3 hexagonal sectors (cell.py:659-1005)."""

    def __init__(self, pos: complex, radius: float,
                 cell_id: Optional[Union[str, int]] = None,
                 rotation: float = 0.0) -> None:
        super().__init__(pos, radius, cell_id, rotation)
        self._update_sectors()

    def _update_sectors(self) -> None:
        sec_pos = self._calc_sectors_positions()
        self._sectors = [
            Cell(sec_pos[i], self.secradius, cell_id=None,
                 rotation=self.rotation - 30) for i in range(3)]

    def _calc_sectors_positions(self) -> np.ndarray:
        secradius = self.secradius
        h = secradius * math.sqrt(3) / 2.0
        positions = np.array([-h - 0.5j * secradius,
                              h - 0.5j * secradius,
                              1j * secradius])
        positions = shapes.Shape.calc_rotated_pos(positions, self.rotation)
        return positions + self.pos

    @property
    def secradius(self) -> float:
        """Radius of one sector: ``sqrt(3) r / 3``."""
        return math.sqrt(3) * self.radius / 3.0

    @shapes.Shape.radius.setter
    def radius(self, value: float) -> None:
        self._radius = float(value)
        self._update_sectors()

    @shapes.Shape.rotation.setter
    def rotation(self, value: float) -> None:
        self._rotation = float(value)
        self._update_sectors()

    @property
    def pos(self) -> complex:
        return self._pos

    @pos.setter
    def pos(self, value: complex) -> None:
        self._pos = complex(value)
        self._update_sectors()

    def _get_vertex_positions(self) -> np.ndarray:
        """Outer outline of the three sectors (12 vertices)."""
        secradius = self.secradius
        h = secradius * math.sqrt(3) / 2.0
        offsets = [-h - 0.5j * secradius, h - 0.5j * secradius,
                   1j * secradius]
        all_verts = []
        for off in offsets:
            hexagon = shapes.Hexagon(off, secradius, rotation=30)
            all_verts.extend(hexagon.vertices)
        # keep only the outline: vertices at maximum distance per angle
        verts = np.array(all_verts)
        keep = []
        for v in verts:
            d = np.abs(verts - v)
            # drop interior duplicates (vertices shared by 2+ sectors)
            if np.sum(d < 1e-9 * max(abs(v), 1)) == 1:
                keep.append(v)
        keep = np.array(keep) if keep else verts
        order = np.argsort(np.angle(keep))
        return keep[order]

    def add_random_user_in_sector(self, sector_idx: int,
                                  user_color: Optional[str] = None,
                                  min_dist_ratio: float = 0.0) -> None:
        """Drop a user uniformly in one sector (cell.py:884-938)."""
        sector = self._sectors[sector_idx]
        sector.delete_all_users()
        sector.add_random_user(user_color, min_dist_ratio)
        user = sector.users[0]
        user.cell_id = self.id
        user.set_parent_pos(self.pos)
        self._users.append(user)
        sector.delete_all_users()

    def add_random_users_in_sector(self, num_users: int, sector_idx: int,
                                   user_color: Optional[str] = None,
                                   min_dist_ratio: float = 0.0) -> None:
        for _ in range(num_users):
            self.add_random_user_in_sector(sector_idx, user_color,
                                           min_dist_ratio)


class CellWrap(CellBase):
    """Positional wrap-around copy of another cell (cell.py:1104-1286)."""

    def __init__(self, pos: complex, wrapped_cell: CellBase,
                 include_users_bool: bool = False) -> None:
        if not isinstance(wrapped_cell, CellBase):
            raise TypeError(
                "wrapped_cell must be a subclass of CellBase")
        self._wrapped_cell = wrapped_cell
        self.include_users_bool = include_users_bool
        wrapped_id = (f"wrap{wrapped_cell.id}"
                      if wrapped_cell.id is not None else None)
        super().__init__(pos, wrapped_cell.radius, wrapped_id,
                         wrapped_cell.rotation)

    @property
    def radius(self) -> float:
        return self._wrapped_cell.radius

    @property
    def rotation(self) -> float:
        return self._wrapped_cell.rotation

    @property
    def num_users(self) -> int:
        if self.include_users_bool:
            return self._wrapped_cell.num_users
        return 0

    @property
    def users(self) -> List[Node]:
        if not self.include_users_bool:
            return []
        # users at positions relative to THIS position
        out = []
        for u in self._wrapped_cell.users:
            if u.relative_pos is not None:
                out.append(Node(self.pos + u.relative_pos,
                                cell_id=self.id))
        return out

    def _get_vertex_positions(self) -> np.ndarray:
        return self._wrapped_cell._get_vertex_positions()

    def __repr__(self) -> str:
        return f"CellWrap(pos={self.pos},cell_id={self.id})"


class Cluster(shapes.Shape):
    """A cluster of cells (cell.py:1288-2558)."""

    _ii_and_jj = {1: (1, 0), 3: (1, 1), 4: (2, 0), 7: (2, 1),
                  13: (3, 1), 19: (3, 2)}
    _normalized_cell_positions: dict = {}

    def __init__(self, cell_radius: float, num_cells: int,
                 pos: complex = 0j, cluster_id: Optional[int] = None,
                 cell_type: str = "simple", rotation: float = 0.0) -> None:
        super().__init__(pos=pos,
                         radius=self._calc_cluster_radius(num_cells,
                                                          cell_radius),
                         rotation=rotation)
        self.cluster_id = cluster_id
        self._cell_radius = float(cell_radius)
        self._cell_type = cell_type
        self._cell_id_fontsize: Optional[int] = None
        self._cells: List[CellBase] = []
        self._wrapped_cells: List[CellWrap] = []

        positions = self._calc_cell_positions(cell_radius, num_cells,
                                              cell_type, rotation)
        for index in range(num_cells):
            cell_pos = positions[index, 0] + pos
            cell_rot = float(np.real(positions[index, 1]))
            if cell_type == "simple":
                self._cells.append(Cell(cell_pos, cell_radius, index + 1,
                                        cell_rot))
            elif cell_type == "3sec":
                self._cells.append(Cell3Sec(cell_pos, cell_radius,
                                            index + 1, cell_rot))
            elif cell_type == "square":
                self._cells.append(CellSquare(cell_pos, cell_radius,
                                              index + 1, cell_rot))
            else:
                raise RuntimeError(f"Invalid cell type: '{cell_type}'")
        self._external_radius = self._calc_cluster_external_radius()

    @property
    def cell_id_fontsize(self) -> Optional[int]:
        """Font size for cell IDs when plotting the cluster; propagated to
        every cell (parity: cell.py:1504-1534)."""
        return self._cell_id_fontsize

    @cell_id_fontsize.setter
    def cell_id_fontsize(self, value: Optional[int] = None) -> None:
        self._cell_id_fontsize = value
        for cell in self._cells:
            cell.id_fontsize = value

    # -- geometry helpers --------------------------------------------------

    @staticmethod
    def _calc_cell_height(radius: float) -> float:
        return radius * math.sqrt(3.0) / 2.0

    @staticmethod
    def _get_ii_and_jj(num_cells: int):
        return Cluster._ii_and_jj.get(num_cells, (0, 0))

    @staticmethod
    def _calc_cell_positions(cell_radius: float, num_cells: int,
                             cell_type: str = "simple",
                             rotation: Optional[float] = None) -> np.ndarray:
        if cell_type in ("simple", "3sec"):
            out = Cluster._calc_cell_positions_hexagon(cell_radius,
                                                       num_cells, rotation)
        elif cell_type == "square":
            out = Cluster._calc_cell_positions_square(cell_radius,
                                                      num_cells, rotation)
        else:
            raise RuntimeError(f"Invalid cell type: '{cell_type}'")
        central = np.sum(out[:, 0]) / num_cells
        out[:, 0] = out[:, 0] - central
        return out

    @staticmethod
    def _calc_cell_positions_hexagon(
            cell_radius: float, num_cells: int,
            rotation: Optional[float] = None) -> np.ndarray:
        """Center cell + first ring at distance 2h + outer ring pattern
        (cell.py:1786-1882)."""
        key = num_cells
        if key not in Cluster._normalized_cell_positions:
            norm = np.zeros((num_cells, 2), dtype=complex)
            h = Cluster._calc_cell_height(1.0)
            angles_first_ring = np.linspace(np.pi / 6, 11 * np.pi / 6, 6)
            for index in range(1, min(num_cells, 7)):
                norm[index, 0] = cmath.rect(2 * h,
                                            angles_first_ring[index - 1])
            angles = np.linspace(0, 11 * np.pi / 6, 12)
            dists = itertools.cycle([3.0, 4 * h])
            for index, a, d in zip(range(7, num_cells), angles, dists):
                norm[index, 0] = cmath.rect(d, a)
            Cluster._normalized_cell_positions[key] = norm
        out = Cluster._normalized_cell_positions[key] * cell_radius
        if rotation is not None:
            out = out.copy()
            out[:, 0] = shapes.Shape.calc_rotated_pos(out[:, 0], rotation)
            out[:, 1] = rotation
        return out.copy()

    @staticmethod
    def _calc_cell_positions_square(
            side_length: float, num_cells: int,
            rotation: Optional[float] = None) -> np.ndarray:
        """Row-major square packing (cell.py:1883-1933)."""
        out = np.zeros((num_cells, 2), dtype=complex)
        sqrt_n = int(math.ceil(math.sqrt(num_cells)))
        for index in range(num_cells):
            row, col = divmod(index, sqrt_n)
            out[index, 0] = col * side_length - 1j * row * side_length
        if rotation is not None:
            out[:, 0] = shapes.Shape.calc_rotated_pos(out[:, 0], rotation)
            out[:, 1] = rotation
        return out

    @staticmethod
    def _calc_cluster_radius(num_cells: int, cell_radius: float) -> float:
        h = Cluster._calc_cell_height(cell_radius)
        ii, jj = Cluster._get_ii_and_jj(num_cells)
        if (ii, jj) == (0, 0):
            # not a standard size; use an enclosing estimate
            return cell_radius * (1 + math.sqrt(num_cells))
        other = h * (jj * 0.5 + 1j * jj * math.sqrt(3) / 2) + h * ii
        return abs(other)

    def _calc_cluster_external_radius(self) -> float:
        positions = np.array([c.pos for c in self._cells])
        return float(np.max(np.abs(positions - self.pos)) +
                     self._cell_radius)

    def _get_vertex_positions(self) -> np.ndarray:
        """Union outline: all cell vertices on the convex-ish border."""
        all_verts = np.concatenate([c.vertices for c in self._cells])
        rel = all_verts - self.pos
        # keep the outermost vertex in each angular bin
        angles = np.round(np.angle(rel), 6)
        keep = {}
        for a, v in zip(angles, rel):
            if a not in keep or abs(v) > abs(keep[a]):
                keep[a] = v
        out = np.array([keep[a] for a in sorted(keep)])
        # only outer boundary: drop clearly interior vertices
        max_r = np.abs(out).max()
        out = out[np.abs(out) > 0.5 * max_r]
        return out

    # -- properties --------------------------------------------------------

    @property
    def num_cells(self) -> int:
        return len(self._cells)

    @property
    def num_users(self) -> int:
        return sum(c.num_users for c in self._cells)

    @property
    def cell_radius(self) -> float:
        return self._cell_radius

    @property
    def cell_height(self) -> float:
        return self._calc_cell_height(self._cell_radius)

    @property
    def external_radius(self) -> float:
        return self._external_radius

    def __iter__(self) -> Iterator[CellBase]:
        return iter(self._cells)

    def get_cell_by_id(self, cell_id: int) -> CellBase:
        return self._cells[cell_id - 1]

    def get_all_users(self) -> List[Node]:
        users: List[Node] = []
        for cell in self._cells:
            users.extend(cell.users)
        return users

    # -- user management ---------------------------------------------------

    def add_random_users(self, cell_ids=None,
                         num_users: Union[int, Sequence[int]] = 1,
                         user_color=None, min_dist_ratio: float = 0.0
                         ) -> None:
        """Drop users in the given cells (all cells when None)
        (cell.py:2186-2244)."""
        if cell_ids is None:
            cell_ids = range(1, self.num_cells + 1)
        if isinstance(num_users, int):
            num_users = [num_users] * len(list(cell_ids))
            cell_ids = range(1, self.num_cells + 1) if cell_ids is None \
                else cell_ids
        for cid, n in zip(cell_ids, num_users):
            self.get_cell_by_id(cid).add_random_users(n, user_color,
                                                      min_dist_ratio)

    def add_border_users(self, cell_ids, angles,
                         ratios: Union[float, Sequence[float]] = 1.0,
                         user_color=None) -> None:
        """Add border users to the given cells (cell.py:2245-2320).

        With a scalar ``cell_ids``, ``angles`` may be one angle or a list
        of angles for that cell. With an iterable ``cell_ids``, the other
        arguments pair up with the cells (scalars are repeated for every
        cell), matching the reference: ``([1, 2, 3], [90, 150, 190], 0.9)``
        adds ONE user per cell at the paired angle, and a per-cell entry
        may itself be a list of angles.
        """
        if np.isscalar(cell_ids):
            self.get_cell_by_id(int(cell_ids)).add_border_user(
                angles, ratios, user_color)
            return
        cell_ids = list(np.atleast_1d(cell_ids))
        n = len(cell_ids)

        def per_cell(value):
            if np.isscalar(value) or value is None:
                return [value] * n
            return list(value)

        for cid, angle, ratio, color in zip(cell_ids, per_cell(angles),
                                            per_cell(ratios),
                                            per_cell(user_color)):
            self.get_cell_by_id(int(cid)).add_border_user(angle, ratio,
                                                          color)

    def delete_all_users(self, cell_id=None) -> None:
        if cell_id is None:
            for cell in self._cells:
                cell.delete_all_users()
        else:
            for cid in np.atleast_1d(cell_id):
                self.get_cell_by_id(int(cid)).delete_all_users()

    # -- wrap-around -------------------------------------------------------

    def create_wrap_around_cells(self,
                                 include_users_bool: bool = False) -> None:
        """Create the 6 wrap-around copies of each cell around the
        cluster (cell.py:2347-2433)."""
        self._wrapped_cells = []
        two_r = 2 * self.radius
        angles = np.linspace(0, 5 * np.pi / 3, 6) + np.pi / 6
        for angle in angles:
            center = self.pos + cmath.rect(two_r, angle)
            for cell in self._cells:
                pos = center + (cell.pos - self.pos)
                self._wrapped_cells.append(
                    CellWrap(pos, cell, include_users_bool))

    # -- distances ---------------------------------------------------------

    def calc_dists_between_cells(self) -> np.ndarray:
        """(num_cells, num_cells) matrix of inter-cell distances."""
        n = self.num_cells
        out = np.zeros((n, n))
        for i, ci in enumerate(self._cells):
            for j, cj in enumerate(self._cells):
                out[i, j] = abs(ci.pos - cj.pos)
        return out

    def calc_dist_all_users_to_each_cell_no_wrap_around(self) -> np.ndarray:
        """(num_users, num_cells) distances, ignoring wrap-around."""
        users = self.get_all_users()
        out = np.zeros((len(users), self.num_cells))
        for u_idx, user in enumerate(users):
            for c_idx, cell in enumerate(self._cells):
                out[u_idx, c_idx] = abs(user.pos - cell.pos)
        return out

    def calc_dist_all_users_to_each_cell(self) -> np.ndarray:
        """Distances accounting for wrap-around copies (minimum over the
        original and wrapped positions)."""
        dists = self.calc_dist_all_users_to_each_cell_no_wrap_around()
        if not self._wrapped_cells:
            return dists
        users = self.get_all_users()
        for wrap in self._wrapped_cells:
            orig = wrap._wrapped_cell
            c_idx = self._cells.index(orig)
            for u_idx, user in enumerate(users):
                d = abs(user.pos - wrap.pos)
                if d < dists[u_idx, c_idx]:
                    dists[u_idx, c_idx] = d
        return dists

    def plot(self, ax: Optional[Any] = None) -> None:  # pragma: no cover
        import matplotlib.pyplot as plt
        stand_alone = ax is None
        if ax is None:
            _, ax = plt.subplots()
            ax.set_aspect("equal")
        for cell in self._cells:
            cell.plot(ax)
        for wrap in self._wrapped_cells:
            wrap.plot(ax)
        if stand_alone:
            plt.show()

    def plot_border(self, ax: Optional[Any] = None) -> None:  # pragma: no cover
        """Plot only the outer border polygon of the Cluster
        (reference cell.py:2150-2183; needs a computable outline,
        i.e. cluster sizes 1, 7, 19...)."""
        verts = self.vertices
        if len(verts) == 0:
            return
        import matplotlib.pyplot as plt
        from matplotlib import patches
        stand_alone = ax is None
        if ax is None:
            _, ax = plt.subplots()
            ax.set_aspect("equal")
        polygon = patches.Polygon(
            np.column_stack([verts.real, verts.imag]),
            closed=True, facecolor="none", alpha=1, linewidth=2)
        ax.add_patch(polygon)
        if stand_alone:
            ax.autoscale_view()
            plt.show()
        else:
            ax.autoscale_view(False, True, True)

    def __repr__(self) -> str:
        return (f"Cluster(cell_radius={self._cell_radius},"
                f"num_cells={self.num_cells},pos={self.pos},"
                f"cluster_id={self.cluster_id})")


class Grid:
    """A grid of clusters (cell.py:2560-2810). Valid cluster sizes for
    grid layout: 1, 2, 3 and 7 cells."""

    def __init__(self) -> None:
        self._clusters: List[Cluster] = []
        self._cell_radius = 0.0
        self._num_cells = 0

    @property
    def num_clusters(self) -> int:
        return len(self._clusters)

    def get_cluster_from_index(self, index: int) -> Cluster:
        return self._clusters[index]

    def __iter__(self) -> Iterator[Cluster]:
        return iter(self._clusters)

    def clear(self) -> None:
        self._clusters = []
        self._cell_radius = 0.0
        self._num_cells = 0

    def create_clusters(self, num_clusters: int, num_cells: int,
                        cell_radius: float) -> None:
        self.clear()
        if num_cells not in (1, 2, 3, 7):
            raise ValueError(
                "The Grid class only supports clusters with 1, 2, 3 or "
                "7 cells")
        self._cell_radius = cell_radius
        self._num_cells = num_cells
        pos_calc = {1: self._calc_cluster_pos1,
                    2: self._calc_cluster_pos2,
                    3: self._calc_cluster_pos3,
                    7: self._calc_cluster_pos7}[num_cells]
        for _ in range(num_clusters):
            pos = pos_calc()
            self._clusters.append(
                Cluster(cell_radius, num_cells, pos,
                        cluster_id=self.num_clusters + 1))

    def _calc_cluster_pos1(self) -> complex:
        idx = self.num_clusters + 1
        if idx == 1:
            return 0j
        angle = (idx - 2) * np.pi / 3
        return 2 * Cluster._calc_cell_height(self._cell_radius) * \
            cmath.exp(1j * angle)

    def _calc_cluster_pos2(self) -> complex:
        idx = self.num_clusters + 1
        if idx == 1:
            return 0j
        if idx == 2:
            return math.sqrt(3) * self._cell_radius * cmath.exp(
                1j * np.pi / 3)
        raise ValueError("For the two cells per cluster case only two "
                         "clusters may be used")

    def _calc_cluster_pos3(self) -> complex:
        idx = self.num_clusters + 1
        if idx == 1:
            return 0j
        if idx > 7:
            raise ValueError("For the three cells per cluster case at "
                             "most 7 clusters may be used")
        angle = (np.pi / 3) * (idx - 1) - np.pi / 6
        return 3 * self._cell_radius * cmath.exp(1j * angle)

    def _calc_cluster_pos7(self) -> complex:
        idx = self.num_clusters + 1
        if idx == 1:
            return 0j
        if idx > 7:
            raise ValueError("For the seven cells per cluster case at "
                             "most 7 clusters may be used")
        h = Cluster._calc_cell_height(self._cell_radius)
        angle = math.atan(math.sqrt(3) / 5)
        length = math.sqrt(21) * self._cell_radius
        angle += (np.pi / 3) * (idx - 2)
        return length * cmath.exp(1j * angle)

    def plot(self, ax: Optional[Any] = None) -> None:  # pragma: no cover
        import matplotlib.pyplot as plt
        stand_alone = ax is None
        if ax is None:
            _, ax = plt.subplots()
            ax.set_aspect("equal")
        for cluster in self._clusters:
            cluster.plot(ax)
        if stand_alone:
            plt.show()
