"""Cell topology and geometry: shapes, cells, clusters and grids (numpy,
on the host)."""

from . import cell, shapes  # noqa: F401
from .cell import (AccessPoint, Cell, Cell3Sec, CellBase, CellSquare,  # noqa: F401
                   CellWrap, Cluster, Grid, Node)
from .shapes import Circle, Coordinate, Hexagon, Rectangle, Shape  # noqa: F401
