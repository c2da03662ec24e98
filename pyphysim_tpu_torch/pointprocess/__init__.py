"""Random point processes."""

from .pointprocess import (generate_random_points_in_circle,  # noqa: F401
                           generate_random_points_in_rectangle)
