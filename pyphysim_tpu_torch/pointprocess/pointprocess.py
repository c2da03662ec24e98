"""Uniform random points in an annulus or a rectangle, as complex numbers.

Counterpart of ``pyphysim_tpu/pointprocess/pointprocess.py``. With a numpy
``RandomState`` (or numpy's global state) the points are computed on the
host and equal the JAX package's draw for draw. With a ``torch.Generator``
they are a complex128 tensor on the generator's device, drawn in the same
order: first every radius, then every angle (or every x, then every y).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["generate_random_points_in_circle",
           "generate_random_points_in_rectangle"]


def _uniform(rng, num_points: int):
    """``num_points`` uniforms in [0, 1): float64 from a numpy source, or a
    float64 tensor on a ``torch.Generator``'s device."""
    if isinstance(rng, torch.Generator):
        return torch.rand(num_points, generator=rng, device=rng.device,
                          dtype=torch.float64)
    return (rng or np.random).random_sample(num_points)


def generate_random_points_in_circle(num_points: int, max_radius: float,
                                     min_radius: float = 0.0, rng=None):
    """Points of uniform area density in the annulus [min_radius,
    max_radius] around the origin.

    >>> p = generate_random_points_in_circle(5, 2.0, 1.0,
    ...                                      np.random.RandomState(0))
    >>> bool(np.all((np.abs(p) >= 1.0) & (np.abs(p) <= 2.0)))
    True
    """
    r2 = _uniform(rng, num_points) * (max_radius ** 2 - min_radius ** 2) + \
        min_radius ** 2
    angles = _uniform(rng, num_points) * 2 * math.pi
    if isinstance(r2, torch.Tensor):
        return torch.polar(torch.sqrt(r2), angles)
    return np.sqrt(r2) * np.exp(1j * angles)


def generate_random_points_in_rectangle(num_points: int, width: float,
                                        height: float, rng=None):
    """Points uniform in a ``width`` x ``height`` rectangle centred at the
    origin.

    >>> g = torch.Generator().manual_seed(1)
    >>> p = generate_random_points_in_rectangle(4, 2.0, 1.0, g)
    >>> inside = (p.real.abs() <= 1) & (p.imag.abs() <= 0.5)
    >>> p.dtype, bool(inside.all())
    (torch.complex128, True)
    """
    x = width * (0.5 - _uniform(rng, num_points))
    y = height * (0.5 - _uniform(rng, num_points))
    if isinstance(x, torch.Tensor):
        return torch.complex(x, y)
    return x + 1j * y
