"""Jakes sum-of-sinusoids fading sample generator.

Counterpart of ``JakesState`` / ``JakesSampleGenerator`` of
``pyphysim_tpu/channels/fading_generators.py``. The state is the explicit
``(phi_l, psi_l, t0)``: per-ray arrival angles and phases plus the current
time. Time enters the Jakes closed form analytically, so any block of
samples is generated independently from the state, and ``skip`` only
advances ``t0`` (the block-static channel).

Samples are complex64 tensors of shape ``shape + (num_samples,)`` (sample
axis last). The generator is configuration (Fd, Ts, L, shape, device); the
per-realization randomness lives in the state, drawn from a caller-supplied
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, require_cuda

__all__ = ["JakesSampleGenerator", "JakesState"]

Shape = Union[int, Tuple[int, ...]]


def _normalize_shape(shape: Optional[Shape]) -> Tuple[int, ...]:
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


class JakesState(NamedTuple):
    """State of a Jakes generator: per-ray phases and the current time."""
    phi_l: torch.Tensor   # (L,) + shape + (1,) — ray arrival angles
    psi_l: torch.Tensor   # (L,) + shape + (1,) — ray phases
    t0: torch.Tensor      # scalar — next sample time

    @classmethod
    def from_numpy(cls, phi_l, psi_l, t0,
                   device: DeviceLike = "cpu") -> "JakesState":
        """State from numpy arrays (e.g. a JAX ``JakesState`` passed
        through ``np.asarray``), as float32 tensors on ``device``."""
        dev = require_cuda(device)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return cls(f32(phi_l), f32(psi_l), f32(t0))


class JakesSampleGenerator:
    """Jakes sum-of-sinusoids:
    ``h(t) = sqrt(1/L) sum_l exp(j(2 pi Fd cos(phi_l) t + psi_l))``."""

    def __init__(self, Fd: float = 100.0, Ts: float = 1e-3, L: int = 8,
                 shape: Optional[Shape] = None,
                 device: DeviceLike = "cpu") -> None:
        self._Fd = float(Fd)
        self._Ts = float(Ts)
        self._L = int(L)
        self._shape = _normalize_shape(shape) if shape is not None else None
        self.device = require_cuda(device)

    @property
    def Fd(self) -> float:
        return self._Fd

    @property
    def Ts(self) -> float:
        return self._Ts

    @property
    def L(self) -> int:
        return self._L

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        self._shape = (_normalize_shape(new_shape)
                       if new_shape is not None else None)

    def init_state(self, generator: torch.Generator) -> JakesState:
        """Draw fresh ray angles and phases, uniform in [0, 2 pi), from
        ``generator`` (which must live on ``self.device``)."""
        shape = (self._L,) + (self._shape or ()) + (1,)
        two_pi = 2.0 * np.pi
        phi = torch.rand(shape, generator=generator,
                         device=self.device) * two_pi
        psi = torch.rand(shape, generator=generator,
                         device=self.device) * two_pi
        return JakesState(phi_l=phi, psi_l=psi,
                          t0=torch.zeros((), device=self.device))

    def generate(self, state: JakesState,
                 num_samples: int = 1) -> Tuple[torch.Tensor, JakesState]:
        """``num_samples`` samples from ``state`` and the advanced state."""
        t = state.t0 + torch.arange(num_samples, dtype=state.t0.dtype,
                                    device=state.t0.device) * self._Ts
        w = 2.0 * np.pi * self._Fd * torch.cos(state.phi_l)  # (L, *shape, 1)
        phase = w * t + state.psi_l                          # (L, *shape, N)
        scale = math.sqrt(1.0 / self._L)
        samples = torch.complex(torch.cos(phase).sum(dim=0) * scale,
                                torch.sin(phase).sum(dim=0) * scale)
        return samples, self.skip(state, num_samples)

    def skip(self, state: JakesState, num_samples: int) -> JakesState:
        """Advance the clock without generating samples — the block-static
        channel trick."""
        return JakesState(phi_l=state.phi_l, psi_l=state.psi_l,
                          t0=state.t0 + num_samples * self._Ts)
