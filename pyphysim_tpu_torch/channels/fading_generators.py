"""Fading sample generators: iid Rayleigh and Jakes sum-of-sinusoids.

Counterpart of ``RayleighSampleGenerator`` / ``JakesSampleGenerator`` and
their states in ``pyphysim_tpu/channels/fading_generators.py``. The state
is explicit and the generators are configuration (shape, device; Fd, Ts, L
for Jakes):

  * :class:`JakesState` is ``(phi_l, psi_l, t0)``: per-ray arrival angles
    and phases plus the current time. Time enters the Jakes closed form
    analytically, so any block of samples is generated independently from
    the state, and ``skip`` only advances ``t0`` (the block-static channel).
  * :class:`RayleighState` is a Philox key and a counter: each ``generate``
    draws iid CN(0, 1) samples at the current counter and advances it.

Samples are complex64 tensors of shape ``batch + shape + (num_samples,)``
(sample axis last). A state may carry leading batch dimensions (one
realization per row, as the JAX package's ``vmap`` does): ``t0`` and the
Rayleigh counter have the batch shape. ``init_state`` draws from an
explicit random source: a ``torch.Generator`` (no batch) or an
``ops.streams.AttemptStreams`` (one row per attempt), and ``batch`` adds
leading axes of independent states after those (a multiuser channel's
links). :func:`jakes_state_from_numpy` carries the JAX package's Jakes
states over: one link's, or a multiuser channel's stacked link states,
whose layout (links first) is the port's.

Both derive from :class:`FadingSampleGenerator`, which also carries the
reference's stateful host API (``set_seed``, ``generate_more_samples``,
``get_samples``, ``skip_samples_for_next_generation``): an internal state
seeded through a ``torch.Generator`` on the generator's device, samples
returned as numpy. ``generate_jakes_samples`` is the stateless
convenience function.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, require_cuda
from ..ops import streams

__all__ = ["FadingSampleGenerator", "JakesSampleGenerator", "JakesState",
           "RayleighSampleGenerator", "RayleighState",
           "generate_jakes_samples", "jakes_state_from_numpy"]

Shape = Union[int, Tuple[int, ...]]


def _normalize_shape(shape: Optional[Shape]) -> Tuple[int, ...]:
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


class JakesState(NamedTuple):
    """State of a Jakes generator: per-ray phases and the current time."""
    phi_l: torch.Tensor   # batch + (L,) + shape + (1,) — ray angles
    psi_l: torch.Tensor   # batch + (L,) + shape + (1,) — ray phases
    t0: torch.Tensor      # batch — next sample time

    @classmethod
    def from_numpy(cls, phi_l, psi_l, t0,
                   device: DeviceLike = "cuda") -> "JakesState":
        """State from numpy arrays (e.g. a JAX ``JakesState`` passed
        through ``np.asarray``), as float32 tensors on ``device``."""
        dev = require_cuda(device)

        def f32(a):
            return torch.as_tensor(np.array(a, np.float32), device=dev)
        return cls(f32(phi_l), f32(psi_l), f32(t0))


class FadingSampleGenerator:
    """Base of the generators: the sample shape and device, the functional
    API (``init_state`` / ``generate`` / ``skip``, state in and out) that
    the subclasses implement, and the reference's stateful host API on an
    internal state."""

    def __init__(self, shape: Optional[Shape] = None,
                 device: DeviceLike = "cuda") -> None:
        self._shape = _normalize_shape(shape) if shape is not None else None
        self.device = require_cuda(device)
        self._state = None
        self._samples: Optional[np.ndarray] = None
        self._seed: Optional[int] = None

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        self._shape = (_normalize_shape(new_shape)
                       if new_shape is not None else None)

    def init_state(self, source, batch=()):  # pragma: no cover - abstract
        raise NotImplementedError

    def generate(self, state, num_samples: int = 1):  # pragma: no cover
        raise NotImplementedError

    def skip(self, state, num_samples: int):  # pragma: no cover
        raise NotImplementedError

    def get_similar_fading_generator(self):  # pragma: no cover
        raise NotImplementedError

    # -- the stateful host API ---------------------------------------------

    def set_seed(self, seed: int) -> None:
        """(Re)seed the internal state of the stateful API."""
        self._seed = int(seed)
        self._state = self.init_state(
            torch.Generator(device=self.device).manual_seed(self._seed))

    def _ensure_state(self) -> None:
        if self._state is None:
            if self._seed is None:
                # fresh entropy per generator, as the reference's
                # per-object RandomState
                self._seed = int(np.random.randint(0, 2**31 - 1))
            self.set_seed(self._seed)

    def generate_more_samples(
            self, num_samples: Optional[int] = None) -> None:
        """Generate the next samples into :meth:`get_samples`. With
        ``num_samples=None`` one sample of shape ``self.shape``, without
        the trailing sample axis, as the reference."""
        self._ensure_state()
        n = 1 if num_samples is None else int(num_samples)
        samples, self._state = self.generate(self._state, n)
        host = samples.cpu().numpy()
        self._samples = host[..., 0] if num_samples is None else host

    def get_samples(self) -> Optional[np.ndarray]:
        """The samples of the last :meth:`generate_more_samples` call."""
        return self._samples

    def skip_samples_for_next_generation(self, num_samples: int) -> None:
        """Advance the internal state without generating samples."""
        self._ensure_state()
        self._state = self.skip(self._state, num_samples)


class JakesSampleGenerator(FadingSampleGenerator):
    """Jakes sum-of-sinusoids:
    ``h(t) = sqrt(1/L) sum_l exp(j(2 pi Fd cos(phi_l) t + psi_l))``."""

    def __init__(self, Fd: float = 100.0, Ts: float = 1e-3, L: int = 8,
                 shape: Optional[Shape] = None,
                 device: DeviceLike = "cuda") -> None:
        super().__init__(shape, device)
        self._Fd = float(Fd)
        self._Ts = float(Ts)
        self._L = int(L)

    @property
    def Fd(self) -> float:
        return self._Fd

    @property
    def Ts(self) -> float:
        return self._Ts

    @property
    def L(self) -> int:
        return self._L

    def init_state(self, source, batch: Tuple[int, ...] = ()) -> JakesState:
        """Draw fresh ray angles and phases, uniform in [0, 2 pi), from
        an explicit random source on ``self.device``: a
        ``torch.Generator`` gives one state, an ``AttemptStreams`` one
        row per attempt, each with ``batch`` leading axes of independent
        states; ``t0`` starts at 0."""
        shape = (self._L,) + (self._shape or ()) + (1,)
        u = streams.uniform(source, tuple(batch) + (2,) + shape,
                            self.device)
        lead = u.dim() - len(shape) - 1
        phi, psi = (v * (2.0 * np.pi) for v in u.unbind(dim=lead))
        return JakesState(phi_l=phi, psi_l=psi,
                          t0=torch.zeros(u.shape[:lead], device=u.device))

    def generate(self, state: JakesState,
                 num_samples: int = 1) -> Tuple[torch.Tensor, JakesState]:
        """``num_samples`` samples from ``state`` and the advanced state."""
        t0 = state.t0
        ray_axis = t0.dim()
        t = t0.reshape(t0.shape + (1,) * (state.phi_l.dim() - ray_axis)) + \
            torch.arange(num_samples, dtype=t0.dtype,
                         device=t0.device) * self._Ts
        w = 2.0 * np.pi * self._Fd * torch.cos(state.phi_l)
        phase = w * t + state.psi_l               # batch + (L, *shape, N)
        scale = math.sqrt(1.0 / self._L)
        samples = torch.complex(torch.cos(phase).sum(dim=ray_axis) * scale,
                                torch.sin(phase).sum(dim=ray_axis) * scale)
        return samples, self.skip(state, num_samples)

    def skip(self, state: JakesState, num_samples: int) -> JakesState:
        """Advance the clock without generating samples — the block-static
        channel trick."""
        return JakesState(phi_l=state.phi_l, psi_l=state.psi_l,
                          t0=state.t0 + num_samples * self._Ts)

    def get_similar_fading_generator(self) -> "JakesSampleGenerator":
        """A generator of the same configuration and device (its own
        state)."""
        return JakesSampleGenerator(self._Fd, self._Ts, self._L, self._shape,
                                    self.device)


class RayleighState(NamedTuple):
    """State of a Rayleigh generator: a Philox key and a draw counter."""
    key: torch.Tensor      # batch + (2,) int64 words in [0, 2**32)
    counter: torch.Tensor  # batch, int64

    @classmethod
    def from_numpy(cls, key, counter=0,
                   device: DeviceLike = "cuda") -> "RayleighState":
        """State from numpy words, e.g. a JAX ``RayleighState`` passed
        through ``np.asarray``: its uint32 key (batch + (2,)) becomes the
        Philox key, so one JAX state names one port state. The numbers
        drawn are the port's own, not ``jax.random``'s."""
        dev = require_cuda(device)
        k = torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64),
                            device=dev)
        c = torch.as_tensor(np.broadcast_to(np.asarray(counter, np.int64),
                                            k.shape[:-1]).copy(), device=dev)
        return cls(k, c)


class RayleighSampleGenerator(FadingSampleGenerator):
    """iid CN(0, 1) samples (memoryless: ``skip`` only moves the
    counter, so later draws still differ)."""

    def init_state(self, source,
                   batch: Tuple[int, ...] = ()) -> RayleighState:
        """A fresh key drawn from an explicit random source (see
        :meth:`JakesSampleGenerator.init_state`); the counter starts at
        0."""
        key = streams.bits(source, tuple(batch) + (2,), self.device)
        return RayleighState(key, torch.zeros(key.shape[:-1],
                                              dtype=torch.int64,
                                              device=key.device))

    def generate(self, state: RayleighState,
                 num_samples: int = 1) -> Tuple[torch.Tensor, RayleighState]:
        """``batch + shape + (num_samples,)`` CN(0, 1) samples: Philox
        under the row's key at the counter ``(j, 0, counter, 1)``, turned
        into normals by Box-Muller; the counter then advances by one."""
        shape = (self._shape or ()) + (num_samples,)
        m = 2 * math.prod(shape)
        batch = state.counter.shape
        key = state.key.reshape(-1, 2)
        c = state.counter.reshape(-1)
        z = streams.philox_draw("normal", key[:, 0], key[:, 1], (c, 0), 1,
                                m) * np.float32(np.sqrt(0.5))
        samples = torch.complex(z[:, 0::2], z[:, 1::2]).reshape(batch + shape)
        return samples, self.skip(state, num_samples)

    def skip(self, state: RayleighState, num_samples: int) -> RayleighState:
        del num_samples
        return RayleighState(state.key, state.counter + 1)

    def get_similar_fading_generator(self) -> "RayleighSampleGenerator":
        """A generator of the same shape and device (its own state)."""
        return RayleighSampleGenerator(self._shape, self.device)


def generate_jakes_samples(Fd: float, Ts: float = 1e-3,
                           num_samples: int = 100, L: int = 8,
                           shape: Optional[Shape] = None, source=None,
                           device: DeviceLike = "cuda") -> torch.Tensor:
    """``num_samples`` Jakes samples, ``shape + (num_samples,)``, from a
    fresh state: the stateless convenience function of the reference.
    ``source`` is a random source for :meth:`JakesSampleGenerator.
    init_state` (None: a ``torch.Generator`` seeded with 0) or a
    :class:`JakesState` to start from."""
    gen = JakesSampleGenerator(Fd, Ts, L, shape, device)
    if isinstance(source, JakesState):
        state = source
    else:
        if source is None:
            source = torch.Generator(device=gen.device).manual_seed(0)
        state = gen.init_state(source)
    samples, _ = gen.generate(state, num_samples)
    return samples


def jakes_state_from_numpy(state, device: DeviceLike = "cuda") -> JakesState:
    """The port's :class:`JakesState` of a JAX package ``JakesState`` (any
    object with ``phi_l``, ``psi_l`` and ``t0`` that ``np.asarray`` takes),
    or of a sequence of them, stacked along a new leading axis (attempts).

    One link's state is ``(L,) + shape + (1,)`` with a scalar ``t0``; a
    JAX ``MuChannel``'s stacked link states carry the links first,
    ``(links, L) + shape + (1,)`` with ``t0`` of shape ``(links,)``, which
    is the port's layout of links as the last batch axis."""
    if hasattr(state, "phi_l"):
        return JakesState.from_numpy(state.phi_l, state.psi_l, state.t0,
                                     device)
    return JakesState.from_numpy(
        *(np.stack([np.asarray(getattr(s, f)) for s in state])
          for f in ("phi_l", "psi_l", "t0")), device)
