"""Per-attempt random streams: the port's counterpart of the JAX per-key
path's ``fold_in(var_key, attempt)`` schedule.

An :class:`AttemptStreams` covers a chunk of absolute attempt indices
``a`` (a 1-D int64 tensor) and draws bits, uniforms, normals and integers
of shape ``(n, ...)``: row ``i`` depends only on ``(seed, salt, a[i])``,
where ``seed`` is ``kernel_stream_seed(base_seed, unpack_index)`` and
``salt`` names the sub-stream. So results do not depend on the chunk size
and a resumed run draws exactly what an uninterrupted one would.

The words are Philox4x32-10 (``ops/philox.py``) under the key
``(seed, salt)`` with the counter ``(j, 0, a_lo, a_hi)`` for the j-th group
of four words of a row. Like a JAX key, a stream gives the same numbers
each time it is drawn from with the same shape: :meth:`AttemptStreams.split`
makes independent sub-streams, as ``jax.random.split`` does. These are not
``jax.random``'s numbers; tests that compare the two packages inject numpy
inputs instead.

:func:`philox_words` is the shared core: per-row keys and counters in,
``(n, m)`` words out. The Rayleigh generator's state uses it too.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import torch

from .philox import philox4x32_10

__all__ = ["AttemptStreams", "philox_words", "words_to_uniform",
           "words_to_normal", "uniform", "normal", "bits"]

_MASK = 0xFFFFFFFF
_TWO_PI = 6.283185307179586
Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def philox_words(k0, k1, c2, c3, m: int) -> torch.Tensor:
    """``(n, m)`` int64 words in [0, 2**32): row ``r`` is Philox4x32-10
    under the key ``(k0[r], k1[r])`` at the counters ``(j, 0, c2[r],
    c3[r])``, ``j = 0 .. ceil(m / 4) - 1``, four words per counter.
    ``k0`` / ``k1`` are ints or (n,) int64 tensors, ``c2`` / ``c3``
    (n,) int64 tensors; all on one device."""
    c2 = c2.reshape(-1, 1)
    c3 = c3.reshape(-1, 1)
    k0, k1 = (k.reshape(-1, 1) if isinstance(k, torch.Tensor) else int(k)
              for k in (k0, k1))
    j = torch.arange((m + 3) // 4, dtype=torch.int64, device=c2.device)
    words = torch.stack(philox4x32_10(j[None, :], 0, c2, c3, k0, k1),
                        dim=-1)                      # (n, m/4, 4)
    return words.reshape(c2.shape[0], -1)[:, :m]


def words_to_uniform(words: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) from the top 24 bits of each word
    (exact in float32)."""
    return (words >> 8).to(torch.float32) * (2.0 ** -24)


def words_to_normal(words: torch.Tensor) -> torch.Tensor:
    """float32 standard normals by Box-Muller, two per pair of words along
    the last axis (whose length must be even)."""
    u = words_to_uniform(words)
    u1 = 1.0 - u[..., 0::2]                   # (0, 1]: log stays finite
    u2 = u[..., 1::2]
    r = torch.sqrt(-2.0 * torch.log(u1))
    ang = _TWO_PI * u2
    return torch.stack([r * torch.cos(ang), r * torch.sin(ang)],
                       dim=-1).reshape(words.shape)


class AttemptStreams:
    """Random streams of a chunk of absolute attempts (see the module
    docstring). ``attempts`` is a 1-D int64 tensor; draws land on its
    device and have the leading dimension ``n = len(attempts)``."""

    def __init__(self, seed: int, attempts: torch.Tensor,
                 salt: int = 0) -> None:
        if attempts.dim() != 1:
            raise ValueError("attempts must be a 1-D tensor")
        self.seed = int(seed) & _MASK
        self.salt = int(salt) & _MASK
        self.attempts = attempts.to(torch.int64)

    @classmethod
    def from_range(cls, seed: int, start: int, n: int,
                   device="cuda") -> "AttemptStreams":
        """The streams of attempts ``[start, start + n)``."""
        return cls(seed, torch.arange(start, start + n, dtype=torch.int64,
                                      device=device))

    @property
    def n(self) -> int:
        return int(self.attempts.shape[0])

    def __getitem__(self, rows: slice) -> "AttemptStreams":
        """The streams of a slice of this chunk's attempts (same salt)."""
        return AttemptStreams(self.seed, self.attempts[rows], self.salt)

    def split(self, num: int) -> List["AttemptStreams"]:
        """``num`` independent sub-streams (the counterpart of
        ``jax.random.split``); the child salts are Philox words of the
        parent's salt, so a tree of splits never repeats a salt."""
        child = philox4x32_10(self.salt, 0x5EED, 0, 0, self.seed, 0x57A17)[0]
        base = int(child)
        return [AttemptStreams(self.seed, self.attempts,
                               (base + 0x9E3779B9 * (i + 1)) & _MASK)
                for i in range(num)]

    def bits(self, shape: Shape) -> torch.Tensor:
        """(n, *shape) int64 words in [0, 2**32)."""
        shape = _shape(shape)
        m = math.prod(shape)
        a = self.attempts
        words = philox_words(self.seed, self.salt, a & _MASK,
                             (a >> 32) & _MASK, m)
        return words.reshape((self.n,) + shape)

    def uniform(self, shape: Shape) -> torch.Tensor:
        """(n, *shape) float32 uniforms in [0, 1)."""
        return words_to_uniform(self.bits(shape))

    def normal(self, shape: Shape) -> torch.Tensor:
        """(n, *shape) float32 standard normals (Box-Muller)."""
        shape = _shape(shape)
        m = math.prod(shape)
        flat = self.bits(m + (m & 1))
        return words_to_normal(flat)[:, :m].reshape((self.n,) + shape)

    def integers(self, high: int, shape: Shape) -> torch.Tensor:
        """(n, *shape) int64 in [0, high), ``high`` a power of two up to
        2**32 (exact: the low bits of uniform words)."""
        if high < 1 or high & (high - 1) or high > 2 ** 32:
            raise ValueError("high must be a power of two <= 2**32")
        return self.bits(shape) & (high - 1)


def _draw(source, shape: Shape, device, kind: str) -> torch.Tensor:
    """``kind`` in {"uniform", "normal", "bits"} from ``source``: an
    :class:`AttemptStreams` gives (n, *shape), a ``torch.Generator`` gives
    ``shape`` on ``device`` (the generator's own device by default)."""
    shape = _shape(shape)
    if isinstance(source, AttemptStreams):
        return getattr(source, kind)(shape)
    if isinstance(source, torch.Generator):
        dev = source.device if device is None else device
        if kind == "uniform":
            return torch.rand(shape, generator=source, device=dev)
        if kind == "normal":
            return torch.randn(shape, generator=source, device=dev)
        return torch.randint(0, 2 ** 32, shape, generator=source,
                             device=dev, dtype=torch.int64)
    raise TypeError("a random source is an AttemptStreams or a "
                    f"torch.Generator, got {type(source).__name__}")


def uniform(source, shape: Shape, device=None) -> torch.Tensor:
    """float32 uniforms in [0, 1) from an explicit source."""
    return _draw(source, shape, device, "uniform")


def normal(source, shape: Shape, device=None) -> torch.Tensor:
    """float32 standard normals from an explicit source."""
    return _draw(source, shape, device, "normal")


def bits(source, shape: Shape, device=None) -> torch.Tensor:
    """int64 words in [0, 2**32) from an explicit source."""
    return _draw(source, shape, device, "bits")
