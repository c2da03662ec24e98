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
of four words of a row. The seed and the salt are host ints, or each a
one-element int64 tensor on the attempts' device that the draw reads
there (so a captured CUDA graph of draws takes a new key by a write to
that tensor). Like a JAX key, a stream gives the same numbers
each time it is drawn from with the same shape: :meth:`AttemptStreams.split`
makes independent sub-streams, as ``jax.random.split`` does. These are not
``jax.random``'s numbers; tests that compare the two packages inject numpy
inputs instead.

:func:`philox_draw` is the shared core: per-row keys and counters in,
``(n, m)`` words, uniforms or normals out (:func:`philox_words` is its
words); the Rayleigh generator's state uses it too. On CUDA tensors it is
one launch of the kernel ``ops/csrc/philox_fill.cu``, on CPU tensors the
plain version :func:`philox_draw_reference` (Philox in torch int64 ops,
~300 small kernels a draw), whose bits the kernel reproduces. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from .philox import philox4x32_10, philox4x32_10_int

__all__ = ["AttemptStreams", "philox_words", "philox_draw",
           "philox_draw_reference", "pack_words", "packed_values",
           "words_to_uniform", "words_to_normal", "uniform", "normal",
           "bits", "child_salts"]

_MASK = 0xFFFFFFFF
_TWO_PI = 6.283185307179586
_KINDS = ("bits", "uniform", "normal")
Shape = Union[int, Sequence[int]]
# a key or counter word: an int (every row), an (n,) int64 tensor of words
# in [0, 2**32), or (tensor, shift): the low 32 bits of ``tensor >> shift``
WordArg = Union[int, torch.Tensor, Tuple[torch.Tensor, int]]
Packed = Tuple[Optional[torch.Tensor], int, int, int]
# a stream's seed or salt: an int, or a one-element int64 device tensor
KeyWord = Union[int, torch.Tensor]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def philox_words(k0: WordArg, k1: WordArg, c2: WordArg, c3: WordArg,
                 m: int) -> torch.Tensor:
    """``(n, m)`` int64 words in [0, 2**32): row ``r`` is Philox4x32-10
    under the key ``(k0[r], k1[r])`` at the counters ``(j, 0, c2[r],
    c3[r])``, ``j = 0 .. ceil(m / 4) - 1``, four words per counter.
    Each word is an int or an (n,) int64 tensor (or a ``(tensor, shift)``
    pair, see :func:`pack_words`), all tensors on one device; ``c2`` or
    ``c3`` is a tensor."""
    return philox_draw("bits", k0, k1, c2, c3, m)


def pack_words(k0: WordArg, k1: WordArg, c2: WordArg, c3: WordArg
               ) -> Tuple[int, torch.device, List[Packed]]:
    """The four key and counter words as the fill kernel reads them:
    ``(n, device, [(column or None, stride, shift, value)] * 4)``. An int
    is the ``value`` of every row; a tensor ``t`` or a pair ``(t, shift)``
    is read at ``t[r * stride] >> shift``, its low 32 bits (so a chunk of
    64-bit attempts ``a`` gives its low and high words as ``(a, 0)`` and
    ``(a, 32)``, with nothing computed on the host)."""
    packed, n, dev = [], None, None
    for w in (k0, k1, c2, c3):
        t, shift = w if isinstance(w, tuple) else (w, 0)
        if not isinstance(t, torch.Tensor):
            packed.append((None, 0, 0, int(t) & _MASK))
            continue
        t = t.reshape(-1) if t.dim() != 1 else t
        if t.dtype != torch.int64:
            t = t.to(torch.int64)
        if n is None:
            n, dev = t.shape[0], t.device
        elif t.shape[0] != n or t.device != dev:
            raise ValueError("the key and counter columns must have one "
                             "length and one device")
        if not 0 <= int(shift) < 64:
            raise ValueError(f"shift {shift} outside [0, 64)")
        packed.append((t, t.stride(0), int(shift), 0))
    if n is None:
        raise ValueError("at least one key or counter word must be a "
                         "tensor")
    return n, dev, packed


def packed_values(packed: Sequence[Packed]) -> List[Union[int, torch.Tensor]]:
    """The words a packing names, in torch: what the kernel reads for each
    row (a tensor column as ``(t >> shift) & 0xFFFFFFFF``, an int as
    itself). The plain version draws from these."""
    return [value if t is None else (t >> shift) & _MASK
            for t, _, shift, value in packed]


def philox_draw(kind: str, k0: WordArg, k1: WordArg, c2: WordArg,
                c3: WordArg, m: int, mask: int = _MASK) -> torch.Tensor:
    """``(n, m)`` draws from the Philox words of :func:`philox_words`:
    ``kind`` "bits" gives the words AND ``mask`` (int64), "uniform"
    float32 uniforms in [0, 1) (:func:`words_to_uniform`), "normal"
    float32 standard normals (:func:`words_to_normal` of ``m`` rounded up
    to even words, the first ``m`` kept). One launch of the fill kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    n, dev, packed = pack_words(k0, k1, c2, c3)
    if dev.type == "cuda":
        out, launch = _fill_launcher(kind, n, dev, packed, int(m), mask)
        if out.numel():
            launch()
        return out
    if dev.type == "cpu":
        return _draw_plain(kind, packed, int(m), mask)
    raise RuntimeError(f"no route for device {dev}")


philox_draw.launch_count = 0
philox_draw.reference_count = 0


def philox_draw_reference(kind: str, k0: WordArg, k1: WordArg, c2: WordArg,
                          c3: WordArg, m: int,
                          mask: int = _MASK) -> torch.Tensor:
    """The plain version of :func:`philox_draw` on any device: Philox in
    torch int64 ops, then the conversions."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    return _draw_plain(kind, pack_words(k0, k1, c2, c3)[2], int(m), mask)


def _draw_plain(kind: str, packed: Sequence[Packed], m: int,
                mask: int) -> torch.Tensor:
    philox_draw.reference_count += 1
    k0, k1, c2, c3 = packed_values(packed)
    if kind == "normal":
        words = _philox_words_plain(k0, k1, c2, c3, m + (m & 1))
        return words_to_normal(words)[:, :m]
    words = _philox_words_plain(k0, k1, c2, c3, m)
    if kind == "uniform":
        return words_to_uniform(words)
    return words if mask == _MASK else words & mask


def _fill_launcher(kind: str, n: int, dev: torch.device,
                   packed: Sequence[Packed], m: int, mask: int):
    """``(out, launch)``: the output of one draw and a function that
    launches the fill kernel into it on the current stream."""
    from . import _build
    dtype = torch.int64 if kind == "bits" else torch.float32
    out = torch.empty((n, m), dtype=dtype, device=dev)
    m_words = m + (m & 1) if kind == "normal" else m
    spec = []
    for t, stride, shift, value in packed:
        spec += (0 if t is None else t.data_ptr(), stride, shift, value)
    words = (ctypes.c_longlong * 16)(*spec)
    args = (out.data_ptr(), n, m, m_words, _KINDS.index(kind), mask & _MASK,
            ctypes.addressof(words),
            torch.cuda.current_stream(dev).cuda_stream)
    fill = _build.load().philox_stream_fill

    def launch(words=words):     # the host array lives as long as this
        _build.check(fill(*args), "philox_stream_fill")
        philox_draw.launch_count += 1
    return out, launch


def _philox_words_plain(k0, k1, c2, c3, m: int) -> torch.Tensor:
    """The torch route of :func:`philox_words`, on values (ints or (n,)
    int64 tensors, at least one a tensor)."""
    k0, k1, c2, c3 = (w.reshape(-1, 1) if isinstance(w, torch.Tensor)
                      else int(w) for w in (k0, k1, c2, c3))
    col = next(w for w in (c2, c3, k0, k1) if isinstance(w, torch.Tensor))
    j = torch.arange((m + 3) // 4, dtype=torch.int64, device=col.device)
    words = torch.stack(torch.broadcast_tensors(
        *philox4x32_10(j[None, :], 0, c2, c3, k0, k1)),
        dim=-1)                                      # (n, m/4, 4)
    return words.reshape(col.shape[0], -1)[:, :m]


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

    def __init__(self, seed: KeyWord, attempts: torch.Tensor,
                 salt: KeyWord = 0) -> None:
        if attempts.dim() != 1:
            raise ValueError("attempts must be a 1-D tensor")
        self.attempts = attempts.to(torch.int64)
        self.seed = _key_word(seed, self.attempts.device)
        self.salt = _key_word(salt, self.attempts.device)

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
        parent's salt, so a tree of splits never repeats a salt. Needs
        host key words."""
        if not isinstance(self.seed, int) or not isinstance(self.salt, int):
            raise TypeError("split needs the seed and the salt as host ints")
        return [AttemptStreams(self.seed, self.attempts, salt)
                for salt in child_salts(self.seed, self.salt, num)]

    def bits(self, shape: Shape) -> torch.Tensor:
        """(n, *shape) int64 words in [0, 2**32)."""
        return self._draw("bits", shape)

    def uniform(self, shape: Shape) -> torch.Tensor:
        """(n, *shape) float32 uniforms in [0, 1)."""
        return self._draw("uniform", shape)

    def normal(self, shape: Shape) -> torch.Tensor:
        """(n, *shape) float32 standard normals (Box-Muller)."""
        return self._draw("normal", shape)

    def integers(self, high: int, shape: Shape) -> torch.Tensor:
        """(n, *shape) int64 in [0, high), ``high`` a power of two up to
        2**32 (exact: the low bits of uniform words)."""
        if high < 1 or high & (high - 1) or high > 2 ** 32:
            raise ValueError("high must be a power of two <= 2**32")
        return self._draw("bits", shape, high - 1)

    def _draw(self, kind: str, shape: Shape,
              mask: int = _MASK) -> torch.Tensor:
        """One :func:`philox_draw` of ``kind`` over this chunk's attempts:
        the counter words are the attempt's low and high 32 bits."""
        shape = _shape(shape)
        a = self.attempts
        n = a.shape[0]
        k0, k1 = (w if isinstance(w, int) else (w.expand(n), 0)
                  for w in (self.seed, self.salt))
        out = philox_draw(kind, k0, k1, (a, 0), (a, 32), math.prod(shape),
                          mask)
        return out.reshape((n,) + shape)


def _key_word(word: KeyWord, device: torch.device) -> KeyWord:
    """A seed or salt as :class:`AttemptStreams` keeps it: an int masked to
    32 bits, or a one-element int64 tensor on ``device`` (as a 1-D view,
    which a draw expands to its rows with stride 0)."""
    if not isinstance(word, torch.Tensor):
        return int(word) & _MASK
    if word.numel() != 1 or word.dtype != torch.int64 or \
            word.device != device:
        raise ValueError("a key word tensor holds one int64 on the "
                         "attempts' device")
    return word.reshape(1)


@functools.lru_cache(maxsize=256)
def child_salts(seed: int, salt: int, num: int) -> Tuple[int, ...]:
    """The salts of :meth:`AttemptStreams.split`'s ``num`` sub-streams of
    the stream ``(seed, salt)``: host Philox words, computed once a key."""
    base = philox4x32_10_int(salt, 0x5EED, 0, 0, seed, 0x57A17)[0]
    return tuple((base + 0x9E3779B9 * (i + 1)) & _MASK for i in range(num))


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
