"""Philox4x32-10 and the two stream layouts the benchmark's cells draw from,
frozen so that a change to the program cannot move the yardstick.

Frozen copies, from commit 8958300:

  * :func:`philox4x32_10`, :func:`philox4x32_10_int`, :func:`to_int32_bits`,
    :func:`phase_stream_bits`, :func:`symbol_stream_bits`:
    ``pyphysim_tpu_torch/ops/philox.py:84-163`` (the Monte Carlo kernel's
    layout: phase stream key ``(seed, 0)``, counter ``(il, 0, a_lo, a_hi)``;
    symbol stream key ``(seed, 1)``, counter ``(s * used + u, tile, a_lo,
    a_hi)``);
  * :func:`split_salts`, :func:`stream_words`, :func:`words_to_uniform`,
    :func:`words_to_normal`: ``pyphysim_tpu_torch/ops/streams.py:178-207``
    and ``:237-275`` (per-attempt streams: key ``(seed, salt)``, counter
    ``(j, 0, a_lo, a_hi)`` for the j-th group of four words of a row; a
    split's child salts are Philox words of the parent's salt).

Words are int64 tensors holding values in [0, 2**32). Imports only torch.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = a * (b & 0xFFFF)
    y = a * (b >> 16)
    hi = (y + (x >> 16)) >> 16
    lo = (((y & 0xFFFF) << 16) + x) & MASK
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 of the counter ``(c0, c1, c2, c3)`` under the key
    ``(k0, k1)``: python ints or int64 tensors, broadcast together."""
    c0, c1, c2, c3 = (c if isinstance(c, torch.Tensor)
                      else torch.as_tensor(c, dtype=torch.int64)
                      for c in (c0, c1, c2, c3))
    for i in range(10):
        if i:
            k0 = (k0 + _W0) & MASK
            k1 = (k1 + _W1) & MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox4x32_10_int(c0: int, c1: int, c2: int, c3: int, k0: int,
                      k1: int) -> Tuple[int, int, int, int]:
    """:func:`philox4x32_10` of one counter, in Python ints."""
    for i in range(10):
        if i:
            k0 = (k0 + _W0) & MASK
            k1 = (k1 + _W1) & MASK
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & MASK,
                          (p0 >> 32) ^ c3 ^ k1, p0 & MASK)
    return c0, c1, c2, c3


def to_int32_bits(word: torch.Tensor) -> torch.Tensor:
    """A 32-bit word held in int64 as the int32 with the same bits."""
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def _attempt_words(attempts: torch.Tensor):
    a = attempts.to(torch.int64)
    return a & MASK, (a >> 32) & MASK


def phase_stream_bits(seed: int, attempts: torch.Tensor,
                      TL: int) -> torch.Tensor:
    """(reps, 2, TL) int32: the ray angle / ray phase bits of every (tap,
    ray) pair ``il`` of each absolute attempt."""
    lo, hi = _attempt_words(attempts[:, None])
    il = torch.arange(TL, dtype=torch.int64, device=attempts.device)
    x0, x1, _, _ = philox4x32_10(il[None, :], 0, lo, hi, int(seed), 0)
    return to_int32_bits(torch.stack([x0, x1], dim=1))


def symbol_stream_bits(seed: int, attempts: torch.Tensor, num_tiles: int,
                       tile: int, used: int):
    """Data, real-noise and imaginary-noise bits, each (reps,
    num_tiles * tile, used) int32, of each absolute attempt."""
    dev = attempts.device
    lo, hi = _attempt_words(attempts[:, None, None])
    su = torch.arange(tile * used, dtype=torch.int64, device=dev)
    tiles = torch.arange(num_tiles, dtype=torch.int64, device=dev)
    x0, x1, x2, _ = philox4x32_10(su[None, None, :], tiles[None, :, None],
                                  lo, hi, int(seed), 1)
    shape = (attempts.shape[0], num_tiles * tile, used)
    return tuple(to_int32_bits(x).reshape(shape) for x in (x0, x1, x2))


def split_salts(seed: int, salt: int, num: int) -> List[int]:
    """The salts of ``num`` sub-streams split from the stream ``(seed,
    salt)``."""
    base = philox4x32_10_int(salt & MASK, 0x5EED, 0, 0, seed & MASK,
                             0x57A17)[0]
    return [(base + 0x9E3779B9 * (i + 1)) & MASK for i in range(num)]


def stream_words(seed: int, salt: int, attempts: torch.Tensor,
                 m: int) -> torch.Tensor:
    """(n, m) int64 words of the stream ``(seed, salt)`` for each absolute
    attempt of the 1-D ``attempts``."""
    lo, hi = _attempt_words(attempts[:, None])
    j = torch.arange((m + 3) // 4, dtype=torch.int64, device=attempts.device)
    words = torch.stack(torch.broadcast_tensors(*philox4x32_10(
        j[None, :], 0, lo, hi, seed & MASK, salt & MASK)), dim=-1)
    return words.reshape(attempts.shape[0], -1)[:, :m]


def words_to_uniform(words: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) from the top 24 bits of each word, in float64
    (the float32 value exactly)."""
    return (words >> 8).to(torch.float64) * (2.0 ** -24)


def words_to_normal(words: torch.Tensor) -> torch.Tensor:
    """Standard normals by Box-Muller, two per pair of words along the last
    axis, in float64 from the float32-exact uniforms."""
    u = words_to_uniform(words)
    r = torch.sqrt(-2.0 * torch.log(1.0 - u[..., 0::2]))
    ang = 2.0 * torch.pi * u[..., 1::2]
    return torch.stack([r * torch.cos(ang), r * torch.sin(ang)],
                       dim=-1).reshape(words.shape)
