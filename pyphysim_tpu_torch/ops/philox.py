"""Philox4x32-10 in torch integer ops, and the Monte Carlo kernel's stream
layout.

This is the port's counterpart of the TPU's in-kernel hardware PRNG
(``pltpu.prng_seed`` / ``prng_random_bits`` in
``pyphysim_tpu/ops/mc_pallas.py``). TPU-PRNG streams cannot be reproduced
off the TPU, so the port uses a counter-based generator instead: Philox4x32
with 10 rounds (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011; the Random123 reference values are in the tests). The same
function is written in CUDA in ``ops/csrc/philox.cuh`` for the kernel, and
the two produce the same bits.

Words are carried in int64 tensors holding values in ``[0, 2**32)``: torch
has almost no uint32 arithmetic. The 32x32 -> 64-bit multiply would
overflow int64 (0xD2511F53 * 0xFFFFFFFF > 2**63), so one factor is split
into 16-bit halves and the product's high and low words are recombined.

Stream layout of ``MonteCarloOfdmTdl`` (``ops/mc_kernel.py``). ``seed`` is
``kernel_stream_seed(base_seed, unpack_index)`` and ``attempt`` is the
runner's 64-bit absolute attempt index (``start + r`` for row ``r`` of a
call at ``start``):

  * phase stream: key ``(seed, 0)``, counter
    ``(il, 0, attempt_lo, attempt_hi)`` for (tap, ray) pair ``il``; output
    words 0 / 1 are the bits of the ray angle phi / the ray phase psi. It
    is keyed per attempt only, so every symbol tile of a repetition sees
    the same rays and the channel stays continuous across tiles.
  * symbol stream: key ``(seed, 1)``, counter
    ``(s * used + u, tile, attempt_lo, attempt_hi)`` for symbol ``s`` of
    symbol tile ``tile`` on used bin ``u``; output words 0 / 1 / 2 are the
    data / real-noise / imaginary-noise bits.

Stream layout of ``MonteCarloAlamouti`` (``ops/alamouti_kernel.py``), for
repetition ``attempt``, symbol tile ``tile``, codeword row ``r`` of the
tile and lane ``l`` (lanes are independent channel streams):

  * channel stream: key ``(seed, 2)``, counter ``(l, 0, attempt_lo,
    attempt_hi)``; words 0-3 are the bits of h1.re, h1.im, h2.re, h2.im.
    It does not depend on the tile, so every tile of a repetition sees the
    lane's one channel draw.
  * noise stream: key ``(seed, 3)``, counter ``(r * lane + l, tile,
    attempt_lo, attempt_hi)``; words 0-3 are the bits of n1.re, n1.im,
    n2.re, n2.im.
  * data stream: key ``(seed, 4)``, counter ``(g * lane + l, tile,
    attempt_lo, attempt_hi)`` for the group ``g = r >> 5`` of 32 rows; row
    ``r``'s two QPSK indices are the 4-bit nibble ``r & 7`` of word
    ``(r >> 3) & 3``.

Stream layout of ``MonteCarloBD`` (``ops/bd_kernel.py``): key ``(seed, 5)``,
counter ``(r * lane + l, tile * G + j, attempt_lo, attempt_hi)`` for
element ``(r, l)`` of tile ``tile`` and ``j < G = ceil(num_planes / 4)``;
word ``w`` of call ``j`` is the bit plane ``4 j + w`` (plane ``2 (i NT +
c)`` is H[i, c].re, the next one its imaginary part).

The key words 2-6 are used by nothing else: ``ops/streams.py`` keys its
streams by a salt of 0 or a Philox word of a salt. Every counter holds the
absolute attempt, so the bits of attempt ``start + i`` do not depend on
``start`` or on the chunk size: results are chunk-size invariant and
checkpoint/resume is exact.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["philox4x32_10", "philox4x32_10_int", "to_int32_bits",
           "phase_stream_bits", "symbol_stream_bits", "alamouti_stream_bits", "bd_stream_bits",
           "ia_stream_bits", "ALAMOUTI_CHANNEL_KEY", "ALAMOUTI_NOISE_KEY",
           "ALAMOUTI_DATA_KEY", "BD_CHANNEL_KEY", "IA_CHANNEL_KEY"]

ALAMOUTI_CHANNEL_KEY, ALAMOUTI_NOISE_KEY, ALAMOUTI_DATA_KEY = 2, 3, 4
BD_CHANNEL_KEY = 5
IA_CHANNEL_KEY = 6

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57     # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85     # Weyl key increments

Word = Union[int, torch.Tensor]


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a * b`` for a 32-bit constant ``a``
    and int64 ``b`` in [0, 2**32), without overflowing int64."""
    x = a * (b & 0xFFFF)           # < 2**48
    y = a * (b >> 16)              # < 2**48
    hi = (y + (x >> 16)) >> 16
    lo = (((y & 0xFFFF) << 16) + x) & _MASK
    return hi, lo


def philox4x32_10(c0: Word, c1: Word, c2: Word, c3: Word,
                  k0: Word, k1: Word) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 of the counter ``(c0, c1, c2, c3)`` under the key
    ``(k0, k1)``. Arguments are python ints or int64 tensors (broadcast
    together) with values in [0, 2**32); returns four int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      if not isinstance(c, torch.Tensor) else c
                      for c in (c0, c1, c2, c3))
    for i in range(10):
        if i:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox4x32_10_int(c0: int, c1: int, c2: int, c3: int, k0: int,
                      k1: int) -> Tuple[int, int, int, int]:
    """:func:`philox4x32_10` of one counter under one key in Python ints:
    the same four words, with no tensor ops (a stream split draws one)."""
    for i in range(10):
        if i:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & _MASK,
                          (p0 >> 32) ^ c3 ^ k1, p0 & _MASK)
    return c0, c1, c2, c3


def to_int32_bits(word: torch.Tensor) -> torch.Tensor:
    """A 32-bit word in int64 as the int32 with the same bits (the signed
    view that ``_u01`` / ``_u11`` scale, and the layout the kernel's bit
    tensors use)."""
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def _attempt_words(attempts: torch.Tensor):
    a = attempts.to(torch.int64)
    return a & _MASK, (a >> 32) & _MASK


def phase_stream_bits(seed: int, attempts: torch.Tensor,
                      TL: int) -> torch.Tensor:
    """(reps, 2, TL) int32: the phi / psi bits of every (tap, ray) pair,
    for each absolute attempt in the 1-D int64 tensor ``attempts``."""
    lo, hi = _attempt_words(attempts[:, None])
    il = torch.arange(TL, dtype=torch.int64, device=attempts.device)
    x0, x1, _, _ = philox4x32_10(il[None, :], 0, lo, hi, int(seed), 0)
    return to_int32_bits(torch.stack([x0, x1], dim=1))


def symbol_stream_bits(seed: int, attempts: torch.Tensor, num_tiles: int,
                       tile: int, used: int, first_tile: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Data, real-noise and imaginary-noise bits, each (reps,
    num_tiles * tile, used) int32, of tiles ``[first_tile, first_tile +
    num_tiles)`` for each absolute attempt in the 1-D int64 tensor
    ``attempts``."""
    dev = attempts.device
    lo, hi = _attempt_words(attempts[:, None, None])
    su = torch.arange(tile * used, dtype=torch.int64, device=dev)
    tiles = torch.arange(first_tile, first_tile + num_tiles,
                         dtype=torch.int64, device=dev)
    x0, x1, x2, _ = philox4x32_10(su[None, None, :], tiles[None, :, None],
                                  lo, hi, int(seed), 1)
    shape = (attempts.shape[0], num_tiles * tile, used)
    return tuple(to_int32_bits(x).reshape(shape) for x in (x0, x1, x2))


def alamouti_stream_bits(seed: int, attempts: torch.Tensor, num_tiles: int,
                         tile: int, lane: int) -> Tuple[torch.Tensor, ...]:
    """The Alamouti kernel's bits for each absolute attempt in the 1-D
    int64 tensor ``attempts``: channel bits (reps, 4, lane) and the data
    nibbles and noise bits n1.re, n1.im, n2.re, n2.im, each
    (reps, num_tiles * tile, lane), all int32."""
    dev = attempts.device
    reps = attempts.shape[0]
    lo, hi = _attempt_words(attempts[:, None])
    lanes = torch.arange(lane, dtype=torch.int64, device=dev)
    ch = torch.stack(philox4x32_10(lanes[None, :], 0, lo, hi, int(seed),
                                   ALAMOUTI_CHANNEL_KEY), dim=1)
    lo, hi = _attempt_words(attempts[:, None, None])
    tiles = torch.arange(num_tiles, dtype=torch.int64, device=dev)[None, :,
                                                                   None]
    rl = torch.arange(tile * lane, dtype=torch.int64, device=dev)
    noise = philox4x32_10(rl[None, None, :], tiles, lo, hi, int(seed),
                          ALAMOUTI_NOISE_KEY)
    shape = (reps, num_tiles * tile, lane)
    noise = [to_int32_bits(x).reshape(shape) for x in noise]
    groups = (tile + 31) // 32
    gl = torch.arange(groups * lane, dtype=torch.int64, device=dev)
    words = torch.stack(philox4x32_10(gl[None, None, :], tiles, lo, hi,
                                      int(seed), ALAMOUTI_DATA_KEY), dim=2)
    # (reps, nt, 4, groups * lane) -> word q = 4 g + j of row r is q = r >> 3
    words = words.reshape(reps, num_tiles, 4, groups, lane).transpose(2, 3)
    words = words.reshape(reps, num_tiles, groups * 4, lane)
    r = torch.arange(tile, dtype=torch.int64, device=dev)
    d = (words[:, :, r >> 3, :] >> (4 * (r & 7))[None, None, :, None]) & 15
    return (to_int32_bits(ch), d.to(torch.int32).reshape(shape), *noise)


def bd_stream_bits(seed: int, attempts: torch.Tensor, num_tiles: int,
                   tile: int, lane: int, num_planes: int) -> torch.Tensor:
    """The BD kernel's channel bits for each absolute attempt in the 1-D
    int64 tensor ``attempts``, in the inject layout: (reps,
    num_tiles * tile, num_planes * lane) int32, plane ``p`` at lanes
    ``[p * lane, (p + 1) * lane)``."""
    return _plane_stream_bits(BD_CHANNEL_KEY, seed, attempts, num_tiles, tile,
                              lane, num_planes)


def ia_stream_bits(seed: int, attempts: torch.Tensor, num_tiles: int,
                   tile: int, lane: int, num_planes: int) -> torch.Tensor:
    """The Max-SINR IA kernel's channel bits, laid out as
    :func:`bd_stream_bits` and drawn under ``IA_CHANNEL_KEY``."""
    return _plane_stream_bits(IA_CHANNEL_KEY, seed, attempts, num_tiles, tile,
                              lane, num_planes)


def _plane_stream_bits(stream_key: int, seed: int, attempts: torch.Tensor,
                       num_tiles: int, tile: int, lane: int,
                       num_planes: int) -> torch.Tensor:
    dev = attempts.device
    reps = attempts.shape[0]
    calls = (num_planes + 3) // 4
    lo, hi = _attempt_words(attempts[:, None, None, None])
    c1 = (torch.arange(num_tiles, dtype=torch.int64, device=dev)[:, None] *
          calls + torch.arange(calls, dtype=torch.int64, device=dev))
    rl = torch.arange(tile * lane, dtype=torch.int64, device=dev)
    words = torch.stack(philox4x32_10(rl, c1[None, :, :, None], lo, hi,
                                      int(seed), stream_key), dim=3)
    # (reps, nt, calls, 4, tile * lane) -> planes (reps, nt, P, tile, lane)
    planes = words.reshape(reps, num_tiles, calls * 4, tile, lane)
    planes = planes[:, :, :num_planes].permute(0, 1, 3, 2, 4)
    return to_int32_bits(planes.reshape(reps, num_tiles * tile,
                                        num_planes * lane))
