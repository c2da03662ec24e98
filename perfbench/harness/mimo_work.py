"""The work one call of the per-RE MIMO detector needs, from its shapes
alone (``harness/work.py`` holds the other kernels' and the card's peaks).

The detector's interface (``pyphysim_tpu_torch/ops/mimo_detect.py``
``mimo_mmse``): for each of the call's resource elements (REs), H (Nr x Nt
complex64), y (Nr complex64) and the Nt sent indices (int64) in, one
int64 bit-error count an attempt out. Its bytes are those inputs read
once and the counts written once. Its operations are the fewest float32
ones of the function, counting a real multiply or add as one (a complex
multiply-add 8, ``|h|^2`` accumulated 4):

  * the Gram ``H^H H + s2 I``: the Nt diagonal entries (4 Nr each, plus
    the regulariser's add) and the Nt (Nt - 1) / 2 above it (8 Nr each);
  * ``H^H y``: Nt Nr complex multiply-adds;
  * the solve, LDL^H without square roots: column j's pivot (5 j, and a
    reciprocal) and its Nt - 1 - j entries below it (10 j + 2 each), the
    forward and back substitutions (8 a complex multiply-add, Nt (Nt - 1)
    in all) and the scaling by 1 / D (2 Nt);
  * the decision: a multiply-add an axis and layer (4 Nt).

The slicer's rounding, clamps and the bit count are not priced, so a share
of this work can only read low.

The channel's block FIR on the MIMO route (``channels/fading.py``
``tdl_filter_block_fft_mimo``) is one ``block_fir`` call over a row for
each attempt, OFDM symbol and (receive, transmit) antenna pair: each
transmit antenna's block of fft + cp samples, repeated for each receive
antenna, convolved with that link's taps (``harness/work.py`` prices a
row).
"""

from __future__ import annotations

from .work import least_seconds


def fir_rows(attempts: int, res_per_attempt: int, used: int, nr: int,
             nt: int) -> int:
    """Rows of one call's MIMO block FIR: one an attempt, OFDM symbol
    (``res_per_attempt / used`` of them) and antenna pair."""
    return attempts * (res_per_attempt // used) * nr * nt


def mmse_flops_per_re(nr: int, nt: int) -> int:
    """float32 operations one RE's detection needs at least."""
    gram = nr * (4 * nt + 8 * nt * (nt - 1) // 2) + nt
    rhs = 8 * nr * nt
    factor = sum(5 * j + 1 + (nt - 1 - j) * (10 * j + 2) for j in range(nt))
    solve = factor + 8 * nt * (nt - 1) + 2 * nt
    return gram + rhs + solve + 4 * nt


def mmse_bytes(attempts: int, res_per_attempt: int, nr: int, nt: int) -> int:
    """Bytes one call must move: H, y and the int64 indices of every RE
    in, one int64 count an attempt out."""
    per_re = 8 * nr * nt + 8 * nr + 8 * nt
    return attempts * (res_per_attempt * per_re + 8)


def mmse_least_seconds(attempts: int, res_per_attempt: int, nr: int,
                       nt: int) -> float:
    """The least time one call of ``attempts`` attempts of
    ``res_per_attempt`` REs can take on the card."""
    res = attempts * res_per_attempt
    return least_seconds(res * mmse_flops_per_re(nr, nt),
                         mmse_bytes(attempts, res_per_attempt, nr, nt))
