"""The work one call of the SC-FDMA equalizer needs, from its shapes alone
(``harness/work.py`` holds the card's peaks).

The equalizer's interface (``pyphysim_tpu_torch/ops/mimo_detect.py``
``sc_mmse_eq``): for each attempt and subcarrier, the channel estimate H
(Nr x Nt complex64) held over the subframe, and y (Nr complex64) of each
data symbol in; x = W y (Nt complex64) of each data symbol and each
layer's MMSE gain summed over the subcarriers (one float32 an attempt and
layer) out. Its bytes are those inputs read once and those outputs written
once (the pilot symbols of y are not the equalizer's input). Its
operations are the fewest float32 ones of the function, counting a real
multiply or add as one (a complex multiply-add 8, ``|h|^2`` accumulated
4):

  * once a subcarrier: the Gram ``H^H H + s2 I`` (as in
    ``harness/mimo_work.py``), its LDL^H factors without square roots, W =
    A^-1 H^H by Nr solves with the factors (forward and back
    substitutions, 8 a complex multiply-add, and the scaling by 1 / D: 8
    Nt (Nt - 1) + 2 Nt each), and the gains Re (W H)_tt (4 a term, Nr Nt
    terms);
  * once an RE: W y, Nt Nr complex multiply-adds.

This order is the fewest where the data symbols outnumber the receive
antennas (12 against 4 here): H^H y and the two substitutions an RE
instead of W y cost 8 Nt (Nt - 1) + 2 Nt more an RE, W's Nr solves the
same amount Nr times a subcarrier. The sums of the gains are not priced,
so a share of this work can only read low.
"""

from __future__ import annotations

from .work import least_seconds


def filter_flops(nr: int, nt: int) -> int:
    """float32 operations of one subcarrier's filter and gains."""
    gram = nr * (4 * nt + 8 * nt * (nt - 1) // 2) + nt
    factor = sum(5 * j + 1 + (nt - 1 - j) * (10 * j + 2) for j in range(nt))
    solves = nr * (8 * nt * (nt - 1) + 2 * nt)
    return gram + factor + solves + 4 * nr * nt


def equalize_flops(attempts: int, data_res: int, used: int, nr: int,
                   nt: int) -> int:
    """float32 operations of one call: ``data_res`` REs a layer an
    attempt on ``used`` subcarriers."""
    return attempts * (used * filter_flops(nr, nt) + data_res * 8 * nr * nt)


def equalize_bytes(attempts: int, data_res: int, used: int, nr: int,
                   nt: int) -> int:
    """Bytes one call must move: H a subcarrier and y a data RE in, x a
    data RE and the gain sums out."""
    return attempts * (used * 8 * nr * nt + data_res * 8 * (nr + nt) +
                       4 * nt)


def equalize_least_seconds(attempts: int, data_res: int, used: int, nr: int,
                           nt: int) -> float:
    """The least time one call of ``attempts`` attempts can take on the
    card."""
    return least_seconds(
        equalize_flops(attempts, data_res, used, nr, nt),
        equalize_bytes(attempts, data_res, used, nr, nt))
