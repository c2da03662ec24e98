"""The runner's rules for one BER point, replayed: which chunks it runs, how
many attempts it accepts, and the Results it keeps.

Given the per-attempt bit-error counts of every call the program made for
a point (in call order, as ``(first attempt, attempts, counts)``),
:func:`replay_bulk` / :func:`replay_perkey` say which calls the runner's
rules would have made, and the bit errors, bits and accepted attempts the
point's Results must hold. They read the program's counts only to judge the
engine that accounted them; the counts themselves are judged against
:mod:`.flagship`.

Frozen copies, from commit 8958300, of
``pyphysim_tpu_torch/simulations/runner.py``: ``kernel_stream_seed``
(``:62-68``), the chunk sizes (``_default_batch_size``, ``_chunk_quantum``,
``_round_chunk``: ``:780-802``), the accept-prefix accounting
(``_consume_chunk``: ``:820-867``), the per-key sub-chunk gate
(``_make_chunk_executor``: ``:908-931``) and the chunk loops
(``_batch_loop``: ``:935-995``; ``_bulk_loop`` with its ladder and
``pick_chunk``: ``:997-1077``), for points with no skipped attempts, no
resume, and either no stop criterion or one on a SUMTYPE result.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Call = Tuple[int, int, np.ndarray]      # (first attempt, attempts, counts)


def kernel_stream_seed(base_seed: int, unpack_index: int) -> int:
    """A variation's 31-bit stream seed."""
    return (int(base_seed) * 1000003 + max(int(unpack_index), 0)) \
        & 0x7FFFFFFF


def _round_chunk(n: int, quantum: int) -> int:
    return ((max(int(n), 1) + quantum - 1) // quantum) * quantum


def _mismatch(why: str) -> Dict:
    return {"ok": False, "why": why}


def _open(rep: int, rep_max: int, metric: float, limit) -> bool:
    """The loops' condition: attempts left, and the stop rule's limit (if
    any) not reached."""
    return rep < rep_max and (limit is None or metric < float(limit))


def replay_bulk(calls: Sequence[Call], rep_max: int, batch_size: int,
                limit: Optional[float], subchunks: int) -> Dict:
    """The bulk loop's point: ``{"ok", "why", "calls", "reps",
    "bit_errors"}``. ``ok`` is False where the program's calls are not
    those the rules make. ``limit`` None: no stop rule, every call a whole
    chunk (speculative dispatch does not change which calls are made)."""
    q = max(int(subchunks), 1) if limit is not None else 1
    bsize = _round_chunk(batch_size, q)
    ladder = sorted({_round_chunk(max(bsize // d, 1), q)
                     for d in (8, 4, 2, 1)})
    rep, cursor, metric = 0, 0, 0.0
    made: List[Tuple[int, int]] = []
    for start, n, counts in calls:
        if not _open(rep, rep_max, metric, limit):
            return _mismatch(f"a call at attempt {start} after the point "
                             "should have ended")
        needed = rep_max - rep
        if limit is None:
            nk = bsize
        else:
            nk = next((m for m in ladder if m >= needed), ladder[-1])
            if rep > 0 and metric > 0:
                expected = (float(limit) - metric) / (metric / rep)
                rung = ladder[0]
                for m in ladder:
                    if m <= expected:
                        rung = m
                nk = min(nk, rung)
        if (start, n) != (cursor, nk):
            return _mismatch(f"call {len(made)} ran attempts [{start}, "
                             f"{start + n}); the rules run [{cursor}, "
                             f"{cursor + nk})")
        counts = np.asarray(counts, np.int64)
        accept = min(nk, needed)
        metric += float(counts[:accept].sum())
        rep += accept
        cursor += accept
        made.append((start, n))
    if _open(rep, rep_max, metric, limit):
        return _mismatch("the point ended before its stop rule")
    return {"ok": True, "why": "", "calls": made, "reps": rep,
            "bit_errors": int(round(metric))}


def replay_perkey(calls: Sequence[Call], rep_max: int, batch_size: int,
                  limit: Optional[float], subchunks: int) -> Dict:
    """The per-key loop's point (its calls are the sub-chunks, or without a
    stop rule the chunks), as :func:`replay_bulk`."""
    n_sub = max(int(subchunks), 1) if limit is not None else 1
    bsize = _round_chunk(batch_size, n_sub)
    lim32 = np.float32(limit if limit is not None else np.inf)
    rep, cursor, metric = 0, 0, 0.0
    made: List[Tuple[int, int]] = []
    pending = list(calls)
    while _open(rep, rep_max, metric, limit):
        needed = rep_max - rep
        nk = min(bsize, _round_chunk(needed, n_sub))
        sub = nk // n_sub
        acc = np.float32(metric)
        ran = []
        while len(ran) < n_sub and acc < lim32:
            if not pending:
                return _mismatch("the point ended before its stop rule")
            start, n, counts = pending.pop(0)
            want = cursor + len(ran) * sub
            if (start, n) != (want, sub):
                return _mismatch(f"call {len(made)} ran attempts [{start}, "
                                 f"{start + n}); the rules run [{want}, "
                                 f"{want + sub})")
            counts = np.asarray(counts, np.int64)
            acc = np.float32(acc + np.float32(counts.sum()))
            ran.append(counts)
            made.append((start, n))
        if not ran:
            break         # the gate ran no sub-chunk: the loop stops
        active = np.concatenate(ran)
        accept = min(len(active), needed)
        metric += float(active[:accept].sum())
        rep += accept
        cursor += accept
    if pending:
        return _mismatch(f"{len(pending)} calls after the point should "
                         "have ended")
    return {"ok": True, "why": "", "calls": made, "reps": rep,
            "bit_errors": int(round(metric))}
