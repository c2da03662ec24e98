"""The check of ``correct``: what the timed path produced, held to the plain
reference.

For each judged sweep (drawn from the seed, :func:`window.judged_sweeps`),
every call the program made is compared:

  * ``count_gap_share``: the per-attempt bit-error counts of every call
    against :mod:`reference.flagship` on the same attempts, as the summed
    absolute gap over the bits those attempts simulated;
  * ``count_gap_max``: the widest gap of one attempt;
  * ``engine_faults``: the BER points whose calls or Results (bit errors,
    bits, accepted attempts, and where the stop rule ended the point) are
    not those :mod:`reference.engine`'s replay of the runner's rules makes
    of the program's counts.

Each number has its limit in the traffic's file (``limits``); the run is
correct when none passes its limit. The traffic's path module
(:func:`program.path`) gives the reference and the replay of its route.
Runs on the device given, after the program's state is freed, in blocks of
attempts.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..reference import engine
from . import program

NUMBERS = ("count_gap_share", "count_gap_max", "engine_faults")


def judge(cfg: Dict, wl: Dict, sweeps: Dict[int, Dict],
          device) -> Tuple[bool, Dict, List[str]]:
    """``(correct, {number: {"value", "limit"}}, notes)``."""
    limits = wl["limits"]
    route = program.path(wl["path"])
    bits = route.bits_per_attempt(cfg, wl)
    gap_sum, gap_max, judged_bits = 0, 0, 0
    faults = 0
    notes: List[str] = []
    if not sweeps:
        notes.append("no judged sweep ran")
        faults += 1
    for index, sweep in sorted(sweeps.items()):
        by_point: Dict[int, List] = {}
        for point, snr_db, attempts, n, counts in sweep["calls"]:
            seed = engine.kernel_stream_seed(sweep["base_seed"], point)
            want = route.reference_counts(cfg, wl, seed, snr_db, attempts,
                                          n, device)
            got = np.asarray(counts, np.int64).reshape(-1)
            if got.shape != want.shape:
                notes.append(f"sweep {index} point {point}: {got.shape[0]} "
                             f"counts for {n} attempts")
                faults += 1
                continue
            gap = np.abs(got - want)
            gap_sum += int(gap.sum())
            gap_max = max(gap_max, int(gap.max()))
            judged_bits += bits * n
            if np.ndim(attempts):
                # the per-key streams' attempts: a call runs a range
                att = np.asarray(attempts, np.int64).reshape(-1)
                first = int(att[0])
                if not np.array_equal(att, np.arange(first, first + n)):
                    notes.append(f"sweep {index} point {point}: a call's "
                                 "attempts are not one range")
                    faults += 1
            else:
                first = int(attempts)
            by_point.setdefault(point, []).append((first, n, got))
        for point, res in enumerate(sweep["points"]):
            r = route.replay(by_point.get(point, []), wl)
            if not r["ok"]:
                notes.append(f"sweep {index} point {point}: {r['why']}")
                faults += 1
                continue
            want = {"reps": r["reps"], "bit_errors": r["bit_errors"],
                    "ber_value": float(r["bit_errors"]),
                    "ber_total": float(r["reps"] * bits)}
            bad = [k for k, v in want.items() if res[k] != v]
            if bad:
                notes.append(f"sweep {index} point {point}: Results "
                             f"{ {k: res[k] for k in bad} } != {want}")
                faults += 1
    share = gap_sum / judged_bits if judged_bits else float("inf")
    values = {"count_gap_share": share, "count_gap_max": gap_max,
              "engine_faults": faults}
    compare = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    correct = all(values[k] <= limits[k] for k in NUMBERS)
    return correct, compare, notes
