"""Arithmetic of the end-to-end metrics over a measured window's host
spans (``window.run_process``'s ``host``): the window is ``[t0, t_end)`` on
``time.perf_counter``, every call is ``(t0, t1, attempts, symbols, done)``
and every point ``(t0, t1, snr_db)``."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def point_seconds(host: Dict) -> List[float]:
    """The seconds of every point that finished inside the window, from
    its start hook to its finish hook."""
    return [t1 - t0 for t0, t1, _ in host["points"]
            if t1 and host["t0"] <= t0 and t1 <= host["t_end"]]


def window_symbols(host: Dict) -> int:
    """Symbols of every call whose counts reached the host inside the
    window."""
    return sum(sym for t0, _, _, sym, done in host["calls"]
               if done is not None and host["t0"] <= t0 and
               done <= host["t_end"])


def percentile(values: List[float], q: float) -> float:
    """numpy's linear-interpolation percentile."""
    return float(np.percentile(np.asarray(values, float), q))
