"""The benchmark's own spans around the calls into the program.

:class:`Recorder` keeps, on the host's clock, each BER point (from the
runner's ``_on_simulate_current_params_start`` hook to its ``_finish``
hook, and whether the stop rule's target ended it) and each call of the callable the runner's ``_gen_bulk_kernel`` /
``_gen_simulation_kernel`` returns (the kernel wrapper: the bulk kernel
call, or one per-key chain step). :func:`bench_runner` subclasses an app's
runner to feed it; the subclass adds timestamps only and changes no control
flow. While the profiler traces, the same spans are also opened as
``record_function`` ranges so that the trace places them beside the
device's kernels.

A call's counts reach the host before the runner makes its next call or
finishes its point (the stop rule reads them), so a call is *done* at the
first of those two events; ``harness/stats.py`` counts only the calls done
within a window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set

SWEEP, POINT, CALL = "pb.sweep", "pb.point", "pb.call"


@dataclass
class Call:
    t0: float
    t1: float
    n: int                    # attempts
    symbols: int
    done: Optional[float] = None


@dataclass
class Point:
    snr_db: float
    t0: float
    t1: float = 0.0
    reached: bool = True      # the stop rule's target, not rep_max, ended it


@dataclass
class JudgedCall:
    """A call of a judged sweep: its attempts (an int start, or the
    per-key streams' device tensor) and the device tensor of its counts,
    both read once the window has closed."""
    point: int
    snr_db: float
    attempts: Any
    n: int
    counts: Any


@dataclass
class Recorder:
    """Host-clock spans of one process's sweeps. ``call_size(args)``
    returns a call's ``(attempts, n)``; ``symbols_per_attempt`` converts
    attempts to 16-QAM symbols; ``judged`` names the sweeps whose calls
    are kept for the check of ``correct``."""
    call_size: Callable
    symbols_per_attempt: int
    judged: Set[int] = field(default_factory=set)
    stop: Optional[tuple] = None      # the traffic's (result, limit)
    sweep: int = -1
    tracing: bool = False
    calls: List[Call] = field(default_factory=list)
    points: List[Point] = field(default_factory=list)
    kept: Dict[int, List[JudgedCall]] = field(default_factory=dict)
    _open: List[Any] = field(default_factory=list)
    _pending: int = 0         # index of the first call not yet done

    # -- spans that the profiler also sees ------------------------------

    def _enter(self, name: str) -> None:
        if self.tracing:
            import torch
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self._open.append(rf)

    def _exit(self) -> None:
        if self.tracing and self._open:
            self._open.pop().__exit__(None, None, None)

    def _mark_done(self, now: float) -> None:
        for c in self.calls[self._pending:]:
            c.done = now
        self._pending = len(self.calls)

    # -- sweeps ------------------------------------------------------------

    def begin_sweep(self, index: int) -> None:
        self.sweep = index
        self._enter(SWEEP)

    def end_sweep(self) -> None:
        self._mark_done(time.perf_counter())
        self._exit()

    # -- the runner's hooks ------------------------------------------------

    def point_start(self, params) -> None:
        now = time.perf_counter()
        self._mark_done(now)
        self._enter(POINT)
        self.points.append(Point(float(params["SNR"]), now))

    def point_finish(self, results) -> None:
        now = time.perf_counter()
        self._mark_done(now)
        point = self.points[-1]
        point.t1 = now
        if self.stop is not None:
            name, limit = self.stop
            point.reached = float(results[name][-1]._value) >= limit
        self._exit()

    def wrap(self, fn: Callable, params) -> Callable:
        """``fn`` with a host span around each call."""
        point = max(params.unpack_index, 0)
        snr_db = float(params["SNR"])

        def call(*args):
            t0 = time.perf_counter()
            self._mark_done(t0)
            self._enter(CALL)
            out = fn(*args)
            t1 = time.perf_counter()
            self._exit()
            attempts, n = self.call_size(args)
            self.calls.append(Call(t0, t1, n, n * self.symbols_per_attempt))
            if self.sweep in self.judged:
                self.kept.setdefault(self.sweep, []).append(JudgedCall(
                    point, snr_db, attempts, n, out["bit_errors"]))
            return out

        return call


def bench_runner(base):
    """``base`` (an app's ``SimulationRunner`` subclass) with the
    recorder's spans on its hooks and its kernel callable."""

    class BenchRunner(base):
        recorder: Recorder

        def _on_simulate_current_params_start(self, current_params):
            super()._on_simulate_current_params_start(current_params)
            self.recorder.point_start(current_params)

        def _on_simulate_current_params_finish(self, current_params,
                                               current_params_sim_results):
            self.recorder.point_finish(current_params_sim_results)
            super()._on_simulate_current_params_finish(
                current_params, current_params_sim_results)

        def _gen_bulk_kernel(self, current_parameters):
            fn = super()._gen_bulk_kernel(current_parameters)
            return None if fn is None else self.recorder.wrap(
                fn, current_parameters)

        def _gen_simulation_kernel(self, current_parameters):
            fn = super()._gen_simulation_kernel(current_parameters)
            return None if fn is None else self.recorder.wrap(
                fn, current_parameters)

    BenchRunner.__name__ = f"Bench{base.__name__}"
    return BenchRunner
