"""Spans at the port's layer boundaries, recorded while ``torch.profiler``
runs.

    from pyphysim_tpu_torch import tracing

    with tracing.span("engine.point", base_seed=1234, unpack_index=0):
        ...

A span records only while a ``torch.profiler`` session runs: that is its
only switch. Without one, :func:`span` reads one flag of the profiler
(``torch.autograd.profiler._is_profiler_enabled``, reached through
``sys.modules`` so that importing this module loads no ``torch``) and
returns a shared object that does nothing. Under the profiler a span

  * opens a profiler range under its name (the ``RecordFunction`` of
    ``torch.profiler.record_function``, through its C++ form
    ``torch._C._profiler._RecordFunctionFast``, which costs a span on an
    H100's host ~1 µs against ~9 µs), so that an exported trace
    (``prof.export_chrome_trace``) shows it on the profiler's clock beside
    the kernels, and
  * records a :class:`Span` in memory: its name, its start and end on
    ``time.perf_counter_ns``, the index of its parent span in the same
    list (-1 for none), its request and its attributes.

A span's request is the ``(base_seed, unpack_index)`` of the enclosing
``engine.point`` (one BER point of a sweep), or None outside one. Each
thread keeps its own stack of open spans (a sweep may run on a thread of
its own: ``SimulationRunner.simulate_in_parallel(block=False)``).

Each profiler session gets the next session number; :func:`spans` returns
one session's records, the newest by default, and :func:`clear` forgets
every record.

The spans, each at a layer boundary:

===================  =========================================================
``engine.sweep``     ``SimulationRunner.simulate``: one sweep
``engine.point``     ``_simulate_for_current_params``: one point, from before
                     its start hook (attributes ``base_seed``,
                     ``unpack_index``)
``wrapper.call``     one call of the kernel callable: the bulk kernel's
                     ``fn(start, n)``, or the per-key ``kernel(streams)``
                     (attribute ``attempts``)
``engine.wait``      one wait a call on every chunked path (a bulk call, a
                     per-key chunk or sub-chunk) for the host copies of its
                     outputs, one a distinct device tensor
                     (``_fetch_each_once``); and each ``.cpu()`` of a CPU
                     tensor output
``engine.account``   ``_consume_chunk``: a chunk's accounting (attribute
                     ``attempts``)
``engine.deferred``  under a stop criterion, a chunk's bookkeeping (its
                     ``engine.account``, progress and checkpoint) run after
                     the next chunk was dispatched, so while the device runs
                     it
``engine.overlap``   the per-key executor's host outputs of a sub-chunk,
                     built after the next sub-chunk was dispatched (so
                     while the device runs it)
``chain.draw``       ``ChainStep.step``'s draws: the stream split, the data,
                     the channel state, the noise; where the step replays a
                     CUDA graph, the split and the writes of the graph's
                     input buffers
``chain.forward``    ``ChainStep.step``'s ``forward``; where the step replays
                     a CUDA graph, the replay's enqueue and the copy of its
                     counts
``chain.replay``     inside ``chain.forward``: one replay of the step's CUDA
                     graph (its ``cudaGraphLaunch``)
===================  =========================================================

``chain.draw``, ``chain.forward`` and ``chain.replay`` serve every step
with :class:`~pyphysim_tpu_torch.chain.ReplayedStep`'s ``step``
(``ChainStep``, ``MimoChainStep``).

Beside the spans, the program counts its kernels' launches, recorded
always: ``ops.fir.block_fir.launch_count``,
``ops.streams.philox_draw.launch_count`` and
``ops.mimo_detect.mimo_mmse.launch_count``, each advanced by a replay as
many times as the captured step launched the kernel.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

__all__ = ["Span", "clear", "sessions", "span", "spans"]

_PROFILER = "torch.autograd.profiler"
REQUEST = "engine.point"

_modules = sys.modules
_clock = time.perf_counter_ns


class Span(NamedTuple):
    """One recorded span. ``start_ns`` / ``end_ns`` are
    ``time.perf_counter_ns`` readings (both 0 while the span is open);
    ``parent`` indexes the session's list (-1: none); ``request`` is the
    enclosing ``engine.point``'s ``(base_seed, unpack_index)``."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    request: Optional[Tuple[Any, Any]]
    attrs: Dict[str, Any]


class _Off:
    """The span returned while no profiler runs."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Stack(threading.local):
    def __init__(self) -> None:
        self.open: List["_Recording"] = []


_stack = _Stack()
_lock = threading.Lock()
# a session's records are plain tuples, (name, start_ns, end_ns, parent,
# request, attrs), which the garbage collector stops tracking: a long
# traced window adds nothing to each collection's walk
_records: Dict[int, List[tuple]] = {}
_session = 0
_counted: Any = None      # the profiler module whose starts are counted
_range: Any = None        # the profiler's range: _range(name)


def _count_starts(prof) -> None:
    """Number the profiler's sessions from now on: every start of a
    session (``_run_on_profiler_start``, which each profiler calls as it
    starts) takes the next number; the session running now takes one as
    well. Also picks the range a span opens: the C++ ``RecordFunction``
    that ``record_function`` opens, without its Python and operator calls
    (``_RecordFunctionFast``), or ``record_function`` where this torch
    lacks it."""
    global _counted, _range, _session
    with _lock:
        if _counted is prof:
            return
        _range = getattr(_modules["torch"]._C._profiler,
                         "_RecordFunctionFast", prof.record_function)
        start = prof._run_on_profiler_start

        def run_on_profiler_start(*args, **kwargs):
            global _session
            with _lock:
                _session += 1
            return start(*args, **kwargs)

        prof._run_on_profiler_start = run_on_profiler_start
        _session += 1
        _counted = prof


class _Recording:
    """A span while the profiler runs."""

    __slots__ = ("name", "attrs", "records", "index", "request", "start",
                 "range")

    def __init__(self, name: str, attrs: Dict[str, Any]) -> None:
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Recording":
        prof = _modules[_PROFILER]
        if _counted is not prof:
            _count_starts(prof)
        records = _records.get(_session)
        if records is None:
            records = _records[_session] = []
        stack = _stack.open
        parent, request = -1, None
        if stack and stack[-1].records is records:
            parent, request = stack[-1].index, stack[-1].request
        if self.name == REQUEST:
            request = (self.attrs.get("base_seed"),
                       self.attrs.get("unpack_index"))
        self.records, self.index, self.request = records, len(records), \
            request
        records.append((self.name, 0, 0, parent, request, self.attrs))
        stack.append(self)
        self.range = _range(self.name)
        self.range.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> None:
        end = _clock()
        _stack.open.pop()
        self.range.__exit__(*exc)
        _, _, _, parent, request, attrs = self.records[self.index]
        self.records[self.index] = (self.name, self.start, end, parent,
                                    request, attrs)


def span(name: str, **attrs):
    """A context manager that records the span ``name`` with ``attrs``
    while a ``torch.profiler`` session runs, and does nothing otherwise."""
    prof = _modules.get(_PROFILER)
    if prof is None or not prof._is_profiler_enabled:
        return _OFF
    return _Recording(name, attrs)


def sessions() -> List[int]:
    """The numbers of the sessions that recorded spans, oldest first."""
    return sorted(_records)


def spans(session: Optional[int] = None) -> List[Span]:
    """The records of profiler session ``session`` (the newest by
    default), in the order the spans opened."""
    if session is None:
        if not _records:
            return []
        session = max(_records)
    return [Span(*r) for r in _records.get(session, ())]


def clear() -> None:
    """Forget every record."""
    _records.clear()
