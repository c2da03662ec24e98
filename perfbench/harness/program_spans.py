"""The program's own spans in the traced window, on the trace's clock.

The program (``pyphysim_tpu_torch/tracing.py``) records its spans in
memory while a ``torch.profiler`` session runs, on
``time.perf_counter_ns``: ``engine.sweep``, ``engine.point``,
``wrapper.call``, ``engine.wait``, ``engine.account``, ``chain.draw`` and
``chain.forward``. The traced window is a run's last profiler session, so
its records are ``tracing.spans()``, the newest session's. A program
without that module records nothing, and every reader here returns None.

:func:`mapped` places the records on the trace's clock. The anchor: the
k-th ``engine.point`` of the session is the k-th ``pb.point`` of the trace
(the benchmark opens ``pb.point`` in the runner's start hook, which
``engine.point`` encloses), and every span inside that point moves by the
point's offset, ``pb.point``'s start on the trace less ``engine.point``'s
start on the program's clock. A span outside every point (``engine.sweep``)
takes its first point's offset at its start and its last point's at its
end. The anchor's error is the runner's work between reading the clock in
``engine.point`` and opening ``pb.point`` in the start hook (the hook's
call, a clock read, a ``record_function`` range): the mapped spans sit that
much late. On an H100's host their starts read 11-25 us (medians by span
and cell) after the profiler's own ranges of the same spans, which also
counts each range's entry.

:func:`idle_split` splits each idle microsecond of the device in the
traced window by the innermost program span open at that moment:
``engine.*`` is the engine, ``wrapper.call`` and ``chain.*`` the kernel
wrapper; idle time under no program span is the harness's own work.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

from .spans import POINT
from .trace import gaps

# (name, start, end, depth, point): microseconds on the trace's clock; the
# depth of the span in the program's tree; the index of its point or -1
Mapped = Tuple[str, float, float, int, int]


def records(ctx) -> Optional[list]:
    """The program's span records of the traced window, or None (no trace,
    or a program that records no spans)."""
    if ctx.trace is None:
        return None
    try:
        from pyphysim_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans() or None


def count(ctx, name: str) -> Optional[int]:
    recs = records(ctx)
    return None if recs is None else sum(s.name == name for s in recs)


def mean_ms(ctx, name: str) -> Optional[float]:
    """The mean duration of the closed spans ``name``, in ms."""
    recs = records(ctx)
    if recs is None:
        return None
    d = [s.end_ns - s.start_ns for s in recs if s.name == name and s.end_ns]
    return sum(d) / len(d) * 1e-6 if d else None


def mapped(ctx) -> Optional[List[Mapped]]:
    """The closed program spans on the trace's clock, or None where the
    program's points and the trace's ``pb.point`` spans differ in
    number."""
    recs = records(ctx)
    if recs is None:
        return None
    anchors = ctx.trace.spans.get(POINT, [])
    points = [i for i, s in enumerate(recs) if s.name == "engine.point"]
    if not points or len(points) != len(anchors):
        return None
    k_of = {i: k for k, i in enumerate(points)}
    depth: List[int] = []
    point: List[int] = []           # record index of the enclosing point
    for i, s in enumerate(recs):       # a parent opened before its child
        up = s.parent
        depth.append(depth[up] + 1 if up >= 0 else 0)
        point.append(i if i in k_of else (point[up] if up >= 0 else -1))
    offset = {i: a - recs[i].start_ns * 1e-3
              for i, (a, _) in zip(points, anchors)}
    # spans outside every point: their first and last points' offsets
    first: Dict[int, float] = {}
    last: Dict[int, float] = {}
    for i in points:
        up = recs[i].parent
        while up >= 0 and point[up] < 0:
            first.setdefault(up, offset[i])
            last[up] = offset[i]
            up = recs[up].parent
    out: List[Mapped] = []
    for i, s in enumerate(recs):
        if not s.end_ns:
            continue
        p = point[i]
        if p >= 0:
            lo = hi = offset[p]
        elif i in first:
            lo, hi = first[i], last[i]
        else:
            continue
        out.append((s.name, s.start_ns * 1e-3 + lo, s.end_ns * 1e-3 + hi,
                    depth[i], k_of[p] if p >= 0 else -1))
    return out


def innermost(spans: List[Mapped]) -> List[Tuple[float, float, str]]:
    """Disjoint, sorted ``(start, end, name)`` stretches, each named by the
    deepest span open over it (the later start where two of one depth
    overlap)."""
    events = sorted([(a, 1, i) for i, (_, a, _, _, _) in enumerate(spans)] +
                    [(b, 0, i) for i, (_, _, b, _, _) in enumerate(spans)])
    heap: List[Tuple[int, float, int]] = []
    ended = set()
    out: List[Tuple[float, float, str]] = []
    prev = None
    for t, opens, i in events:
        if prev is not None and t > prev:
            while heap and heap[0][2] in ended:
                heapq.heappop(heap)
            if heap:
                out.append((prev, t, spans[heap[0][2]][0]))
        prev = t
        if opens:
            heapq.heappush(heap, (-spans[i][3], -spans[i][1], i))
        else:
            ended.add(i)
    return out


def layer(name: str) -> str:
    if name.startswith("engine."):
        return "engine"
    if name == "wrapper.call" or name.startswith("chain."):
        return "wrapper"
    return "outside"


def idle_split(ctx) -> Optional[Dict[str, float]]:
    """The device's idle microseconds in the traced window by the layer of
    the innermost program span open then: ``engine``, ``wrapper``, and
    ``outside`` (under no program span)."""
    spans = mapped(ctx)
    if spans is None:
        return None
    tr = ctx.trace
    idle = gaps([(a, b) for _, a, b in tr.device], tr.window)
    segs = innermost(spans)
    out = {"engine": 0.0, "wrapper": 0.0}
    i = j = 0
    while i < len(idle) and j < len(segs):
        (ga, gb), (sa, sb, name) = idle[i], segs[j]
        lo, hi = max(ga, sa), min(gb, sb)
        if hi > lo and layer(name) in out:
            out[layer(name)] += hi - lo
        if gb < sb:
            i += 1
        else:
            j += 1
    out["outside"] = sum(b - a for a, b in idle) - out["engine"] - \
        out["wrapper"]
    return out


def idle_percent(ctx, which: str) -> Optional[float]:
    """``which``'s share of the traced window, in %, in which the device
    is idle (``idle_split``)."""
    split = idle_split(ctx)
    if split is None or ctx.trace.window_us <= 0:
        return None
    return 100.0 * split[which] / ctx.trace.window_us
