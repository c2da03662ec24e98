"""A ``torch.profiler`` trace of whole sweeps, reduced to what the per-layer
metrics read: the device's operations as intervals, and the benchmark's own
spans (sweeps, points, calls) on the same clock.

The busy share's arithmetic is that of ``bin/profile_chain_torch.py:77-104``
at commit 8958300 (device time over traced wall time), with the device time
taken as the union of the device's intervals, so that operations that
overlap on two streams count once.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .spans import CALL, POINT, SWEEP

Interval = Tuple[float, float]          # (start, end) in microseconds


@dataclass
class Trace:
    """One process's traced window, in microseconds of the trace's clock."""
    window: Interval
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: Dict[str, List[Interval]] = field(default_factory=dict)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self, within: Interval = None) -> float:
        """Microseconds in which some operation ran on the device."""
        return union_length([(s, e) for _, s, e in self.device],
                            within or self.window)

    def busy_in(self, spans: List[Interval]) -> List[float]:
        """The device's busy microseconds inside each of ``spans``."""
        merged = merge([(s, e) for _, s, e in self.device])
        starts = [s for s, _ in merged]
        prefix = [0.0]
        for s, e in merged:
            prefix.append(prefix[-1] + e - s)
        out = []
        for a, b in spans:
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            j = bisect.bisect_left(starts, b)
            busy = prefix[j] - prefix[i]
            for s, e in merged[i:i + 1] + merged[max(j - 1, i + 1):j]:
                busy -= (e - s) - max(0.0, min(e, b) - max(s, a))
            out.append(busy)
        return out

    def device_us(self, name_part: str) -> float:
        """Summed device time of the operations whose name holds
        ``name_part`` (case-insensitive)."""
        part = name_part.lower()
        return sum(e - s for n, s, e in self.device if part in n.lower())


def merge(intervals: List[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same time."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals: List[Interval], within: Interval) -> float:
    lo, hi = within
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def gaps(intervals: List[Interval], within: Interval) -> List[Interval]:
    """The stretches of ``within`` that no interval covers."""
    out, end = [], within[0]
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, min(s, within[1])))
        end = max(end, e)
        if end >= within[1]:
            break
    if end < within[1]:
        out.append((end, within[1]))
    return [g for g in out if g[1] > g[0]]


def reduce_profile(prof) -> Trace:
    """A finished ``torch.profiler.profile`` as a :class:`Trace`: every
    device operation (kernels, copies, sets; not the device-side copies of
    the host's annotations) and the spans ``pb.sweep``, ``pb.point`` and
    ``pb.call``; the window runs from the first sweep's start to the last
    one's end."""
    from torch.autograd import DeviceType
    device, spans = [], {SWEEP: [], POINT: [], CALL: []}
    for ev in prof.events():
        tr = ev.time_range
        if ev.name in spans:
            # a span is also kept as a device-side annotation: not work
            if ev.device_type != DeviceType.CUDA:
                spans[ev.name].append((float(tr.start), float(tr.end)))
        elif ev.device_type == DeviceType.CUDA and \
                not getattr(ev, "is_user_annotation", False):
            device.append((ev.name, float(tr.start), float(tr.end)))
    for v in spans.values():
        v.sort()
    sweeps = spans[SWEEP]
    window = ((sweeps[0][0], sweeps[-1][1]) if sweeps else (0.0, 0.0))
    return Trace(window, device, spans)


def idle_by_host_span(trace: Trace) -> Dict[str, float]:
    """Seconds the device sat idle in the window, by what the host was
    doing at each gap's middle: inside a kernel-wrapper call (its launches
    and host work), inside a point between calls (the runner's fetch, stop
    check and accounting), inside a sweep between points, or between
    sweeps."""
    labels = [(CALL, "wrapper call"),
              (POINT, "engine between calls (fetch, stop rule, accounting)"),
              (SWEEP, "engine between points"),
              ("", "between sweeps")]
    starts = {name: [a for a, _ in trace.spans.get(name, ())]
              for name, _ in labels if name}

    def inside(name: str, t: float) -> bool:
        i = bisect.bisect_right(starts[name], t) - 1
        return i >= 0 and trace.spans[name][i][1] >= t

    out: Dict[str, float] = {}
    for s, e in gaps([(a, b) for _, a, b in trace.device], trace.window):
        mid = 0.5 * (s + e)
        for name, label in labels:
            if not name or inside(name, mid):
                out[label] = out.get(label, 0.0) + (e - s) * 1e-6
                break
    return out


def top_device_ops(trace: Trace, k: int = 10) -> List[Tuple[str, float]]:
    """The ``k`` device operations that took most time, in seconds."""
    by: Dict[str, float] = {}
    for n, s, e in trace.device:
        by[n[:96]] = by.get(n[:96], 0.0) + (e - s) * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])[:k]
