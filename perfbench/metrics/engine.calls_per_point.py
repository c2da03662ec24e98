"""engine.calls_per_point (calls): the app's ``chunks_dispatched`` counter
(kernel callable calls: bulk kernel calls, or per-key sub-chunk steps) over
the points the measured loop ran, whole sweeps."""


def read(ctx):
    points = len(ctx.host["points"])
    calls = ctx.host["counters"]["chunks_dispatched"]
    return calls / points if points else None
