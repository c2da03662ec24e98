"""engine.exposed_ms_per_point (ms): a point's wall time (its start hook
to its finish hook) less the time the device was busy inside it, in the
traced window: the time a point waits on the host's accounting, syncs and
launches."""


def read(ctx):
    tr = ctx.trace
    spans = tr.spans.get("pb.point", []) if tr is not None else []
    if not spans:
        return None
    busy = tr.busy_in(spans)
    exposed = [(b - a) - u for (a, b), u in zip(spans, busy)]
    return sum(exposed) / len(exposed) * 1e-3
