"""wrapper.host_ms_per_call (ms): the host's time inside one call of the
kernel callable (the bulk kernel wrapper, or one per-key chain step),
without a sync, mean over the measured window's calls."""


def read(ctx):
    calls = [(t1 - t0) for t0, t1, _, _, _ in ctx.host["calls"]
             if t0 < ctx.host["t_end"]]
    return sum(calls) / len(calls) * 1e3 if calls else None
