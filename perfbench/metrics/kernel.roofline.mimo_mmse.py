"""kernel.roofline.mimo_mmse (%): the least time the traced calls'
detection needs (``harness/mimo_work.py``: each call's attempts times the
traffic's ``symbols`` resource elements, H, y and the sent indices read
once, the counts written once, and the fewest float32 operations of the
Gram, H^H y, the solve and the decision at the configuration's antennas)
over the device time of the ``mimo_mmse`` kernels in the trace."""

from perfbench.harness import mimo_work, work


def read(ctx):
    if ctx.trace is None:
        return None
    cfg = ctx.config
    busy = ctx.trace.device_us("mimo_mmse") * 1e-6
    need = sum(mimo_work.mmse_least_seconds(
        n, int(ctx.workload["symbols"]), int(cfg["num_rx"]),
        int(cfg["num_tx"])) for n in ctx.traced_calls)
    share, found = work.share_percent(need, busy)
    return share if found else None
