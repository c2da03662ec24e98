"""kernel.roofline.mc_ofdm_tdl (%): the least time the traced calls'
flagship work needs (``harness/work.py``, from each call's attempts, the
traffic's tiles and the configuration's taps, rays and bins) over the
device time of the ``mc_ofdm_tdl`` kernels in the trace."""

from perfbench.harness import work


def read(ctx):
    if ctx.trace is None:
        return None
    geo, wl = ctx.geometry(), ctx.workload
    busy = ctx.trace.device_us("mc_ofdm_tdl") * 1e-6
    need = sum(work.mc_least_seconds(n, int(wl["tiles"]), int(wl["tile"]),
                                     geo.taps, geo.rays, geo.used)
               for n in ctx.traced_calls)
    share, found = work.share_percent(need, busy)
    return share if found else None
