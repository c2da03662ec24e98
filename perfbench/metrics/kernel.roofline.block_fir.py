"""kernel.roofline.block_fir (%): the least time the traced per-key
steps' block FIR needs (``harness/work.py``: each step's rows, one a
transmitted OFDM symbol of each attempt, of fft + cp samples, convolved
with the configuration's taps) over the device time of the ``block_fir``
kernels in the trace."""

from perfbench.harness import work


def read(ctx):
    if ctx.trace is None:
        return None
    geo, wl = ctx.geometry(), ctx.workload
    n_ofdm = int(wl["symbols"]) // geo.used
    busy = ctx.trace.device_us("block_fir") * 1e-6
    need = sum(work.fir_least_seconds(n * n_ofdm, geo.spb, list(geo.delays))
               for n in ctx.traced_calls)
    share, found = work.share_percent(need, busy)
    return share if found else None
