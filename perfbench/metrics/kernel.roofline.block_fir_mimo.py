"""kernel.roofline.block_fir_mimo (%): the least time the traced MIMO
steps' block FIR needs (``harness/mimo_work.py`` ``fir_rows``: a row for
each attempt, OFDM symbol and antenna pair, of fft + cp samples,
convolved with the configuration's taps, priced by ``harness/work.py``)
over the device time of the ``block_fir`` kernels in the trace."""

from perfbench.harness import mimo_work, work


def read(ctx):
    if ctx.trace is None:
        return None
    geo, cfg = ctx.geometry(), ctx.config
    busy = ctx.trace.device_us("block_fir") * 1e-6
    need = sum(work.fir_least_seconds(
        mimo_work.fir_rows(n, int(ctx.workload["symbols"]), geo.used,
                           int(cfg["num_rx"]), int(cfg["num_tx"])),
        geo.spb, list(geo.delays)) for n in ctx.traced_calls)
    share, found = work.share_percent(need, busy)
    return share if found else None
