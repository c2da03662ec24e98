"""kernel.roofline.sc_mmse_eq (%): the least time the traced calls'
equalization needs (``harness/pusch_work.py``: each call's attempts times
the traffic's ``symbols`` data REs a layer on the configuration's used
subcarriers, H and the data symbols' y read once, x and the gain sums
written once, and the fewest float32 operations of the Gram, its factors,
W's solves, the gains and W y at the configuration's antennas) over the
device time of the ``sc_mmse_eq`` kernels in the trace; nothing where no
such kernel ran."""

from perfbench.harness import pusch_work, work


def read(ctx):
    if ctx.trace is None:
        return None
    cfg = ctx.config
    busy = ctx.trace.device_us("sc_mmse_eq") * 1e-6
    need = sum(pusch_work.equalize_least_seconds(
        n, int(ctx.workload["symbols"]), int(cfg["ofdm"]["num_used"]),
        int(cfg["num_rx"]), int(cfg["num_tx"])) for n in ctx.traced_calls)
    share, found = work.share_percent(need, busy)
    return share if found else None
