"""sym_rate (sym/s): 16-QAM symbols simulated in every call whose counts
reached the host inside the window, over the window's seconds."""

from perfbench.harness import stats


def read(ctx):
    return stats.window_symbols(ctx.host) / ctx.host["seconds"]
