"""point_ms_p95 (ms): the 95th percentile of the time of every point that
finished in the window, from its start hook to its finish hook."""

from perfbench.harness import stats


def read(ctx):
    seconds = stats.point_seconds(ctx.host)
    return stats.percentile(seconds, 95) * 1e3 if seconds else None
