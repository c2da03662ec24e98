"""point_ms (ms): the time to one BER point at the stated accuracy, the
window's milliseconds over the points that finished in it."""

from perfbench.harness import stats


def read(ctx):
    done = len(stats.point_seconds(ctx.host))
    return ctx.host["seconds"] * 1e3 / done if done else None
