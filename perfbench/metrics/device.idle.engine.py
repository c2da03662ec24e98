"""device.idle.engine (%): the share of the traced window in which the
device is idle and the innermost open program span is ``engine.*`` (the
runner's sweep, point, waits and accounting), each idle microsecond split
by the span open at that moment (``harness/program_spans.py``)."""

from perfbench.harness import program_spans


def read(ctx):
    return program_spans.idle_percent(ctx, "engine")
