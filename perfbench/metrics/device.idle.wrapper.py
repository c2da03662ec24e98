"""device.idle.wrapper (%): the share of the traced window in which the
device is idle and the innermost open program span is ``wrapper.call`` or
``chain.*`` (the kernel callable: the bulk kernel's wrapper, or the
per-key chain step), each idle microsecond split by the span open at that
moment (``harness/program_spans.py``)."""

from perfbench.harness import program_spans


def read(ctx):
    return program_spans.idle_percent(ctx, "wrapper")
