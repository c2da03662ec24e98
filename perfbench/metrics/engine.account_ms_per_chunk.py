"""engine.account_ms_per_chunk (ms): the mean host time of the program's
``engine.account`` spans (the runner's ``_consume_chunk``: a chunk's
accept-prefix, skip count and Result merging) in the traced window."""

from perfbench.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "engine.account")
