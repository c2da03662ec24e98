"""chain.forward_ms_per_step (ms): the mean host time of the program's
``chain.forward`` spans (``ChainStep.step``'s ``forward``: its launches,
without a sync) in the traced window."""

from perfbench.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "chain.forward")
