"""chain.draw_ms_per_step (ms): the mean host time of the program's
``chain.draw`` spans (``ChainStep.step``'s stream split and its data,
channel-state and noise draws) in the traced window."""

from perfbench.harness import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "chain.draw")
