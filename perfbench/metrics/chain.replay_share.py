"""chain.replay_share (share): the program's ``chain.replay`` spans (one
replay of a captured CUDA graph of ``ChainStep.step``) over its
``chain.forward`` spans (one a step, either route) in the traced window;
nothing where the program records no ``chain.replay`` span."""

from perfbench.harness import program_spans


def read(ctx):
    replays = program_spans.count(ctx, "chain.replay")
    steps = program_spans.count(ctx, "chain.forward")
    if not replays or not steps:
        return None
    return replays / steps
