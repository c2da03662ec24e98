"""engine.overlap_share (share): the program's ``engine.overlap`` spans
(the per-key executor's host outputs of a sub-chunk, built after the next
sub-chunk was dispatched, so while the device runs it) over its
``wrapper.call`` spans (one a call of the kernel callable) in the traced
window; nothing where the program records no ``engine.overlap`` span."""

from perfbench.harness import program_spans


def read(ctx):
    overlaps = program_spans.count(ctx, "engine.overlap")
    calls = program_spans.count(ctx, "wrapper.call")
    if not overlaps or not calls:
        return None
    return overlaps / calls
