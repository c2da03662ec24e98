"""engine.syncs_per_point (syncs): the program's ``engine.wait`` spans
(each statement of the runner's ``_to_host`` that waits for the device: an
event's ``synchronize`` or a tensor's ``.cpu()``) over its ``engine.point``
spans, in the traced window (``harness/program_spans.py``)."""

from perfbench.harness import program_spans


def read(ctx):
    points = program_spans.count(ctx, "engine.point")
    if not points:
        return None
    return program_spans.count(ctx, "engine.wait") / points
