"""mimo.device_ms_per_step (ms): the device's busy time in the traced
window (the union of its operations' intervals) over the program's
``chain.forward`` spans there (one a step, replayed or eager): the device
time one step of the MIMO chain takes; nothing where the program records
no ``chain.forward`` span or the device did no work."""

from perfbench.harness import program_spans


def read(ctx):
    steps = program_spans.count(ctx, "chain.forward")
    if not steps:
        return None
    busy = ctx.trace.busy_us()
    return busy * 1e-3 / steps if busy > 0 else None
