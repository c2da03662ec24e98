"""engine.deferred_share (share): the program's ``engine.deferred`` spans
(a chunk's bookkeeping run after the next chunk was dispatched, so while
the device runs it) over its ``engine.account`` spans (one a chunk booked)
in the traced window; 0.0 where chunks are booked and none after the next
dispatch, nothing where the program records no ``engine.account`` span."""

from perfbench.harness import program_spans


def read(ctx):
    accounts = program_spans.count(ctx, "engine.account")
    if not accounts:
        return None
    return program_spans.count(ctx, "engine.deferred") / accounts
