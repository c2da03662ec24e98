"""device.idle (%): 1 - the time some operation ran on the device over the
traced window's wall time."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
