"""mimo.detect_share (%): the device time of the ``mimo_mmse`` kernels
(the per-RE MMSE detector) over the device's busy time (the union of its
operations' intervals) in the traced window; nothing where no detector
ran on the device."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    busy, detect = tr.busy_us(), tr.device_us("mimo_mmse")
    if busy <= 0 or detect <= 0:
        return None
    return 100.0 * detect / busy
