"""pusch.equalize_share (%): the device time of the ``sc_mmse_eq`` kernels
(the SC-FDMA MMSE equalizer) over the device's busy time (the union of its
operations' intervals) in the traced window; nothing where no equalizer
ran on the device."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    busy, equalize = tr.busy_us(), tr.device_us("sc_mmse_eq")
    if busy <= 0 or equalize <= 0:
        return None
    return 100.0 * equalize / busy
