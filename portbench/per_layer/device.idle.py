"""``device.idle``: the share of the traced window in which no device
operation (kernel, copy or memset) ran."""


def read(run):
    tr = run.trace
    return 100.0 * (1.0 - tr.busy_us / tr.window_us) if tr.window_us > 0 else None
