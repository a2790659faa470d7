"""The device's idle share of the traced window, ``1 - busy / window``, in
%, the busy time being the union of the intervals in which an operation ran
on the device."""


def read(rec):
    if rec.trace is None or rec.trace.busy_s <= 0 or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
