"""The window's wall time over the slices' steps completed in it, in ms."""


def read(rec):
    return 1e3 * rec.window_s / rec.units if rec.units else None
