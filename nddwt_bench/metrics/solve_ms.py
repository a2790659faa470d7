"""The window's wall time over the solves completed in it, in ms (the
window closes at the end of a solve)."""


def read(rec):
    return 1e3 * rec.window_s / rec.units if rec.units else None
