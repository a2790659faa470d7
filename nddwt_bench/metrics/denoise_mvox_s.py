"""The voxels of all calls completed in the window over its wall time, in
millions a second (the window closes on a synchronise)."""


def read(rec):
    return rec.units * rec.voxels_per_unit / rec.window_s / 1e6 if rec.units else None
