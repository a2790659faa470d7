"""The bytes that the one-launch flat kernels' passes copy into
shared-memory windows, halos included, a step, in MB: the program's
counter ``flat_window_bytes`` (``non_decimated_wavelets_tpu_torch/ops/
flat.py``), counted on the host from each launch's plan over the traced
window. None for a program without the counter."""


def read(rec):
    try:
        from non_decimated_wavelets_tpu_torch import tracing
    except ImportError:
        return None
    copied = tracing.summary()["counters"].get("flat_window_bytes")
    if copied is None or not rec.steps:
        return None
    return copied / 1e6 / rec.steps
