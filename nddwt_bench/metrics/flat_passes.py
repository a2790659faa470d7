"""The one-launch flat kernels' passes that end at a grid barrier (their
grid barriers), a step: the program's counter ``flat_passes``
(``non_decimated_wavelets_tpu_torch/ops/flat.py``), counted on the host
from each launch's plan over the traced window. None for a program
without the counter."""


def read(rec):
    try:
        from non_decimated_wavelets_tpu_torch import tracing
    except ImportError:
        return None
    passes = tracing.summary()["counters"].get("flat_passes")
    if passes is None or not rec.steps:
        return None
    return passes / rec.steps
