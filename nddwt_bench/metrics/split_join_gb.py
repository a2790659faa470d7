"""Bytes a step that the program's copies between complex and re/im form
read and write (the split of complex inputs, the join of the results, the
gather of per-component results), in GB: its counter ``split_join_bytes``
(``non_decimated_wavelets_tpu_torch.tracing``), counted from tensor sizes
over the traced window. None for a program without the counter."""


def read(rec):
    try:
        from non_decimated_wavelets_tpu_torch import tracing
    except ImportError:
        return None
    moved = tracing.summary()["counters"].get("split_join_bytes")
    if moved is None or not rec.steps:
        return None
    return moved / 1e9 / rec.steps
