"""Host time a step of the program's public calls, in ms: the spans
``nddwt.<op>.<route>.L<level>`` that the plan opens around each call
(``non_decimated_wavelets_tpu_torch.tracing``), those nested in another
such span left out, over the traced window. The notes give every span's
calls and self time a step, by name. None for a program without spans."""

import re

_ENTRY = re.compile(r"nddwt\.[a-z_]+\.[a-z]+\.L\d+")


def read(rec):
    try:
        from non_decimated_wavelets_tpu_torch import tracing
    except ImportError:
        return None
    if not rec.steps:
        return None
    traced = tracing.summary()
    outer = [v["total_ns"] for path, v in traced["paths"].items()
             if _ENTRY.fullmatch(path[-1])
             and not any(_ENTRY.fullmatch(name) for name in path[:-1])]
    if not outer:
        return None
    rec.notes[f"{rec.metric} spans a step"] = {
        name: {"calls": v["calls"] / rec.steps, "self_ms": 1e-6 * v["self_ns"] / rec.steps}
        for name, v in sorted(traced["spans"].items())}
    return 1e-6 * sum(outer) / rec.steps
