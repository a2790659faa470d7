"""Host time a launch of the program's own kernels, in us: the spans
``nddwt.launch.<kernel>`` around each launch's host work (geometry,
allocations, the call and its error check;
``non_decimated_wavelets_tpu_torch.tracing``) over their calls in the
traced window. The notes give the launches a step. None for a program
without spans, or a window without launches."""


def read(rec):
    try:
        from non_decimated_wavelets_tpu_torch import tracing
    except ImportError:
        return None
    launches = [v for name, v in tracing.summary()["spans"].items()
                if name.startswith("nddwt.launch.")]
    calls = sum(v["calls"] for v in launches)
    if not calls or not rec.steps:
        return None
    rec.notes[f"{rec.metric} launches a step"] = calls / rec.steps
    return 1e-3 * sum(v["total_ns"] for v in launches) / calls
