"""Host-clock time a step inside the benchmark's spans around its calls into
the program (no synchronise inside them), in ms."""


def read(rec):
    if not rec.steps:
        return None
    inside = sum(t1 - t0 for name, t0, t1 in rec.spans if name not in rec.harness_spans)
    return 1e3 * inside / rec.steps
