"""Seconds from the process's start to the first timed unit: imports, the
kernel libraries loaded (built in a checkout's first run), the inputs made
and the cell's own shapes warmed up."""


def read(rec):
    return rec.setup_s
