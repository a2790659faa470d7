"""Spans and counters at the port's layer boundaries.

The counterpart of ``non_decimated_wavelets_tpu/utils/profiling.
trace_annotated``: the plan, the level loops and the solvers open a named
span at each boundary (``span``) and count what they move (``count``).
Timing the calls is the caller's job, so ``Timer`` and
``throughput_report`` have no counterpart here.

Tracing is on while a ``torch.profiler`` window records
(``torch.autograd.profiler._is_profiler_enabled``) and between
``enable()`` and ``disable()``. Off, ``span`` costs one flag test and
returns one shared null context: no clock read, no allocation, no profiler
call. On, a span reads ``time.perf_counter_ns()`` at entry and exit and
adds its time to in-memory aggregates keyed by its path, the names of the
spans open around it and its own: calls, total ns and self ns (the total
less the time of its direct child spans). While a profiler records, a span
also opens a ``torch._C._profiler._RecordFunctionFast`` range of its name:
a host operation on the profiler's clock, to which the kernels launched
inside it are correlated, and which (unlike ``record_function``'s user
annotations) has no copy on the device's timeline. The timeline is the
profiler's; nothing here keeps a list of events.

Span names (``PERF.md`` lists the metric that reads each):

* ``nddwt.<op>.<route>.L<level>``: one public call of the plan
  (``NDDWT.route`` names the route, ``entry`` the span);
* ``nddwt.split``, ``nddwt.join``: a copy between complex and re/im form,
  or one that gathers per-component results; each adds the bytes it reads
  and writes to the counter ``split_join_bytes``;
* ``nddwt.launch.<kernel>``: the host work of one launch of a hand-written
  kernel (geometry, allocations, the call and its error check), one call
  per count in ``ops.cuda_kernels.launch_counts``;
* ``nddwt.solve.iter``, with ``nddwt.solve.data``, ``nddwt.solve.prox``
  and ``nddwt.solve.momentum`` inside it: one iteration of
  ``models.fista_cs_mri``;
* ``nddwt.<solver>.<route>.L<level>``: one whole ``models.fista_inpaint``
  or ``fista_inpaint_split`` solve, the route ``flat`` (one
  ``nddwt_flat_iter`` launch), ``stepped`` or, on the generic loop, that
  of its transforms (``NDDWT.route``; ``sharded`` for a ``ShardedNDDWT``).

Counters of the one-launch flat kernels (``ops/flat.py``), counted on the
host from the plan each launch is given: ``flat_passes``, the passes of a
launch that end at a grid barrier (its grid barriers), and
``flat_window_bytes``, the bytes its passes copy into shared-memory
windows, halos included.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext

import torch
import torch.autograd.profiler as _profiler

_NULL = nullcontext()
_enabled = False
_lock = threading.Lock()
_local = threading.local()
_paths: dict = {}  # path of names -> [calls, total_ns, self_ns]
_counters: dict = {}


def enable() -> None:
    """Turn tracing on outside a profiler window."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn off what ``enable`` turned on (a profiler window keeps tracing
    on while it records)."""
    global _enabled
    _enabled = False


class _Span:
    __slots__ = ("name", "path", "t0", "child_ns", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.path = (stack[-1].path if stack else ()) + (self.name,)
        self.child_ns = 0
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += dt
        with _lock:
            agg = _paths.get(self.path)
            if agg is None:
                agg = _paths[self.path] = [0, 0, 0]
            agg[0] += 1
            agg[1] += dt
            agg[2] += dt - self.child_ns
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one crossing of a layer boundary. It
    yields the span while tracing is on and None while it is off, so that a
    caller computes what it counts only when the count is kept."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


def entry(op: str, route: str, level: int):
    """The span of one public call or solve, ``nddwt.<op>.<route>.L<level>``;
    the route ``iter`` (a whole call in one ``nddwt_flat_iter`` launch) is
    named for its kernels, ``flat``. Off, it formats no name."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(f"nddwt.{op}.{'flat' if route == 'iter' else route}.L{int(level)}")


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _enabled or _profiler._is_profiler_enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def summary() -> dict:
    """What was recorded since the last ``reset``: ``spans``, per name
    ``{"calls", "total_ns", "self_ns"}``; ``paths``, the same per path (a
    tuple of the names open, outermost first); ``counters``."""
    with _lock:
        paths = {p: dict(zip(("calls", "total_ns", "self_ns"), v))
                 for p, v in _paths.items()}
        counters = dict(_counters)
    spans = {}
    for p, v in paths.items():
        agg = spans.setdefault(p[-1], dict.fromkeys(v, 0))
        for key, val in v.items():
            agg[key] += val
    return {"spans": spans, "paths": paths, "counters": counters}


def reset() -> None:
    """Clear the aggregates and counters."""
    with _lock:
        _paths.clear()
        _counters.clear()
