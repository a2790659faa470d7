"""Reduction of a ``torch.profiler`` trace of the measured window.

The device's busy time is the union of the intervals in which an operation
ran on the device (``merged``, as ``chip_profile.busy_time`` computes it); its
time by operation name sums their lengths; the idle gaps are the parts of
the window where nothing ran there, each labelled by the benchmark's span
that was open on the host at the gap's middle (``bench.harness`` where
none was: the harness's own loop).
"""

from __future__ import annotations

import bisect
import re
from pathlib import Path
from types import SimpleNamespace

WINDOW_SPAN = "bench.window"
OUTSIDE_SPANS = "bench.harness"
TOP = 10  # entries of each list in the breakdown
_NEST = 4  # the deepest the benchmark nests its spans


_CUDA_KERNEL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_TRITON_KERNEL = re.compile(r"@triton\.jit[^\n]*\n\s*def\s+(\w+)\s*\(")


def program_kernels(package_dir: Path) -> frozenset:
    """The names of the kernels the program defines itself: every
    ``__global__`` function of its CUDA sources and every ``@triton.jit``
    function of its Python files."""
    names = set()
    for pattern, globs in ((_CUDA_KERNEL, ("*.cu", "*.cuh")), (_TRITON_KERNEL, ("*.py",))):
        for glob in globs:
            for path in package_dir.rglob(glob):
                names.update(pattern.findall(path.read_text(errors="replace")))
    return frozenset(names)


def is_program_kernel(op: str, kernels: frozenset) -> bool:
    """Whether a device operation's (demangled) name is one of ``kernels``,
    in no namespace but an anonymous one: ``void (anonymous
    namespace)::stream_syn_kernel<float, 8, float>(...)`` is
    ``stream_syn_kernel``; ``void at::native::...`` is PyTorch's."""
    name = op.replace("(anonymous namespace)::", "").removeprefix("void ").strip()
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return "::" not in name and name in kernels


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones
    (the union that ``chip_profile.busy_time`` measures)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def events(prof) -> list:
    """``(name, on_device, start_ns, end_ns)`` of every event of ``prof``,
    the device side's copies of the host's annotations left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        dev = ev.device_type() == cuda
        if dev and (ev.is_user_annotation() or ev.name().startswith("bench.")):
            continue
        out.append((ev.name(), dev, ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return out


def reduce(evs) -> SimpleNamespace:
    """Busy seconds, window seconds, device seconds by name and the idle
    gaps by label, from ``events()`` of a profile whose window is the
    host's ``bench.window`` span."""
    win = [(s, e) for name, dev, s, e in evs if not dev and name == WINDOW_SPAN]
    w0, w1 = (win[0] if win else (min((s for *_, s, _ in evs), default=0),
                                  max((e for *_, e in evs), default=0)))
    dev = [(name, max(s, w0), min(e, w1)) for name, on_dev, s, e in evs
           if on_dev and e > w0 and s < w1]
    by_name = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    busy = merged([(s, e) for _, s, e in dev])
    spans = sorted((s, e, name) for name, on_dev, s, e in evs
                   if not on_dev and name.startswith("bench.") and name != WINDOW_SPAN)
    starts = [s for s, _, _ in spans]
    gaps, prev = {}, w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            mid = 0.5 * (prev + s)
            label = OUTSIDE_SPANS
            # The innermost span open at the middle: the latest one that
            # starts before it and has not ended (spans nest a few deep).
            last = bisect.bisect_right(starts, mid) - 1
            for i in range(last, max(last - _NEST, -1), -1):
                if spans[i][1] >= mid:
                    label = spans[i][2]
                    break
            total, count = gaps.get(label, (0.0, 0))
            gaps[label] = (total + (s - prev) * 1e-9, count + 1)
        prev = max(prev, e)
    return SimpleNamespace(
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        window_s=(w1 - w0) * 1e-9,
        by_name=by_name,
        gaps=gaps,
    )


def breakdown(summary: SimpleNamespace) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the idle time by what the host was doing."""
    ops = sorted(summary.by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(summary.gaps.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "device_ops": [[name[:160], secs] for name, secs in ops],
        "idle_gaps": [[f"{label} ({count} gaps)", total]
                      for label, (total, count) in gaps],
    }
