"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the comparison with the plain reference, the metrics and the result line.

Everything is found by name: the cell's configuration file, its traffic
file ``traffic/<traffic>.json``, the kind of unit that file names
(``kinds/<kind>.py``), the cell's correctness limits
(``limits/<workload>.json``) and a reader per metric
(``metrics/<name>.py``, or ``metrics/<prefix>.py``). Adding a cell,
configuration, traffic mix or metric adds files and entries; it edits none.

The program is the PyTorch and CUDA port, ``non_decimated_wavelets_tpu_torch``;
this package never imports the JAX package or JAX.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

from . import tracing
from .counts import PEAKS

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
PACKAGE = BENCH_DIR.name
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "non_decimated_wavelets_tpu"})
HARNESS_SPANS = frozenset({tracing.WINDOW_SPAN, "bench.sync"})
# Build and kernel caches of everything the run loads, at fixed paths inside
# the checkout, so that only a checkout's first run builds.
CACHE_DIR = ".nddwt_bench_cache"
CACHE_ENV = {
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TRITON_CACHE_DIR": "triton",
    "CUDA_CACHE_PATH": "cuda",
}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def load_module(path: Path, name: str):
    """The module at ``path``, loaded once under ``name``."""
    mod = sys.modules.get(name)
    if mod is not None and Path(getattr(mod, "__file__", "") or "").resolve() == path.resolve():
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(bench_dir: Path, metric: str):
    """The ``read`` function of a metric: ``metrics/<name>.py``, or else
    ``metrics/<prefix>.py`` for the part of the name before its first dot."""
    for stem in (metric, metric.partition(".")[0]):
        path = bench_dir / "metrics" / f"{stem}.py"
        if path.is_file():
            return load_module(path, f"{PACKAGE}.metrics.{stem.replace('.', '_')}").read
    raise FileNotFoundError(f"no reader for metric {metric!r} under {bench_dir / 'metrics'}")


def resolve(bench: dict, workload: str, root: Path = ROOT) -> SimpleNamespace:
    """Everything one cell needs, found by name from ``bench``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise ValueError(f"no workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    bench_dir = root / PACKAGE
    cfg = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    kind = load_module(bench_dir / "kinds" / f"{traffic['kind']}.py",
                       f"{PACKAGE}.kinds.{traffic['kind']}")
    limits = json.loads((bench_dir / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic, kind=kind, limits=limits, e2e=e2e, layer=layer,
        readers={m["name"]: reader(bench_dir, m["name"]) for m in e2e + layer})


class Spans:
    """The benchmark's own spans: ``(name, start, end)`` on the host's
    clock, and a ``torch.profiler.record_function`` range each while
    traced."""

    def __init__(self):
        self.records = []
        self.record_function = None

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.record_function is None:
            yield
        else:
            with self.record_function(name):
                yield
        self.records.append((name, t0, time.perf_counter()))


def run_window(kind, state, seconds: float, sync_each: bool, spans: Spans, sync,
               samples: int, rng: random.Random) -> SimpleNamespace:
    """Units back to back for at least ``seconds``. ``sync_each``: a closed
    loop of one client, each unit synchronised and its latency recorded;
    otherwise the units are issued without waiting and the window closes on
    one synchronise. ``samples`` outputs are kept for the comparison, drawn
    uniformly over the window's units by reservoir sampling from ``rng``."""
    kept, latencies, n = [], [], 0
    t0 = time.perf_counter()
    while True:
        start = time.perf_counter()
        out, index = kind.unit(state, n, spans)
        if sync_each:
            with spans("bench.sync"):
                sync()
            latencies.append(time.perf_counter() - start)
        if n < samples:
            kept.append((n, index, out))
        else:
            j = rng.randrange(n + 1)
            if j < samples:
                kept[j] = (n, index, out)
        del out
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if not sync_each:
        with spans("bench.sync"):
            sync()
    return SimpleNamespace(window_s=time.perf_counter() - t0, units=n,
                           latencies_s=latencies, kept=kept)


def rel_max_err(out, ref) -> float:
    """``max |out - ref| / max |ref|``."""
    return float((out.to(ref.dtype) - ref).abs().max() / ref.abs().max())


def compare(kind, state, kept, control: bool = False) -> dict:
    """The widest relative gap of the kept outputs from the float64
    reference of their inputs (``err_max``); with ``control``, also that of
    the control (the kind's own lower-precision path, or the reference in
    bfloat16) on the same inputs (``control_err_max``)."""
    errs, ctrl = [], []
    for index in sorted({i for _, i, _ in kept}):
        ref = kind.reference(state, index, "float64")
        errs += [rel_max_err(out, ref) for _, i, out in kept if i == index]
        if control:
            low = (kind.control(state, index) if hasattr(kind, "control")
                   else kind.reference(state, index, "bfloat16"))
            ctrl.append(rel_max_err(low, ref))
            del low
        del ref
    out = {"err_max": math.nan if any(e != e for e in errs) else max(errs), "errs": errs}
    if control:
        out["control_err_max"] = max(ctrl)
    return out


def _free(cuda: bool) -> None:
    gc.collect()
    if cuda:
        import torch

        torch.cuda.empty_cache()


def _power_limit_w():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "--id=0"], capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def prepare(c: SimpleNamespace, seed: int, device: str):
    """Set-up of a cell: the program loaded (its kernels built where this
    checkout has not built them yet), the inputs made from ``seed`` and the
    cell's own shapes warmed up by ``warm_units`` units. Returns the
    context, the kind's state, the synchronise and the seconds of each
    phase."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phases, t = {}, time.perf_counter()
    if cuda:
        from non_decimated_wavelets_tpu_torch.ops import cuda_kernels

        torch.cuda.init()
        cuda_kernels.build()
        for name in cuda_kernels.SOURCES:
            cuda_kernels.library(name)
        phases["build_and_load_s"], t = time.perf_counter() - t, time.perf_counter()
    ctx = SimpleNamespace(cfg=c.cfg, traffic=c.traffic, seed=seed, device=dev)
    state = c.kind.setup(ctx)
    sync()
    phases["inputs_s"], t = time.perf_counter() - t, time.perf_counter()
    spans = Spans()
    for i in range(c.traffic["warm_units"]):
        c.kind.unit(state, i, spans)
        sync()
    phases["warm_s"] = time.perf_counter() - t
    return ctx, state, sync, phases


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             root: Path = ROOT) -> tuple:
    """One run of a cell; returns the result line (a dict) and the lines of
    the comparison for standard error."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = resolve(bench, workload, root)
    import torch

    import non_decimated_wavelets_tpu_torch as program
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels

    imported_s = time.perf_counter() - t_start
    ctx, state, sync, phases = prepare(c, seed, device)
    cuda = ctx.device.type == "cuda"
    cuda_kernels.reset_launch_counts()
    spans = Spans()
    rng = random.Random(seed)
    sync_each = c.traffic["sync"] == "unit"
    samples = c.traffic["check_samples"]

    def window():
        return run_window(c.kind, state, seconds, sync_each, spans, sync, samples, rng)

    setup_s = time.perf_counter() - t_start
    summary = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        spans.record_function = record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(tracing.WINDOW_SPAN):
                w = window()
        spans.record_function = None
        summary = tracing.reduce(tracing.events(prof))
        del prof
    else:
        w = window()
    launches = {k: v for k, v in cuda_kernels.launch_counts.items() if v}
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0

    c.kind.release(state)
    _free(cuda)
    t_compare = time.perf_counter()
    checks = compare(c.kind, state, w.kept)
    compare_s = time.perf_counter() - t_compare
    w.kept.clear()
    _free(cuda)

    rec = SimpleNamespace(
        setup_s=setup_s, window_s=w.window_s, units=w.units,
        steps=w.units * c.kind.steps_per_unit(ctx), latencies_s=w.latencies_s,
        voxels_per_unit=c.kind.voxels_per_unit(ctx), work=c.kind.work(ctx),
        peaks=PEAKS.get(torch.cuda.get_device_name(ctx.device)) if cuda else None,
        spans=spans.records, harness_spans=HARNESS_SPANS, launches=launches,
        program_kernels=tracing.program_kernels(Path(program.__file__).parent),
        trace=summary, notes={}, metric=None)
    metrics = {}
    for m in (c.layer if trace else c.e2e):
        rec.metric = m["name"]
        value = c.readers[m["name"]](rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    limit = c.limits["err_max"]["limit"]
    failed = sum(not err <= limit for err in checks["errs"])  # NaN fails
    correct = failed == 0
    dev = {"platform": "gpu" if cuda else ctx.device.type,
           "kind": torch.cuda.get_device_name(ctx.device) if cuda else ctx.device.type,
           "count": c.cell["chips"] if cuda else 0, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    line = {"correct": correct, "attempted": w.units,
            "failed": failed,
            "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = tracing.breakdown(summary)
    notes = dict(rec.notes, seed=seed, units=w.units, launches=launches,
                 samples_compared=len(checks["errs"]), compare_s=compare_s,
                 setup_phases=dict(import_s=imported_s, **phases))
    if cuda:
        notes["power_limit_w"] = _power_limit_w()
    line["notes"] = notes
    line["checks"] = {"err_max": {"value": checks["err_max"], "limit": limit}}
    err_lines = [f"compared {len(checks['errs'])} outputs with the float64 reference",
                 f"err_max {checks['err_max']!r} limit {limit!r}"]
    return line, err_lines


def set_cache_dirs(root: Path = ROOT) -> None:
    """Point every build and kernel cache at its fixed directory inside the
    checkout."""
    for var, sub in CACHE_ENV.items():
        path = root / CACHE_DIR / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: "
              "the benchmark runs on the card only", file=sys.stderr)
        return 1
    torch.set_num_threads(2)
    line, err_lines = run_cell(bench, args.workload, args.seed, args.seconds,
                               bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for text in err_lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
