#!/usr/bin/env python3
"""Time the one-launch kernels against the per-level route on one GPU.

    python3 chip_flat_crossover.py

Where ``ops/flat.py``'s and ``ops/multi.py``'s size limits come from. For
element counts 2^12, 2^14, ..., 2^22 in 1D, 2D, 3D and 4D (db4, L3,
float32, shapes as near cubic as powers of two allow), the ``dec_rec``
iterate (threshold 0.1) on the flat kernel (one ``nddwt_flat_pair``
launch) and on the per-level route (L analysis and L synthesis launches),
in turns: per-level, flat, flat, per-level; in 2D and 3D at every power of
two, and also on the multilevel kernels (one ``nddwt_dec_multi`` and one
``nddwt_rec_multi``), per-level, flat, multi, multi, flat, per-level. The same from 2^16 up for
what the flat kernel's cost depends on besides the count: float64 in
1D-4D, long filters (db10, db20, whose 3D per-level route is the stage
kernels; 128^3 db20 L2 among them) and five levels. Then a 20-iteration 2D
``fista_inpaint`` (preserve_l2, lam 0.05, 40 % sampling), real and split
(the pair's two components counted), as one ``nddwt_flat_iter`` launch
against the stepped routes: a flat pair and a ``fista_step`` per
iteration, and the per-level kernels and a ``fista_step`` (2L + 1
launches). Then batches of N = 2 (a complex array's or split pair's two
parts) and N = 8 (a multi-coil slice) items of 2^12 ... 2^22 elements in 2D
and 3D (db4 L3 f32; 8 x 256^2 and 8 x 64^3 among them), ``dec_batched`` +
``rec_batched``: one multilevel launch per direction against N flat
launches and N per-level chains per direction, where ``ops/multi.py``'s
limit comes from. The route of every run is held to its launch counts.

Times are CUDA-event means over repeated calls after warm-up, host time
between launches included: a caller's loop pays it. The last line is a
JSON object with the tables and, per table, the largest count at which
the one-launch kernel was no slower at every smaller count too, and, for
the multilevel kernels, the counts at which they were at least 10 % faster
than the flat kernel and, per batch table, the largest item up to which
they were no slower than the per-level route. Exits non-zero without a
CUDA device.
"""

import contextlib
import json
import sys

SIZES = tuple(2**k for k in range(12, 23, 2))
LARGE = SIZES[2:]
ALL_SIZES = tuple(2**k for k in range(12, 23))  # where the multilevel kernels run
DIMS = (1, 2, 3, 4)
LEVEL, THRESHOLD = 3, 0.1
# The dec_rec tables: (ndim, wavelet, level, dtype, element counts); the
# multilevel kernels run in the 2D and 3D db4 ones (MULTI_FAMILIES) too, at
# every power of two.
FAMILIES = (
    *((d, "db4", LEVEL, "float32", ALL_SIZES if d in (2, 3) else SIZES) for d in DIMS),
    *((d, "db4", LEVEL, "float64", LARGE) for d in DIMS),
    (2, "db20", 2, "float32", LARGE),
    (3, "db10", LEVEL, "float32", LARGE),
    (3, "db20", 2, "float32", (2**18, 2**20, 2**21, 2**22)),
    (3, "db4", 5, "float32", LARGE),
)
MULTI_FAMILIES = ((2, "db4", LEVEL, "float32"), (3, "db4", LEVEL, "float32"))
BATCHES = (2, 8)  # a complex array's or split pair's parts; a multi-coil slice
ITERS, LAM, SAMPLING = 20, 0.05, 0.4
BIG = 2**62
# The limits that put a call on each route: (flat, one-launch solve, multi).
ROUTES = {"per-level": (0, 0, 0), "flat": (BIG, BIG, 0), "multi": (0, 0, BIG)}
WANT = {"flat": {"nddwt_flat_pair": 1},
        "multi": {"nddwt_dec_multi": 1, "nddwt_rec_multi": 1}}


def cube(numel, ndim):
    """A shape of ``numel`` (a power of two) elements, as near cubic as
    powers of two allow, the larger extents first."""
    k = numel.bit_length() - 1
    return tuple(2 ** (k // ndim + (a < k % ndim)) for a in range(ndim))


def timed(fn, reps, warm=2):
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def limits(flat_max, iter_max, multi_max):
    """Route through these size limits for the duration: ``ops/flat.py``'s
    (the flat kernel, the one-launch solve) and ``ops/multi.py``'s (the
    multilevel kernels); 0 switches a route off."""
    from non_decimated_wavelets_tpu_torch.ops import flat, multi

    names = ((flat, "FLAT_MAX_NUMEL"), (flat, "ITER_MAX_NUMEL"),
             (multi, "MULTI_MAX_NUMEL"))
    old = [getattr(mod, name) for mod, name in names]
    for (mod, name), value in zip(names, ({None: flat_max}, iter_max, multi_max)):
        setattr(mod, name, value)
    try:
        yield
    finally:
        for (mod, name), value in zip(names, old):
            setattr(mod, name, value)


def launches(fn):
    """The kernels one call of ``fn`` launches, by name (nonzero only)."""
    import torch

    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    return {k: v for k, v in ck.launch_counts.items() if v}


def crossover_limit(rows, a, b):
    """The largest count up to which route ``a`` was no slower than ``b``
    at every measured count (0 if it was slower at the first)."""
    best = 0
    for row in sorted(rows, key=lambda r: r["numel"]):
        if row[a] > row[b]:
            break
        best = row["numel"]
    return best


def faster_from(rows, a, b, by):
    """The smallest count from which route ``a`` took at most ``by`` times
    ``b``'s time at every larger measured count too (None if not at the
    largest)."""
    best = None
    for row in sorted(rows, key=lambda r: -r["numel"]):
        if row[a] > by * row[b]:
            break
        best = row["numel"]
    return best


def measure(log=print, max_reps=200):
    """Run both tables on the current CUDA device, at most ``max_reps``
    timed calls per run; return them with the crossovers."""
    import torch

    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch.models import (
        fista_inpaint, fista_inpaint_split)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def check(shape, route, got):
        """The launches of one call on ``route``: its own kernels only."""
        if route in WANT and got != WANT[route]:
            raise RuntimeError(f"{shape} {route} route launched {got}")
        if route == "per-level" and any(
                "flat" in k or "multi" in k for k in got):
            raise RuntimeError(f"{shape} per-level route launched {got}")

    pairs = []
    log(f"dec_rec, threshold {THRESHOLD}: ms per call, per-level | flat "
        "[| multi | multi] | flat | per-level")
    for ndim, wv, level, dtype, sizes in FAMILIES:
        family = f"{ndim}D {wv} L{level} {dtype}"
        routes = ("per-level", "flat") + (
            ("multi",) if (ndim, wv, level, dtype) in MULTI_FAMILIES else ())
        for numel in sizes:
            shape = cube(numel, ndim)
            plan = tw.NDDWT(wv, shape, dtype=dtype, device=dev)
            x = torch.randn(shape, generator=gen, device=dev).to(plan.real_dtype)

            def step():
                return plan.dec_rec(x, level, threshold=THRESHOLD, band_axis=0)

            reps = max(5, min(max_reps, 2**24 // (numel * 8)))
            times = {}
            for route in routes + routes[::-1]:
                with limits(*ROUTES[route]):
                    check(shape, route, launches(step))
                    times.setdefault(route, []).append(timed(step, reps))
            row = {"family": family, "shape": list(shape), "numel": numel,
                   **{f"{r.replace('-', '_')}_ms": sum(t) / 2 for r, t in times.items()},
                   "runs_ms": times}
            pairs.append(row)
            log(f"  {family} {shape}: "
                + " | ".join(f"{r} {sum(t) / 2:.4f}" for r, t in times.items())
                + f"  flat/per-level {row['flat_ms'] / row['per_level_ms']:.3f}"
                + (f", multi/per-level {row['multi_ms'] / row['per_level_ms']:.3f}"
                   f", multi/flat {row['multi_ms'] / row['flat_ms']:.3f}"
                   if "multi_ms" in row else ""))
            del plan, x
    solves = []
    log(f"fista_inpaint 2D db4 L{LEVEL} f32, {ITERS} iterations: ms per "
        "iteration, per-level stepped | flat stepped | one launch | one launch "
        "| flat stepped | per-level stepped")
    for split in (False, True):
        for numel in SIZES:
            spatial = numel // 2 if split else numel
            shape = cube(spatial, 2)
            plan = tw.NDDWT("db4", shape, preserve_l2=True, device=dev)
            mask = (torch.rand(shape, generator=gen, device=dev) < SAMPLING).float()
            x = torch.randn(((2,) if split else ()) + shape, generator=gen, device=dev)

            def solve():
                if split:
                    return fista_inpaint_split(plan, mask * x, mask, LAM, LEVEL, ITERS)
                return fista_inpaint(plan, mask * x, mask, LAM, LEVEL, ITERS)

            caps = {"per-level stepped": (0, 0, 0), "flat stepped": (BIG, 0, 0),
                    "one launch": (BIG, BIG, 0)}
            order = ("per-level stepped", "flat stepped", "one launch",
                     "one launch", "flat stepped", "per-level stepped")
            times = []
            for route in order:
                with limits(*caps[route]):
                    got = launches(solve)
                    ok = {"one launch": got == {"nddwt_flat_iter": 1},
                          "flat stepped": got.get("nddwt_flat_pair") == ITERS
                          and "nddwt_flat_iter" not in got,
                          "per-level stepped": not any(
                              "flat" in k or "multi" in k for k in got)}[route]
                    if not ok:
                        raise RuntimeError(f"{shape} {route} launched {got}")
                    times.append(timed(solve, 2, warm=1) / ITERS)
            row = {"split": split, "shape": list(shape), "numel": numel,
                   "per_level_stepped_ms": (times[0] + times[5]) / 2,
                   "flat_stepped_ms": (times[1] + times[4]) / 2,
                   "one_launch_ms": (times[2] + times[3]) / 2, "runs_ms": times}
            solves.append(row)
            log(f"  {'split ' if split else ''}{shape}: "
                + " | ".join(f"{t:.4f}" for t in times))
            del plan, mask, x
    torch.cuda.empty_cache()
    batched = []
    log(f"dec_batched + rec_batched, db4 L{LEVEL} f32, N items of each count: ms "
        "per batch, per-level | flat | multi | multi | flat | per-level")
    for ndim in (2, 3):
        for batch in BATCHES:
            for numel in SIZES:
                shape = cube(numel, ndim)
                plan = tw.NDDWT("db4", shape, device=dev)
                xb = torch.randn((batch,) + shape, generator=gen, device=dev)

                def pair():
                    return plan.rec_batched(plan.dec_batched(xb, LEVEL))

                want = {"per-level": {"nddwt_dec_level": batch * LEVEL,
                                      "nddwt_rec_level": batch * LEVEL},
                        "flat": {"nddwt_flat_pair": 2 * batch},
                        "multi": WANT["multi"]}
                reps = max(3, min(max_reps, 2**24 // (numel * batch)))
                times = {}
                for route in ("per-level", "flat", "multi", "multi", "flat", "per-level"):
                    with limits(*ROUTES[route]):
                        got = launches(pair)
                        if got != want[route]:
                            raise RuntimeError(f"batch of {shape} {route} launched {got}")
                        times.setdefault(route, []).append(timed(pair, reps))
                row = {"ndim": ndim, "batch": batch, "shape": list(shape), "numel": numel,
                       **{f"{r.replace('-', '_')}_ms": sum(t) / 2 for r, t in times.items()},
                       "runs_ms": times}
                batched.append(row)
                log(f"  {batch} x {shape}: "
                    + " | ".join(f"{r} {sum(t) / 2:.4f}" for r, t in times.items())
                    + f"  multi/per-level {row['multi_ms'] / row['per_level_ms']:.3f}")
                del plan, xb
    torch.cuda.empty_cache()
    flat_max = {family: crossover_limit([r for r in pairs if r["family"] == family],
                                        "flat_ms", "per_level_ms")
                for family in dict.fromkeys(r["family"] for r in pairs)}
    multi_rows = {family: [r for r in pairs if r["family"] == family and "multi_ms" in r]
                  for family in dict.fromkeys(r["family"] for r in pairs)}
    multi_max = {f: crossover_limit(rows, "multi_ms", "per_level_ms")
                 for f, rows in multi_rows.items() if rows}
    multi_over_flat = {f: faster_from(rows, "multi_ms", "flat_ms", 0.9)
                       for f, rows in multi_rows.items() if rows}
    batched_max = {f"{d}D x {n}": crossover_limit(
        [r for r in batched if (r["ndim"], r["batch"]) == (d, n)], "multi_ms",
        "per_level_ms") for d in (2, 3) for n in BATCHES}
    iter_max = {
        f"{'split' if s else 'real'} vs {other}": crossover_limit(
            [r for r in solves if r["split"] == s], "one_launch_ms", other)
        for s in (False, True)
        for other in ("flat_stepped_ms", "per_level_stepped_ms")}
    return {"device": torch.cuda.get_device_name(0), "dec_rec": pairs,
            "fista": solves, "batched": batched, "flat_no_slower_up_to": flat_max,
            "one_launch_solve_no_slower_up_to": iter_max,
            "multi_no_slower_than_per_level_up_to": multi_max,
            "multi_10pct_faster_than_flat_from": multi_over_flat,
            "batched_multi_no_slower_than_per_level_up_to": batched_max}


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("chip_flat_crossover: no CUDA device; this runs only on a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    result = measure()
    print(json.dumps({"card": smi, **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
