#!/usr/bin/env python3
"""Time the one-launch flat kernels against the per-level route on one GPU.

    python3 chip_flat_crossover.py

Where ``ops/flat.py``'s size limits come from. For element counts 2^12,
2^14, ..., 2^22 in 1D, 2D, 3D and 4D (db4, L3, float32, shapes as near
cubic as powers of two allow), the ``dec_rec`` iterate (threshold 0.1) on
the flat kernel (one ``nddwt_flat_pair`` launch) and on the per-level route
(L analysis and L synthesis launches), in turns: per-level, flat, flat,
per-level. The same from 2^16 up for what the flat kernel's cost depends
on besides the count: float64 in 1D-4D, long filters (db10, db20, whose 3D
per-level route is the stage kernels; 128^3 db20 L2 among them) and five
levels. Then a 20-iteration 2D ``fista_inpaint`` (preserve_l2, lam 0.05,
40 % sampling), real and split (the pair's two components counted), as one
``nddwt_flat_iter`` launch against the stepped routes: a flat pair and a
``fista_step`` per iteration, and the per-level kernels and a
``fista_step`` (2L + 1 launches). The route of every run is held to its
launch counts.

Times are CUDA-event means over repeated calls after warm-up, host time
between launches included: a caller's loop pays it. The last line is a
JSON object with the tables and, per table, the largest count at which
the one-launch kernel was no slower at every smaller count too. Exits
non-zero without a CUDA device.
"""

import contextlib
import json
import sys

SIZES = tuple(2**k for k in range(12, 23, 2))
LARGE = SIZES[2:]
DIMS = (1, 2, 3, 4)
LEVEL, THRESHOLD = 3, 0.1
# The dec_rec tables: (ndim, wavelet, level, dtype, element counts).
FAMILIES = (
    *((d, "db4", LEVEL, "float32", SIZES) for d in DIMS),
    *((d, "db4", LEVEL, "float64", LARGE) for d in DIMS),
    (2, "db20", 2, "float32", LARGE),
    (3, "db10", LEVEL, "float32", LARGE),
    (3, "db20", 2, "float32", (2**18, 2**20, 2**21, 2**22)),
    (3, "db4", 5, "float32", LARGE),
)
ITERS, LAM, SAMPLING = 20, 0.05, 0.4


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
def limits(flat_max, iter_max):
    """Route through ``ops/flat.py``'s limits for the duration."""
    from non_decimated_wavelets_tpu_torch.ops import flat

    names = ("FLAT_MAX_NUMEL", "ITER_MAX_NUMEL")
    old = [getattr(flat, name) for name in names]
    for name, value in zip(names, ({None: flat_max}, iter_max)):
        setattr(flat, name, value)
    try:
        yield
    finally:
        for name, value in zip(names, old):
            setattr(flat, name, value)


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


def measure(log=print, max_reps=200):
    """Run both tables on the current CUDA device, at most ``max_reps``
    timed calls per run; return them with the crossovers."""
    import torch

    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch.models import (
        fista_inpaint, fista_inpaint_split)

    big = 2**62
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    pairs = []
    log(f"dec_rec, threshold {THRESHOLD}: ms per call, per-level | flat | flat "
        "| per-level")
    for ndim, wv, level, dtype, sizes in FAMILIES:
        family = f"{ndim}D {wv} L{level} {dtype}"
        for numel in sizes:
            shape = cube(numel, ndim)
            plan = tw.NDDWT(wv, shape, dtype=dtype, device=dev)
            x = torch.randn(shape, generator=gen, device=dev).to(plan.real_dtype)

            def step():
                return plan.dec_rec(x, level, threshold=THRESHOLD, band_axis=0)

            reps = max(5, min(max_reps, 2**24 // (numel * 8)))
            times = []
            for route in ("per-level", "flat", "flat", "per-level"):
                cap = big if route == "flat" else 0
                with limits(cap, cap):
                    got = launches(step)
                    want = {"nddwt_flat_pair": 1} if route == "flat" else None
                    if want is not None and got != want:
                        raise RuntimeError(f"{shape} flat route launched {got}")
                    if want is None and "nddwt_flat_pair" in got:
                        raise RuntimeError(f"{shape} per-level route launched {got}")
                    times.append(timed(step, reps))
            row = {"family": family, "shape": list(shape), "numel": numel,
                   "per_level_ms": (times[0] + times[3]) / 2,
                   "flat_ms": (times[1] + times[2]) / 2, "runs_ms": times}
            pairs.append(row)
            log(f"  {family} {shape}: " + " | ".join(f"{t:.4f}" for t in times)
                + f"  flat/per-level {row['flat_ms'] / row['per_level_ms']:.3f}")
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

            caps = {"per-level stepped": (0, 0), "flat stepped": (big, 0),
                    "one launch": (big, big)}
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
                              k.startswith("nddwt_flat") for k in got)}[route]
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
    flat_max = {family: crossover_limit([r for r in pairs if r["family"] == family],
                                        "flat_ms", "per_level_ms")
                for family in dict.fromkeys(r["family"] for r in pairs)}
    iter_max = {
        f"{'split' if s else 'real'} vs {other}": crossover_limit(
            [r for r in solves if r["split"] == s], "one_launch_ms", other)
        for s in (False, True)
        for other in ("flat_stepped_ms", "per_level_stepped_ms")}
    return {"device": torch.cuda.get_device_name(0), "dec_rec": pairs,
            "fista": solves, "flat_no_slower_up_to": flat_max,
            "one_launch_solve_no_slower_up_to": iter_max}


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
