#!/usr/bin/env python3
"""``nddwt_rec_level`` on one NVIDIA GPU: checks, A/B against another
checkout, plan sweeps and builds of the plane body.

    python3 chip_ab_rec.py --check
    python3 chip_ab_rec.py [--parent OTHER_CHECKOUT] [--sweep] [--builds]

``--check`` builds this checkout's ``nddwt_level.cu``, prints the registers,
stack and spills ``ptxas`` reports for every instantiation of the plane
body (``csrc/nddwt_plane.cuh``) and the window body's synthesis, and holds
``ops.cuda_kernels.rec_level`` against ``level_ref.rec_level_ref``
(float32 1e-5, float64 1e-12, bfloat16 1e-2, relative to max|plain|) over
``CASES``: every dtype and filter length of the plane body, band 0 from
``approx`` and from ``y``, tiles straddling the periodic wrap on both
in-plane axes (a tile wider than its axes: window rows wrapped at both
ends), whole-row windows and row pieces, ragged tiles and chunks, each
axis halo-padded, and views the
window body keeps (2D, db5, mixed filters, rows off 16 bytes); each case
also checks the body the launch took against ``_rec_body`` (the counter
``nddwt.rec_level.body.*``: the body the wrapper names, which the library
runs or refuses). Then it prints that counter and the launch
counts of one denoising call and one FISTA CS-MRI iteration at knee3d's
(320, 320, 256).

Without ``--check`` it times one ``nddwt_rec_level`` launch a call with
CUDA events (3 warm-up calls, then 5 repeats of 10 calls, the median of the
repeats kept per key), the same 10 calls queued behind a sleep of about 25
ms (``*_queued_ms``: the kernel alone, where a call's host time comes near
its kernel's) and the host's time a call (``*_host_ms``: the wrapper and
the launch) at the shapes of ``TIMED``: 256^3 db4 in float32, float64 and
bfloat16, the {"x": 2} block of 256^3 halo-padded on X (as
``chip_ab_pairs.py`` times it), and knee3d's (320, 320, 256) db4 in
float32, float64 and bfloat16, each checked once against the plain version
first. With ``--parent`` the same runs in a fresh process for each
checkout, each importing and building its own package, in the order other,
this, this, other. ``--sweep`` times this checkout's float32 and float64
launches at (320, 320, 256) and 256^3 over the forced plane plans of
``SWEEP`` (``_plane_plan`` bypassed), in the order given and then reversed.
``--builds`` times variants of the plane body built from this checkout's
sources with one change each (``BUILDS``, with the wrapper's constants to
match): the stage buffers capped at 2, the buffers 16 bytes past a 128-byte
boundary, and two diagnostic builds whose outputs are wrong, timed only:
"copies only" (no slot-1 or slot-2 pass) and "passes only" (no bulk copy:
each stage's barrier completes at once on what the buffer held).

Prints the card's name and power limit first and one JSON object last. Exits
non-zero without a CUDA device or if a launch disagrees with its plain
version.
"""

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (output shape, wavelet, dtype name, halo-padded axes, forced plan or None,
# approx offset in elements, the body the launch takes with band 0 from y
# and with band 0 from approx)
CASES = [
    ((8, 12, 16), "db4", "float32", None, None, 0, "plane"),  # slot 0 of extent K
    ((9, 10, 12), "db1", "float64", None, None, 0, "plane"),
    ((10, 16, 24), "db2", "bfloat16", None, None, 0, "plane"),
    ((12, 14, 16), "db3", "float32", None, None, 0, "plane"),
    ((12, 14, 16), "db3", "float64", None, None, 0, "plane"),
    ((9, 12, 20), "db4", "float32", None, (9, 64, 32), 0, "plane"),  # tiles wider than n1, n2
    ((11, 40, 36), "db2", "float32", None, (4, 32, 64), 0, "plane"),  # ragged rows and chunk
    ((11, 20, 40), "db2", "float32", None, (4, 64, 32), 0, "plane"),  # row pieces, ragged
    ((10, 20, 34), "db4", "float64", None, (3, 32, 32), 0, "plane"),
    ((12, 24, 72), "db3", "bfloat16", None, (5, 32, 64), 0, "plane"),
    ((12, 9, 12), "db2", "float32", (True, False, False), None, 0, "plane"),
    ((10, 12, 16), "db4", "float64", (False, True, False), None, 0, "plane"),
    ((10, 9, 13), "db2", "float32", (False, False, True), None, 0, "plane"),
    ((11, 12, 15), "db1", "bfloat16", (True, True, True), None, 0, "plane"),
    ((40, 48, 64), "db4", "float32", None, None, 0, "plane"),
    ((24, 40, 72), "db4", "bfloat16", None, None, 0, "plane"),
    ((11, 21, 37), "db2", "float32", None, None, 0, "window"),  # rows off 16 bytes
    ((8, 12, 16), "db4", "float32", None, None, 1, ("plane", "window")),  # approx off 16 bytes
    ((10, 12, 14), ("db2", "db3", "db4"), "float64", None, None, 0, "window"),
    ((12, 12, 16), "db5", "float32", None, None, 0, "window"),
    ((9, 300), ("db2", "db6"), "float32", None, None, 0, "window"),  # 2D
]
SHAPE, KNEE = (256, 256, 256), (320, 320, 256)
# key -> (shape, dtype name, X halo-padded)
TIMED = {
    "rec_256_f32_ms": (SHAPE, "float32", False),
    "rec_256_f64_ms": (SHAPE, "float64", False),
    "rec_256_bf16_ms": (SHAPE, "bfloat16", False),
    "rec_256_padded_ms": (SHAPE, "float32", True),
    "rec_knee_f32_ms": (KNEE, "float32", False),
    "rec_knee_f64_ms": (KNEE, "float64", False),
    "rec_knee_bf16_ms": (KNEE, "bfloat16", False),
}
# Forced plane plans (C, T1, T2) per TIMED key: T1 * T2 = 2048 in float32,
# 1024 in float64; a tile of 256 columns spans the rows (whole-row windows).
SWEEP = {
    "rec_knee_f32_ms": [(107, 8, 256), (80, 8, 256), (107, 4, 512), (107, 16, 128)],
    "rec_256_f32_ms": [(64, 8, 256), (43, 8, 256), (64, 16, 128)],
    "rec_knee_f64_ms": [(107, 4, 256), (80, 4, 256), (107, 8, 128)],
    "rec_256_f64_ms": [(64, 4, 256), (43, 4, 256), (64, 8, 128)],
}
PLANE = "nddwt_plane.cuh"
# name -> ([(old, new)] in csrc/nddwt_plane.cuh, every occurrence replaced;
# ops.cuda_kernels attributes set while the build runs)
BUILDS = {
    "stages <= 2": ([("constexpr int kPlaneMaxStages = 4;", "constexpr int kPlaneMaxStages = 2;")],
                    {"_PLANE_MAX_STAGES": 2}),
    "buffers 16 bytes past 128": ([("raw + (-smem_addr(raw) & (kPlaneAlign - 1))",
                                    "raw + (-smem_addr(raw) & (kPlaneAlign - 1)) + 16")], {}),
    "copies only": ([("      if (woff[j] < 0) continue;", "      if (woff[j] < 0 || ns > 0) continue;"),
                     ("    for (int s2 = 0; s2 < 2; ++s2) {\n      const Taps<KT, C> t2",
                      "    for (int s2 = 0; s2 < 2 * (ns < 0); ++s2) {\n      const Taps<KT, C> t2")],
                    {}),
    "passes only": ([("mbar_expect_tx(&bars[buf], stage_bytes);", "mbar_expect_tx(&bars[buf], 0u);"),
                     ("for (int f = lane; f < 4 * per; f += 32) {",
                      "for (int f = lane; f < 4 * per * 0; f += 32) {")], {}),
}
DIAGNOSTIC = ("copies only", "passes only")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _timed(torch, call, reps=5, n=10):
    """Per call over n calls: the card's ms, the card's ms with the calls
    queued behind a sleep of about 25 ms (the kernel alone, never waiting
    for the host), and the host's ms."""
    for _ in range(3):
        call()
    times, queued, host = [], [], []
    for q in [False] * reps + [True] * reps:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if q:
            torch.cuda._sleep(50_000_000)  # cycles
        s.record()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        t1 = time.perf_counter()
        e.record()
        torch.cuda.synchronize()
        (queued if q else times).append(s.elapsed_time(e) / n)
        if not q:
            host.append((t1 - t0) * 1e3 / n)
    return times, queued, host


def _inputs(torch, tw, shape, wv, dtype, padded, gen, offset=0):
    """Band array y (2 levels' worth), approx (``offset`` elements into a
    larger buffer) and taps for one launch."""
    taps = tw.NDDWT(wv, shape, device="cuda").taps_hp
    pad = padded or (False,) * len(shape)
    ins = tuple(n + (t.shape[1] - 1 if p else 0) for n, t, p in zip(shape, taps, pad))
    nb = 2 ** len(shape)
    y = torch.randn((2 * nb - 1,) + ins, generator=gen, device="cuda").to(dtype)
    numel = 1
    for m in ins:
        numel *= m
    approx = torch.randn(numel + offset, generator=gen, device="cuda").to(dtype)[offset:].view(ins)
    return taps, y, approx, nb


def _check(torch, tw, ck, level_ref, tracing) -> list:
    """The CASES on the card; returns what disagreed."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    wrong = []
    real_plan = ck._plane_plan
    for shape, wv, dname, padded, plan, offset, want_body in CASES:
        dtype = getattr(torch, dname)
        tol = {"float64": 1e-12, "bfloat16": 1e-2}.get(dname, 1e-5)
        if plan is not None:
            ck._plane_plan = lambda *a, t=plan: t
        taps, y, approx, nb = _inputs(torch, tw, shape, wv, dtype, padded, gen, offset)
        wants = (want_body,) * 2 if isinstance(want_body, str) else want_body
        for src, want in zip(([("y", b) for b in range(nb)],
                              [("a", 0)] + [("y", nb + b - 1) for b in range(1, nb)]), wants):
            tracing.reset()
            tracing.enable()
            got = ck.rec_level(y, approx, src, taps, 0.125, padded)
            torch.cuda.synchronize()
            tracing.disable()
            counters = tracing.summary()["counters"]
            ref = level_ref.rec_level_ref(y.cpu(), approx.cpu(), src, taps, 0.125, padded)
            err = (got.cpu().double() - ref.double()).abs().max().item()
            scale = ref.double().abs().max().item()
            body = [k.rsplit(".", 1)[1] for k in counters if k.startswith("nddwt.rec_level.body.")]
            tag = f"{shape} {wv} {dname} padded={padded} plan={plan} band0={src[0]}"
            print(f"check {tag}: err {err / scale:.3e} body {body}", flush=True)
            if not err <= tol * scale or body != [want]:
                wrong.append(tag)
        ck._plane_plan = real_plan
    return wrong


def _ptxas(ck) -> None:
    """Print ptxas's resource lines of the synthesis kernels of
    nddwt_level.cu."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [ck._nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v", "-o", f"{tmp}/v.so",
             str(ck.CSRC / "nddwt_level.cu")], capture_output=True, text=True)
    lines = (proc.stdout + proc.stderr).splitlines()
    name = None
    for line in lines:
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and ("syn_kernel" in name) and ("registers" in line or "stack" in line):
            print(f"ptxas {name}: {line.strip()}", flush=True)


def _time_all(torch, tw, ck, level_ref, keys, check=True) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for key in keys:
        shape, dname, padded = TIMED[key]
        dtype = getattr(torch, dname)
        pad = (True, False, False) if padded else None
        block = (shape[0] // 2,) + shape[1:] if padded else shape
        taps, y, _, nb = _inputs(torch, tw, block, "db4", dtype, pad, gen)
        src = [("y", b) for b in range(nb)]
        call = lambda: ck.rec_level(y, None, src, taps, 1 / nb, pad)  # noqa: E731
        if check and shape == SHAPE:  # the plain version at the smaller shape only
            ref = level_ref.rec_level_ref(y, None, src, taps, 1 / nb, pad)
            tol = {"float64": 1e-12, "bfloat16": 1e-2}.get(dname, 1e-5)
            err = (call().double() - ref.double()).abs().max().item()
            if err > tol * ref.double().abs().max().item():
                raise RuntimeError(f"{key}: {err} against the plain version")
            del ref
        (out[key], out[key.replace("_ms", "_queued_ms")],
         out[key.replace("_ms", "_host_ms")]) = _timed(torch, call)
        print(f"{key}: {out[key]}", flush=True)
        del y, call
        torch.cuda.empty_cache()
    return out


def _cells(torch, tw, tracing) -> dict:
    """The bodies nddwt_rec_level took, with tracing on, in one denoising
    call and one FISTA CS-MRI iteration at knee3d's (320, 320, 256) db4
    L3 preserve_l2 float32 (complex64 for CS), and the launch counts."""
    from non_decimated_wavelets_tpu_torch.models import fista_cs_mri
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(3)
    plan = tw.NDDWT("db4", KNEE, preserve_l2=True, dtype="float32", device="cuda")
    x = torch.randn(KNEE, generator=gen, device="cuda")
    b = torch.randn(KNEE, generator=gen, device="cuda", dtype=torch.complex64)
    mask = (torch.rand(KNEE, generator=gen, device="cuda") < 0.25).float()
    out = {}
    for name, call in (("denoise", lambda: plan.dec_rec(x, 3, threshold=0.1, band_axis=0)),
                       ("cs iteration", lambda: fista_cs_mri(plan, b * mask, mask, 0.05,
                                                             level=3, iters=1))):
        call()
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        tracing.reset()
        tracing.enable()
        call()
        torch.cuda.synchronize()
        tracing.disable()
        out[name] = {"counters": {k: v for k, v in tracing.summary()["counters"].items()
                                  if k.startswith("nddwt.rec_level.body.")},
                     "launches": {k: v for k, v in ck.launch_counts.items() if v}}
        print(f"{name}: {out[name]}", flush=True)
    return out


def child(root: str) -> int:
    """Time TIMED with the package found at ``root``."""
    sys.path.insert(0, root)
    import torch

    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
    from non_decimated_wavelets_tpu_torch.ops import level_ref

    if not Path(tw.__file__).resolve().is_relative_to(Path(root).resolve()):
        print(f"imported {tw.__file__}, not the package under {root}", file=sys.stderr)
        return 1
    print(json.dumps(_time_all(torch, tw, ck, level_ref, list(TIMED))))
    return 0


def _builds(torch, tw, ck, level_ref, tracing) -> dict:
    """Time the BUILDS at knee3d and 256^3 float32, each beside the
    checkout's build, every build twice in turns."""
    libs = {"checkout": ck.load()}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, (name, (edits, _)) in enumerate(BUILDS.items()):
            d = Path(tmp) / f"b{i}"
            shutil.copytree(ck.CSRC, d)
            text = (d / PLANE).read_text()
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{PLANE} has changed: cannot build {name!r}")
                text = text.replace(old, new)
            (d / PLANE).write_text(text)
            so = Path(tmp) / f"b{i}.so"
            procs.append((name, so, subprocess.Popen(
                [ck._nvcc(), *ck.NVCC_FLAGS, "-o", str(so), str(d / "nddwt_level.cu")])))
        for name, so, proc in procs:
            if proc.wait():
                raise RuntimeError(f"nvcc failed on {name}")
            ck.load.cache_clear()
            real = ck.library
            ck.library = lambda n, p=so: ctypes.CDLL(str(p))
            libs[name] = ck.load()
            ck.library = real
        real_load = ck.load
        out = {}
        order = list(libs)
        for name in order + order[::-1]:
            ck.load = lambda lib=libs[name]: lib
            overrides = BUILDS[name][1] if name in BUILDS else {}
            saved = {a: getattr(ck, a) for a in overrides}
            for a, v in overrides.items():
                setattr(ck, a, v)
            ck._plane_tile.cache_clear()
            if name not in DIAGNOSTIC:
                gen = torch.Generator(device="cuda").manual_seed(2)
                taps, y, approx, nb = _inputs(torch, tw, (24, 40, 72), "db4", torch.float32,
                                              None, gen)
                src = [("y", b) for b in range(nb)]
                tracing.reset()
                tracing.enable()
                got = ck.rec_level(y, approx, src, taps, 0.5)
                tracing.disable()
                ref = level_ref.rec_level_ref(y, approx, src, taps, 0.5)
                if (got - ref).abs().max().item() > 1e-5 * ref.abs().max().item():
                    raise RuntimeError(f"build {name!r} disagrees with the plain version")
                if "nddwt.rec_level.body.plane" not in tracing.summary()["counters"]:
                    raise RuntimeError(f"build {name!r} did not take the plane body")
            for key in ("rec_knee_f32_ms", "rec_256_f32_ms"):
                t = statistics.median(_time_all(torch, tw, ck, level_ref, [key],
                                                name not in DIAGNOSTIC)[key])
                out.setdefault(name, {}).setdefault(key, []).append(t)
            for a, v in saved.items():
                setattr(ck, a, v)
            ck._plane_tile.cache_clear()
        ck.load = real_load
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--parent")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--builds", action="store_true")
    ap.add_argument("--keys", default=",".join(TIMED), help="the TIMED keys to time")
    ap.add_argument("--child")
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_rec: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch import tracing
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
    from non_decimated_wavelets_tpu_torch.ops import level_ref

    card = _card()
    print(card, flush=True)
    ck.build(("nddwt_level",))
    result = {"card": card}
    if args.check:
        _ptxas(ck)
        wrong = _check(torch, tw, ck, level_ref, tracing)
        if wrong:
            print(f"chip_ab_rec: disagrees or took another body: {wrong}", file=sys.stderr)
            return 1
        result["cells"] = _cells(torch, tw, tracing)
        print(json.dumps(result))
        return 0
    if args.parent:
        runs = {}
        for label, root in (("parent", args.parent), ("change", str(ROOT)),
                            ("change", str(ROOT)), ("parent", args.parent)):
            proc = subprocess.run([sys.executable, __file__, "--child", root],
                                  capture_output=True, text=True)
            if proc.returncode:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return 1
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            for key, times in got.items():
                runs.setdefault(label, {}).setdefault(key, []).append(statistics.median(times))
            print(f"{label}: {got}", flush=True)
        result["runs"] = runs
    else:
        result["runs"] = {"change": _time_all(torch, tw, ck, level_ref, args.keys.split(","))}
    if args.sweep:
        real_plan = ck._plane_plan
        sweep = {}
        for key, plans in SWEEP.items():
            for t in plans + plans[::-1]:
                ck._plane_plan = lambda *a, t=t: t
                sweep.setdefault(f"{key} {t}", []).append(statistics.median(
                    _time_all(torch, tw, ck, level_ref, [key])[key]))
        ck._plane_plan = real_plan
        result["sweep"] = sweep
    if args.builds:
        result["builds"] = _builds(torch, tw, ck, level_ref, tracing)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
