#!/usr/bin/env python3
"""A/B of the one-launch multilevel kernels on one NVIDIA GPU.

    python3 chip_ab_multi.py [--parent OTHER_CHECKOUT] [VARIANT.cu ...]
    python3 chip_ab_multi.py --parent OTHER_CHECKOUT --ptxas

Times ``nddwt_dec_multi`` and ``nddwt_rec_multi``, db4 L3 float32, queued
behind a sleep (the kernels alone: the card runs the calls back to back,
never waiting for the host), medians of 10 repeats, at 128^3, (256, 128,
128), 2048^2, a batch of 16 x 256^2 (the multi-coil slice's components), a
batch of 8 x (256, 128, 128) and the two components of one complex
(256, 128, 128) array (2^22 elements each), beside the per-level kernels'
chains of the same levels (L launches per item and direction) timed the
same way. Each checkout runs in a fresh process that builds its own
kernels from its own sources: OTHER_CHECKOUT (the root of another
checkout, e.g. the parent commit unpacked with ``git archive``) and this
one in the order other, this, this, other, so that the card's clock drifts
against neither.

The first process of this checkout also builds variants of
``ops/csrc/nddwt_multi.cu`` and times them beside the checkout's build, in
the order given and then in reverse: four built in (``BUILT_IN``: "fixed
order" walks each level's units c, c + grid, ... instead of claiming them
from the per-level counter, and "fixed order, opaque unit" does the same
with the unit index hidden from the compiler's loop analysis; and the two
diagnostic builds of ``chip_ab_stages.py``, whose outputs are wrong and
which are timed only: "copies only" skips the streamed bodies' passes and
"passes only" their copies), "analysis at one CTA an SM" (the analysis
without the two-CTA register cap), one plan variant of the checkout's
build (``PLAN_VARIANTS``: "2D batches unfolded" runs a 2D batch item by
item, one row a plane tile, instead of folding it into the view's
pass-through slot), and every VARIANT.cu given (a copy of
``nddwt_multi.cu`` with a change and the same C interface, built with the
checkout's ``csrc/`` on the include path). Every build but the diagnostic
ones is held against the kernels' plain versions (``ops/multi_ref.py``) at
small odd shapes first (an A/B never times a wrong kernel), and what
``ptxas`` reports for each (registers, stack, spills) is printed.

With ``--ptxas`` it only builds both checkouts' ``nddwt_level.cu`` and
``nddwt_4d.cu`` (whose streamed bodies the multilevel kernels share) with
``-Xptxas -v`` and prints each kernel whose registers, stack or spills
differ between them, and how many do.

Prints the card's name and power limit first and one JSON object last
(each process's times, and the medians per checkout). It exits non-zero
without a CUDA device or if a process or a build fails or disagrees.
"""

import ctypes
import functools
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

LEVEL = 3
SHAPES = (((128, 128, 128), 1), ((256, 128, 128), 1), ((2048, 2048), 1),
          ((256, 256), 16), ((256, 128, 128), 8), ((256, 128, 128), 2))
REPS = 10
MULTI = "nddwt_multi.cu"
# name -> [(file in csrc/, text, replacement)], every occurrence replaced
CLAIM = "for (long long u; (u = claim(a.next, l, &claimed)) < a.units;) {"
FIXED = "for (long long u = blockIdx.x; u < a.units; u += gridDim.x) {"
BUILT_IN = {
    "fixed order": [(MULTI, CLAIM, FIXED)],
    "fixed order, opaque unit": [(MULTI, CLAIM, FIXED + '\n      asm volatile("" : "+l"(u));')],
    "analysis at one CTA an SM": [(MULTI, "__launch_bounds__(kThreads, 2)\n    dec_multi_kernel",
                                   "__launch_bounds__(kThreads, 1)\n    dec_multi_kernel")],
}
# name -> keyword arguments of ops/multi._plan: this checkout's build on
# another plan
PLAN_VARIANTS = {"2D batches unfolded": {"fold": False}}


def _diagnostic_builds():
    """The streamed bodies' copies-only and passes-only builds, as
    ``chip_ab_stages.py`` makes them (its text replacements)."""
    import chip_ab_stages as stages

    return {name: stages.BUILT_IN[name] for name in stages.DIAGNOSTIC}


def queued(torch, fn, calls, reps=REPS):
    """Median ms per call over ``reps`` repeats of ``calls`` calls, each
    repeat enqueued behind a sleep longer than the host takes to enqueue
    it."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host = (time.perf_counter() - t0) / 3  # seconds a call, enqueue only
    torch.cuda.synchronize()
    cycles = int(min(2.0, 0.025 + 2 * host * calls) * 2e9)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return statistics.median(out)


def _ptxas(text):
    """'entry: registers, stack, spills' per kernel, short names."""
    rows, fn = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and fn:
            rows.append([fn, None, int(m.group(1)), int(m.group(2))])
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1][1] is None:
            rows[-1][1] = int(m.group(1))
    return rows


def _read_only_loads(ck, so) -> int:
    """The loads through the read-only path (``LDG...CONSTANT``) in a
    multilevel build: none may be there, since each level reads what other
    CTAs wrote in the level before."""
    sass = subprocess.run([str(Path(ck._nvcc()).with_name("cuobjdump")), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    return sum(1 for line in sass.splitlines() if "LDG" in line and "CONSTANT" in line)


def compare_ptxas(here: str, other: str) -> dict:
    """Registers, stack and spills of every kernel of the level and 4D
    sources of two checkouts, by kernel (the anonymous namespace's
    file-dependent part of each name dropped); the kernels that differ."""
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck

    def rows(root, name, tmp):
        src = Path(root) / "non_decimated_wavelets_tpu_torch/ops/csrc" / f"{name}.cu"
        out = subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                              str(Path(tmp) / f"{name}.so"), str(src)],
                             capture_output=True, text=True, check=True)
        return {re.sub(r"_GLOBAL__N__\w+?_\d+_\w+?_cu_\w+?\d+(?=[a-z])", "", r[0]): r[1:]
                for r in _ptxas(out.stdout + out.stderr)}

    found = {}
    for name in ("nddwt_level", "nddwt_4d"):
        with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
            mine, theirs = rows(here, name, a), rows(other, name, b)
        differ = {k: (theirs.get(k), mine.get(k)) for k in sorted(set(mine) | set(theirs))
                  if mine.get(k) != theirs.get(k)}
        print(f"  {name}.cu: {len(mine)} kernels, {len(differ)} differ from the other "
              "checkout's (registers, stack, spill stores)", flush=True)
        for k, (t, m) in differ.items():
            print(f"    {k}: other {t}, this {m}", flush=True)
        found[name] = {"kernels": len(mine), "differ": {k: list(v) for k, v in differ.items()}}
    return found


def child(root: str, variants: bool, files: list) -> int:
    """Time the checkout at ``root`` (and, with ``variants``, the built-in
    variant builds and those of ``files``); print one JSON line."""
    sys.path.insert(0, root)
    import torch

    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
    from non_decimated_wavelets_tpu_torch.ops import multi, multi_ref

    import chip_flat_crossover as xover

    assert Path(ck.__file__).resolve().is_relative_to(Path(root).resolve())
    t0 = time.time()
    ck.build(("nddwt_multi", "nddwt_level"))
    print(f"  {root}: built in {time.time() - t0:.2f} s; read-only loads in the multilevel "
          f"kernels: {_read_only_loads(ck, ck.library_path('nddwt_multi'))}",
          file=sys.stderr, flush=True)
    checkout_load = multi.load
    libs = {"checkout": None}
    diagnostic = set()
    if variants:
        libs.update(dict.fromkeys(PLAN_VARIANTS))
        builds = {**BUILT_IN, **_diagnostic_builds()}
        diagnostic = set(_diagnostic_builds())
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            jobs = []
            for i, name in enumerate(list(builds) + files):
                if name in builds:
                    d = tmp / f"csrc{i}"
                    shutil.copytree(ck.CSRC, d)
                    for header, old, new in builds[name]:
                        p = d / header
                        src = p.read_text()
                        if old not in src:
                            print(f"chip_ab_multi: {header} has changed: cannot build "
                                  f"{name!r}", file=sys.stderr)
                            return 1
                        p.write_text(src.replace(old, new))
                    src, inc = d / MULTI, d
                else:
                    src, inc = Path(name).resolve(), ck.CSRC
                so = tmp / f"{i}.so"
                jobs.append((Path(name).name, so, subprocess.Popen(
                    [ck._nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(inc), "-o", str(so),
                     str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            for name, so, proc in jobs:
                out, _ = proc.communicate()
                if proc.returncode:
                    print(f"chip_ab_multi: nvcc failed on {name}:\n{out[-4000:]}",
                          file=sys.stderr)
                    return 1
                rows = _ptxas(out)
                print(f"  {name}: {len(rows)} kernels, registers "
                      f"{min(r[1] for r in rows)}-{max(r[1] for r in rows)}, stack "
                      f"{max(r[2] for r in rows)} bytes, spills {max(r[3] for r in rows)} bytes, "
                      f"read-only loads {_read_only_loads(ck, so)}", file=sys.stderr, flush=True)
                libs[name] = ctypes.CDLL(str(so))

    plan = getattr(multi, "_plan", None)  # another checkout may have none

    def use(name):
        """Route the wrappers through build ``name``, declared as
        ``multi.load`` declares the checkout's, or through the checkout's
        on the plan variant ``name``."""
        multi.load.cache_clear()
        if plan is not None:
            multi._plan = (functools.partial(plan, **PLAN_VARIANTS[name])
                           if name in PLAN_VARIANTS else plan)
        if libs[name] is None:
            return
        real = ck.library
        ck.library = lambda _: libs[name]
        try:
            checkout_load()
        finally:
            ck.library = real

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, items in (((37, 29, 41), 2), ((45, 61), 5)):
        taps = tw.NDDWT("db4", shape, device=dev).taps_hp
        x = torch.randn((items,) + shape, generator=gen, device=dev)
        for lvl in (3, 5):
            ref = multi_ref.dec_multi_ref(x, taps, lvl, 0.1)
            ref_x = multi_ref.rec_multi_ref(ref, taps, lvl, 0.5 ** len(shape))
            for name in libs:
                if name in diagnostic:
                    continue
                use(name)
                bands = multi.dec_multi(x, taps, lvl, 0.1)
                back = multi.rec_multi(ref, taps, lvl, False)
                err = max((bands - ref).abs().max().item() / ref.abs().max().item(),
                          (back - ref_x).abs().max().item() / ref_x.abs().max().item())
                print(f"  {name} {(items,) + shape} L{lvl}: max error {err:.3e} relative "
                      "to the plain versions", file=sys.stderr, flush=True)
                if not err <= 1e-5:
                    print(f"chip_ab_multi: {name} disagrees with the plain versions",
                          file=sys.stderr)
                    return 1
    table = []
    for shape, items in SHAPES:
        taps = tw.NDDWT("db4", shape, device=dev).taps_hp
        x = torch.randn((items,) + shape, generator=gen, device=dev)
        use("checkout")
        y = multi.dec_multi(x, taps, LEVEL)
        row = {"shape": list(shape), "items": items}
        order = list(libs) + ["per-level"] + list(libs)[::-1]
        for name in order:
            if name == "per-level":  # the plan on the per-level route, item by item
                per_level = tw.NDDWT("db4", shape, device=dev)
                with xover.limits(0, 0, 0):
                    times = (
                        queued(torch, lambda: [per_level.dec(v, LEVEL, band_axis=0)
                                               for v in x], 2),
                        queued(torch, lambda: [per_level.rec(v, band_axis=0) for v in y], 2))
            else:
                use(name)
                times = (queued(torch, lambda: multi.dec_multi(x, taps, LEVEL), 10),
                         queued(torch, lambda: multi.rec_multi(y, taps, LEVEL, False), 10))
            row.setdefault(name, []).append(times)
        table.append(row)
        print(f"  {items} x {shape} db4 L{LEVEL} f32, queued ms per call (dec, rec): "
              + " | ".join(f"{n} " + ", ".join(
                  f"{sum(t[i] for t in row[n]) / len(row[n]):.4f}" for i in (0, 1))
                  for n in dict.fromkeys(order)), file=sys.stderr, flush=True)
        del x, y
        torch.cuda.empty_cache()
    use("checkout")
    print(json.dumps({"root": root, "table": table}))
    return 0


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        rest = sys.argv[3:]
        return child(sys.argv[2], rest[:1] == ["--variants"], rest[1:])
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_multi: no CUDA device; this runs only on a GPU",
              file=sys.stderr)
        return 1
    args = sys.argv[1:]
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = str(Path(args[1]).resolve()), args[2:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    here = str(Path(__file__).resolve().parent)
    if args == ["--ptxas"] and parent:
        print(json.dumps({"card": smi, "ptxas": compare_ptxas(here, parent)}))
        return 0
    order = ([("other", parent)] if parent else []) + [("this", here), ("this", here)] + (
        [("other", parent)] if parent else [])
    runs = []
    for i, (who, root) in enumerate(order):
        cmd = [sys.executable, __file__, "--child", root]
        if who == "this" and not any(r["who"] == "this" for r in runs):
            cmd += ["--variants"] + [str(Path(a).resolve()) for a in args]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=here)
        print(proc.stderr, end="", flush=True)
        if proc.returncode:
            print(f"chip_ab_multi: the {who} process failed ({proc.returncode})",
                  file=sys.stderr)
            return 1
        runs.append({"who": who, **json.loads(proc.stdout.strip().splitlines()[-1])})
    medians = {}
    for who in ("other", "this"):
        for run in (r for r in runs if r["who"] == who):
            for row in run["table"]:
                key = f"{row['items']} x {tuple(row['shape'])}"
                for name in ("checkout", "per-level"):
                    for t in row[name]:
                        medians.setdefault(who, {}).setdefault(key, {}).setdefault(
                            name, []).append(t)
    summary = {who: {key: {name: [statistics.median(t[i] for t in ts) for i in (0, 1)]
                           for name, ts in rows.items()}
                     for key, rows in by.items()}
               for who, by in medians.items()}
    for key in summary.get("this", {}):
        line = " | ".join(
            f"{who} multi {summary[who][key]['checkout'][0]:.4f}, "
            f"{summary[who][key]['checkout'][1]:.4f}; per-level {summary[who][key]['per-level'][0]:.4f}, "
            f"{summary[who][key]['per-level'][1]:.4f}"
            for who in ("other", "this") if who in summary)
        print(f"{key} db4 L{LEVEL} f32 queued medians (dec, rec) ms: {line} [{smi}]")
    print(json.dumps({"card": smi, "order": [r["who"] for r in runs], "runs": runs,
                      "medians": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
