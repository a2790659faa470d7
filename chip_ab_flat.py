#!/usr/bin/env python3
"""A/B of the one-launch flat kernels on one NVIDIA GPU.

    python3 chip_ab_flat.py [--parent PARENT_CHECKOUT] [--builds NAME,...] [VARIANT.cu ...]

Builds this checkout's ``ops/csrc/nddwt_flat.cu``, its built-in variants
(``BUILT_IN``, text replaced in a copy) and every variant source given (a
copy of it with a change and the same C interface, built with the
checkout's ``csrc/`` on the include path); with ``--parent``, also the
``nddwt_flat.cu`` of another checkout (the parent commit unpacked with
``git archive``: the per-axis passes, one grid barrier per axis; driven
through its own interface, which has no plan argument). The built-in
variants:

* "own barrier": a hand-written grid barrier (one thread a CTA arrives on
  a counter with an acq_rel atomic; the last resets it and bumps a
  generation with a release, the others spin on an acquire load) instead
  of ``cooperative_groups::this_grid().sync()``;
* "runtime taps" and "db4 unrolled only": the in-tile passes with their
  tap loops unrolled for no filter length, or for 8 taps only (a smaller
  kernel), instead of 2, 4, 6 and 8;
* "three CTAs per SM", "four CTAs per SM": the register cap of
  ``__launch_bounds__`` for 3 or 4 CTAs of 256 threads an SM, not 2;
* "element copies": every window element copied on its own (a 4- or
  8-byte ``cp.async``, or a bfloat16 load and conversion), not in 16-byte
  pieces;
* "counted barriers": the checkout's kernel counting its grid barriers
  (CTA 0, thread 0, one atomic a barrier), read back after a call: the
  barriers of a 2D L3 FISTA iteration and of a 64^3 L3 pair;
* two diagnostic builds, whose outputs are wrong and which are only
  timed: "barriers only" skips every pass's units and keeps the barriers
  (the barrier floor of a call); "copies only" keeps each unit's tables
  and window copies and skips its in-tile passes and stores.

It prints what ``ptxas`` reports for each build (registers, stack), holds
each build but the diagnostic ones against the kernels' plain versions
(``ops/flat_ref.py``) at small shapes, odd ones and ones whose last extent
takes 16-byte pieces (float32 1e-5 of max|plain|), and
times, per build, with CUDA events (the calls enqueued behind a ~25 ms
``torch.cuda._sleep``, so the events read the kernels, not the host; the
medians of 5 repeats): the 100-iteration 256^2 db4 L3 ``fista_inpaint``
solve, real and split (``nddwt_flat_iter``), 20 ``dec_rec_n`` sweeps at
264^2 (db1, db3) L3, and the ``dec_rec`` pair (threshold 0.1) at 256^2
and 64^3 db4 L3, and at 256^2 in bfloat16 (``nddwt_flat_pair``); every
build once in the order given, then once in reverse. Then it times each build (but the diagnostic
ones and the parent) over forced plans (``ops/flat.py: _flat_plan``
bypassed): tiles and axis groups of the 256^2 solve and of the 64^3 pair
(groups of 3, 2 and 1 axes). With ``--families``, it also times the
``dec_rec`` pair (threshold 0.1) of the same builds on the flat kernel's
other families (``FAMILIES``) over forced plans: for each group size of 1 to 3
axes, the four tiles of least estimated cost (``ops/flat.py:
_plan_cost``) among the plan's candidates, and the plan's own.

Prints the card's name and power limit first and one JSON object last. It
exits non-zero without a CUDA device or if a build disagrees with the plain
versions.
"""

import argparse
import contextlib
import ctypes
import json
import math
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

LEVEL, THRESHOLD, LAM, SAMPLING = 3, 0.1, 0.05, 0.4
SOLVE_SHAPE, SOLVE_ITERS = (256, 256), 100
CHAIN_SHAPE, CHAIN_WV, CHAIN_SWEEPS = (264, 264), ("db1", "db3"), 20
PAIR_SHAPES = ((256, 256), (64, 64, 64))
# Forced plans (axis-group ends, tile): the solve's and the 64^3 pair's.
SOLVE_PLANS = [((2,), (16, 32)), ((2,), (16, 16)), ((2,), (8, 32)), ((2,), (8, 16)),
               ((2,), (8, 8)), ((2,), (4, 32)), ((2,), (32, 32)), ((1, 2), (16, 32))]
CUBE_PLANS = [((3,), (8, 8, 8)), ((3,), (4, 8, 8)), ((2, 3), (16, 16, 16)),
              ((2, 3), (8, 16, 16)), ((2, 3), (8, 8, 16)), ((2, 3), (4, 8, 16)),
              ((1, 2, 3), (16, 16, 16)), ((1, 2, 3), (8, 16, 16)), ((1, 2, 3), (8, 8, 16))]
# The flat kernel's other families: (shape, wavelet, level), float32.
FAMILIES = (((2**20,), "db4", 3), ((2048, 2048), "db4", 3), ((2048, 2048), "db20", 2),
            ((160, 160, 160), "db4", 3), ((64, 64, 64), "db20", 2), ((32, 32, 16, 16), "db4", 3),
            ((16, 16, 8, 8, 8), "db2", 2))
FLAT = "nddwt_flat.cu"
SYNC = "__device__ __forceinline__ void flat_sync() { grid_barrier(); }"
ERRSTR = 'extern "C" const char* nddwt_error_string(int code) {'
OWN_BARRIER = """__device__ unsigned int g_bar_count;
__device__ unsigned int g_bar_gen;
__device__ __forceinline__ void flat_sync() {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int gen, old;
    __threadfence();
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(gen) : "l"(&g_bar_gen) : "memory");
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old) : "l"(&g_bar_count) : "memory");
    if (old == gridDim.x - 1) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], 0;" ::"l"(&g_bar_count) : "memory");
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(&g_bar_gen) : "memory");
    } else {
      unsigned int cur, tries = 0;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(cur) : "l"(&g_bar_gen)
                     : "memory");
        if (++tries > (1u << 26)) __trap();
      } while (cur == gen);
    }
  }
  __syncthreads();
}"""
COUNTED = """__device__ unsigned long long g_flat_syncs;
__device__ __forceinline__ void flat_sync() {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_flat_syncs, 1ull);
  grid_barrier();
}"""
COUNTER_READ = """extern "C" unsigned long long nddwt_flat_syncs() {
  unsigned long long v = 0, z = 0;
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(&v, g_flat_syncs, sizeof v);
  cudaMemcpyToSymbol(g_flat_syncs, &z, sizeof z);
  return v;
}
""" + ERRSTR
# name -> [(text, replacement)], every occurrence replaced
BUILT_IN = {
    "own barrier": [(SYNC, OWN_BARRIER)],
    "element copies": [("rc.nw = vec && sh < V", "rc.nw = false && sh < V")],
    "counted barriers": [(SYNC, COUNTED), (ERRSTR, COUNTER_READ)],
    "barriers only": [
        ("for (int u = blockIdx.x; u < units; u += gridDim.x)",
         "for (int u = blockIdx.x; u < 0; u += gridDim.x)"),
        ("for (unsigned int i = first_item(); i < nbe; i += item_stride())",
         "for (unsigned int i = first_item(); i < 0u; i += item_stride())")],
    "copies only": [
        ("for (int s = 0; s + 1 < m; ++s) {", "for (int s = 0; s + 1 < 0; ++s) {"),
        ("for (int i = threadIdx.x; i < par * a.tile_elems; i += kThreads) {",
         "for (int i = threadIdx.x; i < 0; i += kThreads) {"),
        ("for (int p = threadIdx.x; p < a.tile_elems; p += kThreads) {",
         "for (int p = threadIdx.x; p < 0; p += kThreads) {")],
}
BY_TAPS = """  switch (K) {
    case 2: f(std::integral_constant<int, 2>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    case 6: f(std::integral_constant<int, 6>()); break;
    case 8: f(std::integral_constant<int, 8>()); break;
    default: f(std::integral_constant<int, 0>()); break;
  }"""
BUILT_IN.update({
    "runtime taps": [(BY_TAPS, "  f(std::integral_constant<int, 0>());")],
    "db4 unrolled only": [(BY_TAPS, "  if (K == 8) f(std::integral_constant<int, 8>());\n"
                                    "  else f(std::integral_constant<int, 0>());")],
    "three CTAs per SM": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")],
    "four CTAs per SM": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 4)")],
})
DIAGNOSTIC = ("barriers only", "copies only")
COUNTED_BUILD = "counted barriers"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of another checkout (its nddwt_flat.cu)")
    ap.add_argument("--builds", help="the built-in variants to build, comma-separated "
                    "(default: all of BUILT_IN)")
    ap.add_argument("--families", action="store_true",
                    help="also time forced plans on the other families (FAMILIES)")
    ap.add_argument("variants", nargs="*", help="variant copies of nddwt_flat.cu")
    args = ap.parse_args()
    built_in = {name: BUILT_IN[name] for name in
                (args.builds.split(",") if args.builds is not None else BUILT_IN) if name}
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_flat: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch.models.cs_recon import _fista_schedule
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
    from non_decimated_wavelets_tpu_torch.ops import flat, flat_ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    checkout = ck.CSRC / FLAT
    with tempfile.TemporaryDirectory() as tmp:
        sources = {"checkout": (checkout, ck.CSRC)}
        for name, edits in built_in.items():
            text = checkout.read_text()
            for old, new in edits:
                if old not in text:
                    print(f"chip_ab_flat: {name!r}: text not found in {FLAT}: {old[:60]!r}",
                          file=sys.stderr)
                    return 1
                text = text.replace(old, new)
            path = Path(tmp) / f"{name.replace(' ', '_')}.cu"
            path.write_text(text)
            sources[name] = (path, ck.CSRC)
        for v in args.variants:
            sources[Path(v).name] = (Path(v).resolve(), ck.CSRC)
        if args.parent:
            csrc = Path(args.parent).resolve() / "non_decimated_wavelets_tpu_torch/ops/csrc"
            sources["parent"] = (csrc / FLAT, csrc)
        procs = {
            name: subprocess.Popen(
                [ck._nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(inc),
                 "-o", str(Path(tmp) / f"{i}.so"), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i, (name, (src, inc)) in enumerate(sources.items())}
        libs, ptxas = {}, {}
        for i, (name, proc) in enumerate(procs.items()):
            out, _ = proc.communicate()
            if proc.returncode:
                print(f"nvcc failed on {name}:\n{out}", file=sys.stderr)
                return 1
            ptxas[name] = [line.split("info    : ")[-1].strip() for line in out.splitlines()
                           if "registers" in line or "stack frame" in line]
            print(f"  {name}: " + "; ".join(ptxas[name]), flush=True)
            libs[name] = ctypes.CDLL(str(Path(tmp) / f"{i}.so"))
    checkout_load = flat.load

    class OldInterface:
        """A build without the plan argument, driven as the wrappers drive
        the checkout's: the plan dropped."""

        def __init__(self, lib):
            self.lib = lib
            vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            ip = ctypes.POINTER(ctypes.c_int)
            lib.nddwt_flat_pair.argtypes = [i, vp, vp, vp, vp, vp, i, i, i, i, ip, ip, f, f, vp]
            lib.nddwt_flat_iter.argtypes = [i] + [vp] * 8 + [i, i, i, i, i, ip, ip, f, f, vp]
            lib.nddwt_flat_work_words.argtypes = [i, ctypes.c_longlong]
            lib.nddwt_flat_work_words.restype = ctypes.c_longlong
            lib.nddwt_error_string.argtypes = [i]
            lib.nddwt_error_string.restype = ctypes.c_char_p

        def nddwt_flat_pair(self, *a):
            return self.lib.nddwt_flat_pair(*a[:-1])

        def nddwt_flat_iter(self, *a):
            return self.lib.nddwt_flat_iter(*a[:-1])

        def __getattr__(self, name):
            return getattr(self.lib, name)

    def use(name):
        """Route the flat wrappers through build ``name``."""
        checkout_load.cache_clear()
        lib = libs[name]
        if not hasattr(lib, "nddwt_flat_plan_ints"):
            adapter = OldInterface(lib)
            flat.load = lambda: adapter
            return
        flat.load = checkout_load
        real = ck.library
        ck.library = lambda _: lib
        try:
            checkout_load()
        finally:
            ck.library = real

    @contextlib.contextmanager
    def forced(shape, ends, tile):
        """``_flat_plan`` gives this plan for ``shape``."""
        real = flat._flat_plan

        def plan(s, k, dtype, batch=0):
            if tuple(s) != tuple(shape):
                return real(s, k, dtype, batch)
            lay = flat.flat_layout(s, k, tile, ends, max(batch, 1), ck._word(dtype))
            return flat.FlatPlan(tuple(ends), tuple(tile), lay["smem"], lay["units"])

        flat._flat_plan = plan
        flat._plan_ints.cache_clear()  # the plan argument is cached per shape
        try:
            yield
        finally:
            flat._flat_plan = real
            flat._plan_ints.cache_clear()

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def queued(fn, reps):
        """Median ms a call of 5 repeats of ``reps`` calls queued behind a
        sleep (the kernels alone)."""
        for _ in range(2):
            fn()
        times = []
        for _ in range(5):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e) / reps)
        return statistics.median(times)

    # The checks: small odd shapes, every mode, float32, batch 0 and 2.
    check_cases = [((37, 29), "db4", 3), ((13, 11, 9), ("db2", "db3", "db2"), 2), ((45,), "db3", 3),
                   ((37, 36), "db4", 3), ((13, 11, 12), ("db2", "db3", "db2"), 2),
                   ((20, 24), "db10", 2)]
    for name in libs:
        if name in DIAGNOSTIC:
            continue
        use(name)
        worst = 0.0
        for shape, wv, lvl in check_cases:
            taps = tw.NDDWT(wv, shape, device=dev).taps_hp
            for batch in (0, 2):
                lead = (2,) if batch else ()
                x = torch.randn(lead + shape, generator=gen, device=dev)
                mask = (torch.rand(shape, generator=gen, device=dev) < 0.6).float()
                lams, moms = [0.2, 0.1, 0.05], [0.0, 0.3, 0.4]
                runs = [(flat._call("pair", x, taps, lvl, True, 0.1, shape, batch),
                         flat_ref.flat_pair_ref("pair", x, taps, lvl, True, 0.1, batch)),
                        (flat._call_iter("fista", mask * x, mask, taps, lvl, True, lams, moms,
                                         1.0, shape, batch),
                         flat_ref.flat_iter_ref("fista", mask * x, mask, taps, lvl, True, lams,
                                                moms, 1.0, batch))]
                for k, r in runs:
                    for kk, rr in zip(k if isinstance(k, tuple) else (k,),
                                      r if isinstance(r, tuple) else (r,)):
                        worst = max(worst, (kk - rr).abs().max().item() / rr.abs().max().item())
        print(f"  {name}: max error {worst:.3e} relative to the plain versions", flush=True)
        if worst > 1e-5:
            print(f"chip_ab_flat: {name} disagrees with the plain versions", file=sys.stderr)
            return 1

    # The timed calls.
    sp = tw.NDDWT("db4", SOLVE_SHAPE, preserve_l2=True, device=dev)
    mask = (torch.rand(SOLVE_SHAPE, generator=gen, device=dev) < SAMPLING).float()
    xs = torch.randn((2,) + SOLVE_SHAPE, generator=gen, device=dev)
    b, b2 = mask * xs[0], mask * xs
    lams, moms = _fista_schedule(SOLVE_ITERS, LAM, 1.0)
    ctaps = tw.NDDWT(CHAIN_WV, CHAIN_SHAPE, device=dev).taps_hp
    xc = torch.randn(CHAIN_SHAPE, generator=gen, device=dev)
    lams_n = [0.2 * 0.1 ** (i / (CHAIN_SWEEPS - 1)) for i in range(CHAIN_SWEEPS)]
    pairs = {s: (tw.NDDWT("db4", s, device=dev).taps_hp,
                 torch.randn(s, generator=gen, device=dev)) for s in PAIR_SHAPES}
    x16 = pairs[SOLVE_SHAPE][1].bfloat16()
    calls = {
        "fista_256_ms": (lambda: flat.fista_flat(b, mask, sp.taps_hp, LEVEL, True, lams, moms,
                                                 1.0), 3),
        "fista_split_256_ms": (lambda: flat.fista_split_flat(b2, mask, sp.taps_hp, LEVEL, True,
                                                             lams, moms, 1.0), 3),
        "chain_264_ms": (lambda: flat.chain_flat(xc, ctaps, LEVEL, False, lams_n), 5),
        **{f"pair_{'x'.join(map(str, s))}_ms":
           (lambda s=s: flat.pair_flat(pairs[s][1], pairs[s][0], LEVEL, False, THRESHOLD), 20)
           for s in PAIR_SHAPES},
        "pair_256x256_bf16_ms": (lambda: flat.pair_flat(x16, pairs[SOLVE_SHAPE][0], LEVEL, False,
                                                        THRESHOLD), 20),
    }
    table = {name: {} for name in libs}
    order = list(libs) + list(libs)[::-1]
    for name in order:
        use(name)
        for key, (fn, reps) in calls.items():
            table[name].setdefault(key, []).append(queued(fn, reps))
        print(f"  {name}: " + ", ".join(f"{k} {v[-1]:.4f}" for k, v in table[name].items())
              + f" [{smi}]", flush=True)
    medians = {name: {k: statistics.median(v) for k, v in t.items()} for name, t in table.items()}

    # The barriers a call makes, counted by the counted build.
    counts = {}
    if COUNTED_BUILD in libs:
        use(COUNTED_BUILD)
        lib = libs[COUNTED_BUILD]
        lib.nddwt_flat_syncs.restype = ctypes.c_ulonglong
        lib.nddwt_flat_syncs()
    for iters in (10, 20) if COUNTED_BUILD in libs else ():
        flat.fista_flat(b, mask, sp.taps_hp, LEVEL, True, lams[:iters], moms[:iters], 1.0)
        counts[f"fista_256_{iters}_iterations"] = lib.nddwt_flat_syncs()
    for s in PAIR_SHAPES if COUNTED_BUILD in libs else ():
        flat.pair_flat(pairs[s][1], pairs[s][0], LEVEL, False, THRESHOLD)
        counts[f"pair_{'x'.join(map(str, s))}"] = lib.nddwt_flat_syncs()
    if counts:
        counts["fista_256_per_iteration"] = (counts["fista_256_20_iterations"]
                                             - counts["fista_256_10_iterations"]) / 10
    print(f"  grid barriers (counted build): {counts}", flush=True)

    # Forced plans on every build but the diagnostic ones and the parent.
    plans = []
    for name in libs:
        if name in DIAGNOSTIC or name == "parent":
            continue
        use(name)
        for shape, options, key in ((SOLVE_SHAPE, SOLVE_PLANS, "fista_256_ms"),
                                    ((64, 64, 64), CUBE_PLANS, "pair_64x64x64_ms")):
            k = (8,) * len(shape)
            for ends, tile in options:
                lay = flat.flat_layout(shape, k, tile, ends, 1, 4)
                if lay["smem"] > 227 * 1024 - 2 * flat.MAX_DIM * 76 * 4:
                    continue
                with forced(shape, ends, tile):
                    fn, reps = calls[key]
                    ms = queued(fn, reps)
                plans.append({"build": name, "shape": list(shape), "ends": list(ends),
                              "tile": list(tile), "smem": lay["smem"], "units": lay["units"],
                              key: ms})
                print(f"  {name}: plan {shape} groups {ends} tile {tile} smem {lay['smem']} "
                      f"units {lay['units']}: {key} {ms:.4f} [{smi}]", flush=True)
    family_plans = []
    for name in libs if args.families else ():
        if name in DIAGNOSTIC or name == "parent":
            continue
        use(name)
        for shape, wv, lvl in FAMILIES:
            taps = tw.NDDWT(wv, shape, device=dev).taps_hp
            k = tuple(len(t[0]) for t in taps)
            x = torch.randn(shape, generator=gen, device=dev)
            own = flat._flat_plan(shape, k, torch.float32, 0)
            options = {(own.ends, own.tile)}
            for g in range(1, min(3, len(shape)) + 1):
                ends, tile, cands = flat._group_ends(len(shape), g), list(shape), []
                while math.prod(tile) >= min(flat._FLAT_TILE_MIN, math.prod(shape)):
                    lay = flat.flat_layout(shape, k, tile, ends, 1, 4)
                    if lay["smem"] <= flat._FLAT_SMEM_BUDGET:
                        cands.append((flat._plan_cost(lay, 4), ends, tuple(tile)))
                    if max(tile) == 1:
                        break
                    ax = tile.index(max(tile))
                    tile[ax] = -(-tile[ax] // 2)
                options |= {(e, t) for _, e, t in sorted(cands)[:4]}
            for ends, tile in sorted(options):
                lay = flat.flat_layout(shape, k, tile, ends, 1, 4)
                with forced(shape, ends, tile):
                    ms = queued(lambda: flat.pair_flat(x, taps, lvl, False, THRESHOLD), 3)
                family_plans.append({"build": name, "shape": list(shape), "wavelet": wv,
                                     "level": lvl,
                                     "ends": list(ends), "tile": list(tile),
                                     "smem": lay["smem"], "units": lay["units"],
                                     "cost_us": flat._plan_cost(lay, 4) * lvl,
                                     "own": (ends, tile) == (own.ends, own.tile), "ms": ms})
                print(f"  {name}: family {shape} {wv} L{lvl}: groups {ends} tile {tile} "
                      f"smem {lay['smem']} units {lay['units']} "
                      f"model {family_plans[-1]['cost_us']:.1f} us: {ms:.4f} ms"
                      f"{' (the plan)' if family_plans[-1]['own'] else ''} [{smi}]", flush=True)
            del x
    for shape in (SOLVE_SHAPE, (64, 64, 64)):
        print(f"  _flat_plan {shape}: "
              f"{flat._flat_plan(shape, (8,) * len(shape), torch.float32, 0)}", flush=True)
    use("checkout")
    print(json.dumps({"card": smi, "builds": list(libs), "ptxas": ptxas, "runs": table,
                      "median": medians, "barriers": counts, "plans": plans,
                      "family_plans": family_plans}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
