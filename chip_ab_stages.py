#!/usr/bin/env python3
"""A/B of the 4D stage kernels and the streamed bodies on one NVIDIA GPU.

    python3 chip_ab_stages.py [VARIANT ...]

Builds this checkout's ``ops/csrc/nddwt_4d.cu`` and ``nddwt_level.cu`` and
every variant given: a directory (a copy of ``csrc/`` with a change; both
sources are built from it) or one source file (a copy of ``nddwt_4d.cu`` or
``nddwt_level.cu`` with a change, by its name's prefix; built with the
checkout's ``csrc/`` on the include path). Five variants are built in
(``BUILT_IN``), of the streamed bodies (``csrc/nddwt_stream.cuh``: the
synthesis and the analysis) and the lane body (``csrc/nddwt_lane.cuh``):
"ring in shared memory" sends every filter length of the streamed bodies
to the runtime-tap path (the ring in shared memory, one plane element a
thread, instead of in registers); "two stages" keeps one window copy of
the streamed bodies in flight instead of up to three (the lane body's
buffers are its plan's, swept below); "one CTA per SM" drops the two-CTA
register cap of all three bodies; and two diagnostic builds whose outputs
are wrong, timed only: "copies only" skips the passes and "passes only"
skips the copies (in all three bodies: the lane body's bulk copies are not
issued, its windows left as they are), which shows what each part costs
alone and whether the two overlap.

Each build but the diagnostic ones is held against the kernels' plain
versions at small shapes (an A/B never times a wrong kernel). Then it
times, per build, the four stage kernels at (128, 128, 128, 32) db4
float32 (the two lane stages in float64 too) and ``nddwt_lead_dec`` and
the two lane stages at 128^3 db20 (the 3D long-filter route) with CUDA
events: every build once in the order given, then once in reverse, so the
card's clock drifts against no one build. Then it times this checkout's
kernels over forced launch plans (the plan functions bypassed): the lane
body's plans ``(R, Zc, stages)`` of ``nddwt_lane_dec`` and
``nddwt_lane_adj`` (units of R whole slabs, or chunks of Zc outputs along
Z, and the unit buffers), the streamed plans ``(C, T1, T2)`` of
``nddwt_lead_adj`` and ``nddwt_lead_dec``. ``nddwt_rec_level``'s and
``nddwt_dec_level``'s 3D views of 2 to 8 taps run the plane bodies
(``csrc/nddwt_plane.cuh``), which ``chip_ab_rec.py`` and ``chip_ab_dec.py``
time.

Prints the card's name and power limit first and one JSON object last. It
exits non-zero without a CUDA device or if a build disagrees with the plain
versions.
"""

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

SHAPE = (128, 128, 128, 32)
# The lane body's plans (R, Zc, stages): Zc >= Z (128) marks units of R whole
# slabs, else chunks of Zc outputs along Z (their windows Zc + 7 rows).
LANE_DEC_PLANS = [(1, 128, 4), (1, 128, 3), (1, 128, 2), (2, 128, 2), (1, 64, 4),
                  (1, 64, 2), (1, 32, 4)]
LANE_ADJ_PLANS = [(1, 64, 2), (1, 128, 2), (1, 128, 1), (1, 32, 4), (1, 32, 3), (1, 43, 3),
                  (1, 16, 4)]
# float64 (twice the bytes: whole slabs with two buffers take one CTA an SM)
LANE_DEC64_PLANS = [(1, 128, 1), (1, 128, 2), (1, 64, 4), (1, 64, 2)]
LANE_ADJ64_PLANS = [(1, 64, 1), (1, 32, 2), (1, 128, 1), (1, 32, 4)]
# the 3D db20 route's lane view (16384, 128, 1): units of R whole 128-rows
LANE20_PLANS = [(15, 128, 4), (8, 128, 4), (32, 128, 4), (4, 128, 4), (15, 128, 2),
                (64, 128, 3)]
# Streamed plans (C, T1, T2); T1 * T2 = 256 * 4 where the taps are unrolled.
LEAD_ADJ_PLANS = [(128, 4, 256), (128, 8, 128), (128, 16, 64), (64, 4, 256),
                  (128, 2, 512)]
# The lead analysis: T1 * T2 = 256 * 4.
LEAD_DEC_PLANS = [(128, 4, 256), (128, 8, 128), (128, 16, 64), (64, 4, 256),
                  (128, 2, 512)]
# The lead analysis of the 3D long-filter route (128^3 db20: 40 taps, the
# runtime-tap path, one element a thread), whose chunk reads C + 39 planes.
SHAPE20 = (128, 128, 128)
LEAD_DEC20_PLANS = [(40, 8, 32), (64, 8, 32), (128, 8, 32), (64, 16, 16), (128, 16, 16),
                    (64, 32, 8), (128, 32, 8), (40, 16, 16)]
RING_SMEM = "ring in shared memory"
# The built-in variants: name -> [(header in csrc/, text, replacement)],
# every occurrence replaced (both streamed bodies where the text is in both).
STREAM, LANE = "nddwt_stream.cuh", "nddwt_lane.cuh"
BUILT_IN = {
    RING_SMEM: [(STREAM, "  if (K != 2 && K != 4 && K != 6 && K != 8) return 0;",
                 "  if (K > 0) return 0;")],
    "two stages": [(STREAM, "constexpr int kStreamMaxStages = 4;",
                    "constexpr int kStreamMaxStages = 2;")],
    "one CTA per SM": [(STREAM, "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads)"),
                       (LANE, "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads)")],
    "copies only": [(STREAM, "    cp_commit();\n\n    const int gi = at.gi",
                     "    cp_commit();\n    if (nw > 0) continue;\n\n    const int gi = at.gi"),
                    (LANE, "    if (cx.windows(c + k * G, buf, wins)) __syncthreads();\n",
                     "    continue;\n")],
    "passes only": [(STREAM, "      for (int i = lane; i < hd; i += 32) copy_elem(srow + i, row + col(c0 + i));\n"
                     "      for (int u = lane; u < nv; u += 32)\n"
                     "        copy16(srow + hd + u * V, row + col(c0 + hd + u * V));\n"
                     "      for (int i = tail + lane; i < E2; i += 32) "
                     "copy_elem(srow + i, row + col(c0 + i));\n", ""),
                    (LANE, "if (bk.hi > bk.lo)", "if (false)")],
}
DIAGNOSTIC = ("copies only", "passes only")


def timed(fn, reps=8):
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _built_in_sources(ck, into: Path, name: str) -> Path:
    """A copy of ``csrc/`` with the built-in variant ``name`` applied to its
    headers."""
    d = into / name.replace(" ", "_")
    shutil.copytree(ck.CSRC, d)
    for header, old, new in BUILT_IN[name]:
        p = d / header
        src = p.read_text()
        if old not in src:
            raise RuntimeError(f"{header} has changed: cannot build {name!r}")
        p.write_text(src.replace(old, new))
    return d


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_stages: no CUDA device; this runs only on a GPU",
              file=sys.stderr)
        return 1
    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
    from non_decimated_wavelets_tpu_torch.ops import level4_ref as r4
    from non_decimated_wavelets_tpu_torch.ops import level_ref as r3

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ck.build(("nddwt_level", "nddwt_4d"))
    builds = {"checkout": {"nddwt_level": ck.library_path("nddwt_level"),
                           "nddwt_4d": ck.library_path("nddwt_4d")}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        jobs = []  # (build name, library name, source, include dir)
        variants = [(name, str(_built_in_sources(ck, tmp, name))) for name in BUILT_IN]
        for name, v in variants + [(v, v) for v in sys.argv[1:]]:
            if Path(v).is_dir():
                jobs += [(name, lib, Path(v) / f"{lib}.cu", Path(v))
                         for lib in ("nddwt_level", "nddwt_4d")]
            else:
                lib = "nddwt_level" if Path(v).name.startswith("nddwt_level") else "nddwt_4d"
                jobs.append((name, lib, Path(v), ck.CSRC))
        procs = []
        for i, (name, lib, src, inc) in enumerate(jobs):
            so = tmp / f"v{i}_{lib}.so"
            procs.append((name, lib, so, subprocess.Popen(
                [ck._nvcc(), *ck.NVCC_FLAGS, "-I", str(inc), "-o", str(so), str(src)])))
        for name, lib, so, proc in procs:
            if proc.wait():
                print(f"chip_ab_stages: nvcc failed on {name} ({lib})", file=sys.stderr)
                return 1
            builds.setdefault(name, dict(builds["checkout"]))[lib] = so
        libs, real_library = {}, ck.library
        for name, paths in builds.items():
            ck.load.cache_clear()
            ck.load4.cache_clear()
            ck.library = lambda n, p=paths: (ctypes.CDLL(str(p[n])) if n in p
                                             else real_library(n))
            libs[name] = (ck.load(), ck.load4())
        ck.library = real_library
        return run(torch, tw, ck, r3, r4, libs, smi)


def run(torch, tw, ck, r3, r4, libs, smi) -> int:
    def use(name):
        ck.load = lambda: libs[name][0]
        ck.load4 = lambda: libs[name][1]

    def plan_items(name, plan):
        """Force plan on every streamed launch (the items check: 1 a thread
        on the ring-in-shared-memory build)."""
        ck._stream_plan = lambda *a, t=plan: t
        ck._stream_items = (lambda k: 1) if name == RING_SMEM else real_items

    real_plan, real_items = ck._stream_plan, ck._stream_items
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    wrong = []
    for name in libs:
        if name in DIAGNOSTIC:
            continue
        use(name)
        if name == RING_SMEM:
            plan_items(name, (8, 2, 128))
        for shape, wv in (((12, 10, 9, 7), "db2"), ((40, 41, 45), "db20")):
            taps = tw.NDDWT(wv, shape, device=dev).taps_hp
            x = torch.randn(shape, generator=gen, device=dev)
            temp = r4.lane_dec_ref(x, taps)
            nb = 4 * temp.shape[0]
            bk = torch.zeros((nb,) + shape, device=dev)
            br = bk.clone()
            y = torch.randn((nb,) + shape, generator=gen, device=dev)
            src = [("y", b) for b in range(nb)]
            pairs = [
                (ck.lane_dec(x, taps), temp),
                (ck.lead_dec(temp, bk, 1, taps, 0.1), r4.lead_dec_ref(temp, br, 1, taps, 0.1)),
                (bk, br),
                (ck.lead_adj(y, None, src, taps), r4.lead_adj_ref(y, None, src, taps)),
                (ck.lane_adj(temp, taps, 1 / nb), r4.lane_adj_ref(temp, taps, 1 / nb)),
            ]
            for k, r in pairs:
                if (k - r).abs().max().item() > 1e-5 * r.abs().max().item():
                    wrong.append(f"{name} at {shape} {wv}")
        for shape, wv in (((24, 40, 72), "db4"), ((9, 300), ("db2", "db6"))):
            taps = tw.NDDWT(wv, shape, device=dev).taps_hp
            nb = 2 ** len(shape)
            y = torch.randn((nb,) + shape, generator=gen, device=dev)
            src = [("y", b) for b in range(nb)]
            k, r = ck.rec_level(y, None, src, taps, 0.5), r3.rec_level_ref(y, None, src, taps, 0.5)
            if (k - r).abs().max().item() > 1e-5 * r.abs().max().item():
                wrong.append(f"{name} nddwt_rec_level at {shape} {wv}")
            bk, br = torch.zeros_like(y), torch.zeros_like(y)
            ck.dec_level(y[0], bk, 1, taps, 0.1, True)
            r3.dec_level_ref(y[0], br, 1, taps, 0.1, True)
            if (bk - br).abs().max().item() > 1e-5 * br.abs().max().item():
                wrong.append(f"{name} nddwt_dec_level at {shape} {wv}")
        ck._stream_plan, ck._stream_items = real_plan, real_items
    if wrong:
        print(f"chip_ab_stages: disagrees with the plain versions: {wrong}",
              file=sys.stderr)
        return 1

    taps = tw.NDDWT("db4", SHAPE, device=dev).taps_hp
    x = torch.randn(SHAPE, generator=gen, device=dev)
    temp = torch.randn((4,) + SHAPE, generator=gen, device=dev)
    big = torch.randn((16,) + SHAPE, generator=gen, device=dev)
    taps20 = tw.NDDWT("db20", SHAPE20, device=dev).taps_hp
    temp20 = torch.randn((2,) + SHAPE20, generator=gen, device=dev)
    x20 = torch.randn(SHAPE20, generator=gen, device=dev)
    x64d, temp64 = x.double(), temp.double()
    big20 = torch.empty((8,) + SHAPE20, device=dev)
    src16 = [("y", b) for b in range(16)]
    calls = {
        "nddwt_lane_dec": lambda: ck.lane_dec(x, taps),
        "nddwt_lead_dec": lambda: ck.lead_dec(temp, big, 1, taps),
        "nddwt_lead_adj": lambda: ck.lead_adj(big, None, src16, taps),
        "nddwt_lead_dec db20": lambda: ck.lead_dec(temp20, big20, 1, taps20),
        "nddwt_lane_adj": lambda: ck.lane_adj(temp, taps, 1 / 16),
        "nddwt_lane_dec db20": lambda: ck.lane_dec(x20, taps20),
        "nddwt_lane_adj db20": lambda: ck.lane_adj(temp20, taps20, 1 / 8),
        "nddwt_lane_dec f64": lambda: ck.lane_dec(x64d, taps),
        "nddwt_lane_adj f64": lambda: ck.lane_adj(temp64, taps, 1 / 16),
    }
    out = {"card": smi, "shape": SHAPE, "ms": {}, "lane_plans": {},
           "plans": {}}
    order = [name for name in libs if name != RING_SMEM]
    for name in order + order[::-1]:
        use(name)
        for kernel, fn in calls.items():
            out["ms"].setdefault(name, {}).setdefault(kernel, []).append(timed(fn))
    for name, per in out["ms"].items():
        print(f"{name}: " + "; ".join(f"{k} {v}" for k, v in per.items()), flush=True)
    use("checkout")
    lane_plan = ck._lane_plan
    for kernel, plans in (("nddwt_lane_dec", LANE_DEC_PLANS), ("nddwt_lane_adj", LANE_ADJ_PLANS),
                          ("nddwt_lane_dec db20", LANE20_PLANS),
                          ("nddwt_lane_adj db20", LANE20_PLANS),
                          ("nddwt_lane_dec f64", LANE_DEC64_PLANS),
                          ("nddwt_lane_adj f64", LANE_ADJ64_PLANS)):
        row = {}
        for t in plans:
            ck._lane_plan = lambda *a, t=t: t
            row[str(t)] = timed(calls[kernel])
        ck._lane_plan = lane_plan
        out["lane_plans"][kernel] = row
        print(f"lane plans {kernel}: {row}", flush=True)
    for name, kernel, plans in (
            ("checkout", "nddwt_lead_adj", LEAD_ADJ_PLANS),
            ("checkout", "nddwt_lead_dec", LEAD_DEC_PLANS),
            ("checkout", "nddwt_lead_dec db20", LEAD_DEC20_PLANS)):
        use(name)
        row = {}
        for t in plans:
            plan_items(name, t)
            row[str(t)] = timed(calls[kernel])
        ck._stream_plan, ck._stream_items = real_plan, real_items
        out["plans"][f"{kernel} ({name})"] = row
        print(f"plans {kernel} ({name}): {row}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
