#!/usr/bin/env python3
"""A/B of the 4D stage kernels on one NVIDIA GPU.

    python3 chip_ab_stages.py [VARIANT.cu ...]

Builds this checkout's ``ops/csrc/nddwt_4d.cu`` and every variant source
given (a copy of it with a change; built with the checkout's ``csrc/`` on
the include path), holds each build against the kernels' plain versions at
two small shapes (an A/B never times a wrong kernel), and times the four
stage kernels per build at (128, 128, 128, 32) db4 float32 with CUDA
events: every build once in the order given, then once in reverse, so the
card's clock drifts against no one build. Then it times this checkout's
kernels at a list of tiles forced per launch (the tile plan bypassed).

Prints the card's name and power limit first and one JSON object last. It
exits non-zero without a CUDA device or if a build disagrees with the plain
versions.
"""

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

SHAPE = (128, 128, 128, 32)
LEAD_TILES = [(16, 32, 8), (16, 16, 8), (8, 16, 16), (16, 16, 16), (8, 8, 32),
              (4, 8, 64)]
LANE_TILES = [(1, 128, 32), (1, 64, 32), (2, 64, 32), (1, 32, 32)]


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_stages: no CUDA device; this runs only on a GPU",
              file=sys.stderr)
        return 1
    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
    from non_decimated_wavelets_tpu_torch.ops import level4_ref as r4

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    builds = {"checkout": ck.library_path("nddwt_4d")}
    ck.build(("nddwt_4d",))
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for src in sys.argv[1:]:
            so = Path(tmp) / f"{Path(src).stem}.so"
            procs[src] = (so, subprocess.Popen(
                [ck._nvcc(), *ck.NVCC_FLAGS, "-I", str(ck.CSRC), "-o", str(so), src]))
        for src, (so, proc) in procs.items():
            if proc.wait():
                print(f"chip_ab_stages: nvcc failed on {src}", file=sys.stderr)
                return 1
            builds[src] = so
        libs, real_library = {}, ck.library
        for name, so in builds.items():
            ck.load4.cache_clear()
            ck.library = lambda n, so=so: ctypes.CDLL(str(so)) if n == "nddwt_4d" else real_library(n)
            libs[name] = ck.load4()
        ck.library = real_library
        return run(torch, tw, ck, r4, libs, smi)


def run(torch, tw, ck, r4, libs, smi) -> int:
    def use(name):
        ck.load4 = lambda: libs[name]

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    wrong = []
    for name in libs:
        use(name)
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
    if wrong:
        print(f"chip_ab_stages: disagrees with the plain versions: {wrong}",
              file=sys.stderr)
        return 1

    taps = tw.NDDWT("db4", SHAPE, device=dev).taps_hp
    x = torch.randn(SHAPE, generator=gen, device=dev)
    temp = torch.randn((4,) + SHAPE, generator=gen, device=dev)
    big = torch.randn((16,) + SHAPE, generator=gen, device=dev)
    src16 = [("y", b) for b in range(16)]
    calls = {
        "nddwt_lane_dec": (lambda: ck.lane_dec(x, taps), True),
        "nddwt_lead_dec": (lambda: ck.lead_dec(temp, big, 1, taps), False),
        "nddwt_lead_adj": (lambda: ck.lead_adj(big, None, src16, taps), False),
        "nddwt_lane_adj": (lambda: ck.lane_adj(temp, taps, 1 / 16), True),
    }
    out = {"card": smi, "shape": SHAPE, "ms": {}, "tiles": {}}
    order = list(libs)
    for name in order + order[::-1]:
        use(name)
        for kernel, (fn, _) in calls.items():
            out["ms"].setdefault(name, {}).setdefault(kernel, []).append(timed(fn))
    for name, per in out["ms"].items():
        print(f"{name}: " + "; ".join(f"{k} {v}" for k, v in per.items()), flush=True)
    use("checkout")
    plan_tiles = ck._stage_tiles
    for kernel, (fn, lane) in calls.items():
        row = {}
        for t in LANE_TILES if lane else LEAD_TILES:
            ck._stage_tiles = lambda n, k, lane_, adj, word, t=t: t
            row[str(t)] = timed(fn)
        ck._stage_tiles = plan_tiles
        out["tiles"][kernel] = row
        print(f"tiles {kernel}: {row}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
