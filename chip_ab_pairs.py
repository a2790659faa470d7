#!/usr/bin/env python3
"""A/B of the float32 pairs between two checkouts of the port, on one NVIDIA
GPU.

    python3 chip_ab_pairs.py OTHER_CHECKOUT

Times the 256^3 db4 L3 float32 dec+rec pair and the (128, 128, 128, 32)
db4 L3 float32 pair of this checkout's ``non_decimated_wavelets_tpu_torch``
and of OTHER_CHECKOUT's (the root of another checkout, e.g. the parent
commit unpacked with ``git archive``), each in a fresh process that builds
that checkout's kernels from its own sources, in the order other, this,
this, other, so that the card's clock drifts against neither. Each process
checks its pairs' round trip (1e-4) and times each pair with CUDA events:
5 repeats of 10 (3D) or 3 (4D) pairs after 3 warm-up pairs. It also times
the two synthesis kernels the pairs spend most in, per call: one
``nddwt_rec_level`` level at 256^3 db4 (float32 and float64, 8 bands in)
and one ``nddwt_lead_adj`` at (128, 128, 128, 32) db4 float32 (16 bands
in), and both in their halo-padded mode on one rank's block of a {"x": 2}
mesh (X halved and padded by K - 1 = 7 rows, as ``chip_sharded.py`` times
them), each checked once against its plain version (float32 1e-5, float64
1e-12, relative to max|plain|), 5 repeats of 10 calls after 3 warm-up
calls.

Prints the card's name and power limit first and one JSON object last, with
every repeat and the median per checkout. It exits non-zero without a CUDA
device or if a process fails.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPE = (256, 256, 256)
SHAPE4 = (128, 128, 128, 32)
LEVEL = 3
KEYS = ("pair_3d_ms", "pair_4d_ms", "rec_level_f32_ms", "rec_level_f64_ms", "lead_adj_ms",
        "rec_level_padded_ms", "lead_adj_padded_ms")


def child(root: str) -> int:
    """Time the pairs and the two synthesis kernels of the package found
    at ``root``."""
    sys.path.insert(0, root)
    import torch

    import non_decimated_wavelets_tpu_torch as tw

    if not Path(tw.__file__).resolve().is_relative_to(Path(root).resolve()):
        print(f"imported {tw.__file__}, not the package under {root}", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    kernel_calls = (("rec_level_f32_ms", SHAPE, torch.float32, False),
                    ("rec_level_f64_ms", SHAPE, torch.float64, False),
                    ("lead_adj_ms", SHAPE4, torch.float32, False),
                    ("rec_level_padded_ms", SHAPE, torch.float32, True),
                    ("lead_adj_padded_ms", SHAPE4, torch.float32, True))
    for key, shape, n_call in (("pair_3d_ms", SHAPE, 10), ("pair_4d_ms", SHAPE4, 3)):
        plan = tw.NDDWT("db4", shape, device="cuda")
        x = torch.randn(shape, generator=gen, device="cuda")

        def pair():
            return plan.rec(plan.dec(x, LEVEL, band_axis=0), band_axis=0)

        err = (pair() - x).abs().max().item()
        if err > 1e-4:
            print(f"{key}: round trip {err}", file=sys.stderr)
            return 1
        for _ in range(3):
            pair()
        times = []
        for _ in range(5):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(n_call):
                pair()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e) / n_call)
        out[key] = times
        del plan, x
        torch.cuda.empty_cache()
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
    from non_decimated_wavelets_tpu_torch.ops import level4_ref, level_ref

    for key, shape, dtype, padded in kernel_calls:
        taps = tw.NDDWT("db4", shape, device="cuda").taps_hp
        nb = 2 ** len(shape)
        pad = (padded,) + (False,) * (len(shape) - 1)
        block = (shape[0] // 2 + 7,) + shape[1:] if padded else shape
        y = torch.randn((nb,) + block, generator=gen, device="cuda", dtype=dtype)
        src = [("y", b) for b in range(nb)]
        if len(shape) == 4:
            call = lambda: ck.lead_adj(y, None, src, taps, pad[:2])  # noqa: E731
            want = level4_ref.lead_adj_ref(y, None, src, taps, pad[:2])
        else:
            call = lambda: ck.rec_level(y, None, src, taps, 1 / nb, pad)  # noqa: E731
            want = level_ref.rec_level_ref(y, None, src, taps, 1 / nb, pad)
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        err = (call() - want).abs().max().item()
        if err > tol * want.abs().max().item():
            print(f"{key}: {err} against the plain version", file=sys.stderr)
            return 1
        del want
        for _ in range(3):
            call()
        times = []
        for _ in range(5):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(10):
                call()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e) / 10)
        out[key] = times
        del y
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        return child(sys.argv[2])
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_pairs: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    roots = {"other": str(Path(sys.argv[1]).resolve()),
             "this": str(Path(__file__).resolve().parent)}
    runs = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, __file__, "--child", roots[name]],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(f"chip_ab_pairs: the {name} checkout failed:\n{proc.stderr}",
                  file=sys.stderr)
            return 1
        runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(name, runs[name][-1], flush=True)
    median = {name: {key: statistics.median(t for r in rs for t in r[key])
                     for key in KEYS}
              for name, rs in runs.items()}
    print(json.dumps({"card": smi, "roots": roots, "runs": runs, "median": median}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
