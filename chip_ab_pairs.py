#!/usr/bin/env python3
"""A/B of the float32 pairs between two checkouts of the port, on one NVIDIA
GPU.

    python3 chip_ab_pairs.py OTHER_CHECKOUT

Times the 256^3 db4 L3 float32 dec+rec pair, the (128, 128, 128, 32) db4
L3 pair in float32, float64 and bfloat16 and the 128^3 db20 L2 float32
``dec_rec`` step (threshold 0.1: the 3D long-filter route, on the stage
kernels) of this checkout's
``non_decimated_wavelets_tpu_torch`` and of OTHER_CHECKOUT's (the root of
another checkout, e.g. the parent commit unpacked with ``git archive``),
each in a fresh process that builds that checkout's kernels from its own
sources, in the order other, this, this, other, so that the card's clock
drifts against neither. Each process checks its pairs' round trip (1e-4
of max|x|; float64 1e-10, bfloat16 1e-1) and times each pair with CUDA
events: 5 repeats of 10 (3D) or 3 (4D) pairs after 3 warm-up pairs. It
also times, per call, the kernels the pairs spend most in: one
``nddwt_rec_level`` and one
``nddwt_dec_level`` level at 256^3 db4 (float32 and float64, 8 bands in or
out) and one ``nddwt_lead_adj`` and one ``nddwt_lead_dec`` at (128, 128,
128, 32) db4 float32 (16 bands in or out, 4 lane bands out or in), each in
its halo-padded mode on one rank's block of a {"x": 2} mesh (X halved and
padded by K - 1 = 7 rows, as ``chip_sharded.py`` times them); the two
lane stages at (128, 128, 128, 32) db4 (``nddwt_lane_dec``: 1 array in, 4
lane bands out; ``nddwt_lane_adj``: 4 in, 1 out); and the two lead and two
lane stages of the db20 step (2 lane bands, all four on their runtime-tap
paths). Each is checked once against its plain version (float32 1e-5,
float64 1e-12, relative to max|plain|) and timed in 5 repeats of 10 calls
after 3 warm-up calls. The four lane stages are also timed queued
(``*_queued_ms``): the 10 calls enqueued behind a ~25 ms ``torch.cuda._sleep``,
so that the card runs them back to back and the events read the kernels
alone, never a gap where the card waits for the host; and the host's own
time per call, wrapper and launch, over those same calls (``*_host_ms``).
Where a call's host time exceeds its queued time, the unqueued time reads
the host.

Prints the card's name and power limit first and one JSON object last, with
every repeat and the median per checkout. It exits non-zero without a CUDA
device or if a process fails.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SHAPE = (256, 256, 256)
SHAPE4 = (128, 128, 128, 32)
SHAPE20 = (128, 128, 128)
LEVEL = 3
KEYS = ("pair_3d_ms", "pair_4d_ms", "step_db20_ms", "rec_level_f32_ms", "rec_level_f64_ms", "lead_adj_ms",
        "rec_level_padded_ms", "lead_adj_padded_ms", "dec_level_f32_ms", "dec_level_f64_ms",
        "lead_dec_ms", "dec_level_padded_ms", "lead_dec_padded_ms", "lead_dec_db20_ms",
        "lead_adj_db20_ms", "pair_4d_f64_ms", "pair_4d_bf16_ms", "lane_dec_ms", "lane_adj_ms",
        "lane_dec_db20_ms", "lane_adj_db20_ms")
LANE_KEYS = ("lane_dec_ms", "lane_adj_ms", "lane_dec_db20_ms", "lane_adj_db20_ms")
KEYS += tuple(k.replace("_ms", suffix) for suffix in ("_queued_ms", "_host_ms")
              for k in LANE_KEYS)


def child(root: str) -> int:
    """Time the pairs and the four level and lead-stage kernels of the
    package found at ``root``."""
    sys.path.insert(0, root)
    import torch

    import non_decimated_wavelets_tpu_torch as tw

    if not Path(tw.__file__).resolve().is_relative_to(Path(root).resolve()):
        print(f"imported {tw.__file__}, not the package under {root}", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    # (key, kernel, shape, wavelet, dtype, X halo-padded); the lead stages
    # of a 3D shape are its long-filter route (2 lane bands)
    kernel_calls = (("rec_level_f32_ms", "rec", SHAPE, "db4", torch.float32, False),
                    ("rec_level_f64_ms", "rec", SHAPE, "db4", torch.float64, False),
                    ("lead_adj_ms", "lead_adj", SHAPE4, "db4", torch.float32, False),
                    ("rec_level_padded_ms", "rec", SHAPE, "db4", torch.float32, True),
                    ("lead_adj_padded_ms", "lead_adj", SHAPE4, "db4", torch.float32, True),
                    ("dec_level_f32_ms", "dec", SHAPE, "db4", torch.float32, False),
                    ("dec_level_f64_ms", "dec", SHAPE, "db4", torch.float64, False),
                    ("lead_dec_ms", "lead_dec", SHAPE4, "db4", torch.float32, False),
                    ("dec_level_padded_ms", "dec", SHAPE, "db4", torch.float32, True),
                    ("lead_dec_padded_ms", "lead_dec", SHAPE4, "db4", torch.float32, True),
                    ("lead_dec_db20_ms", "lead_dec", SHAPE20, "db20", torch.float32, False),
                    ("lead_adj_db20_ms", "lead_adj", SHAPE20, "db20", torch.float32, False),
                    ("lane_dec_ms", "lane_dec", SHAPE4, "db4", torch.float32, False),
                    ("lane_adj_ms", "lane_adj", SHAPE4, "db4", torch.float32, False),
                    ("lane_dec_db20_ms", "lane_dec", SHAPE20, "db20", torch.float32, False),
                    ("lane_adj_db20_ms", "lane_adj", SHAPE20, "db20", torch.float32, False))
    for key, shape, wv, n_call, dtype in (("pair_3d_ms", SHAPE, "db4", 10, torch.float32),
                                          ("pair_4d_ms", SHAPE4, "db4", 3, torch.float32),
                                          ("step_db20_ms", SHAPE20, "db20", 10, torch.float32),
                                          ("pair_4d_f64_ms", SHAPE4, "db4", 3, torch.float64),
                                          ("pair_4d_bf16_ms", SHAPE4, "db4", 3,
                                           torch.bfloat16)):
        plan = tw.NDDWT(wv, shape, dtype=dtype, device="cuda")
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        if wv == "db20":
            def pair():
                return plan.dec_rec(x, 2, threshold=0.1, band_axis=0)[1]
        else:
            def pair():
                return plan.rec(plan.dec(x, LEVEL, band_axis=0), band_axis=0)

        err = (plan.rec(plan.dec(x, 2 if wv == "db20" else LEVEL, band_axis=0),
                        band_axis=0).double() - x.double()).abs().max().item()
        if err > {torch.float64: 1e-10, torch.bfloat16: 1e-1}.get(dtype, 1e-4) * x.abs().max().item():
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

    for key, kind, shape, wv, dtype, padded in kernel_calls:
        taps = tw.NDDWT(wv, shape, device="cuda").taps_hp
        nb = 2 ** len(shape)
        nl = 2 ** (len(shape) - 2)  # the lead stages' lane bands
        pad = (padded,) + (False,) * (len(shape) - 1)
        block = (shape[0] // 2 + 7,) + shape[1:] if padded else shape
        out_shape = (shape[0] // 2,) + shape[1:] if padded else shape
        if kind in ("lane_dec", "lane_adj"):  # 1 array in and nl lane bands out, or back
            adj = kind == "lane_adj"
            y = torch.randn(((nl,) if adj else ()) + shape, generator=gen, device="cuda",
                            dtype=dtype)
            if adj:
                call = lambda: ck.lane_adj(y, taps, 1 / nb)  # noqa: E731
                want = level4_ref.lane_adj_ref(y, taps, 1 / nb)
            else:
                call = lambda: ck.lane_dec(y, taps)  # noqa: E731
                want = level4_ref.lane_dec_ref(y, taps)
        elif kind in ("dec", "lead_dec"):  # the analysis: 1 or nl inputs, nb bands out
            lead = kind == "lead_dec"
            y = torch.randn(((nl,) if lead else ()) + block, generator=gen,
                            device="cuda", dtype=dtype)
            big = torch.empty((nb,) + out_shape, device="cuda", dtype=dtype)
            kernel, plain = ((ck.lead_dec, level4_ref.lead_dec_ref) if lead
                             else (ck.dec_level, level_ref.dec_level_ref))
            flags = pad[:2] if lead else pad
            call = lambda: kernel(y, big, 1, taps, 0.0, True, flags) or big  # noqa: E731
            want = big.clone()
            plain(y, want, 1, taps, 0.0, True, flags)
        else:
            y = torch.randn((nb,) + block, generator=gen, device="cuda", dtype=dtype)
            src = [("y", b) for b in range(nb)]
            if kind == "lead_adj":
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
        if key in LANE_KEYS:  # the kernels alone, and the host's time a call
            queued, host = [], []
            for _ in range(5):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                torch.cuda._sleep(50_000_000)  # cycles: about 25 ms
                s.record()
                t0 = time.perf_counter()
                for _ in range(10):
                    call()
                t1 = time.perf_counter()
                e.record()
                torch.cuda.synchronize()
                queued.append(s.elapsed_time(e) / 10)
                host.append((t1 - t0) * 1e3 / 10)
            out[key.replace("_ms", "_queued_ms")] = queued
            out[key.replace("_ms", "_host_ms")] = host
        del y, call
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
