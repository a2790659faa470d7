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

The one-launch flat kernels are timed through the plan, per call, the
same three ways: the 100-iteration 256^2 db4 L3 ``fista_inpaint`` and
``fista_inpaint_split`` solves (preserve_l2, lam 0.05, 40 % sampling; one
``nddwt_flat_iter`` each), 20 ``dec_rec_n`` sweeps at 264^2 (db1, db3) L3
(one ``nddwt_flat_iter``), and the ``dec_rec`` step (threshold 0.1) at
256^2 and at 64^3 db4 L3 (one ``nddwt_flat_pair`` each); each is held once
against the plan's direct path (1e-4 of max|plain|; the solves 2e-3) and
its launches are counted.

The other families the flat kernel serves are timed on ``nddwt_flat_pair``
itself (``ops/flat.pair_flat``, the wrapper both checkouts have), plain
and queued, 5 repeats of 3 calls: the ``dec_rec`` pair (threshold 0.1) at
the largest count the plan sends there, 2^20 in 1D (db4 L3), 2048^2 in 2D
(db4 L3 in float32, bfloat16 and, at 1024^2, float64; db20 L2), 160^3 in
3D (db4 L3), 64^3 at db20 L2 (the stage route's 2^18), (32, 32, 16, 16)
db4 L3 in 4D and (16, 16, 8, 8, 8) db2 L2 in 5D; each checked once by its
round trip at threshold 0 (1e-4 of max|x|; bfloat16 1e-1, float64 1e-10).

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
FLAT_KEYS = ("fista_256_ms", "fista_split_256_ms", "chain_264_ms", "flat_pair_256_ms",
             "flat_pair_64_ms")
KEYS += FLAT_KEYS
# (key, shape, wavelet, level, dtype name): the flat kernel's other families
FAMILIES = (("flat_1d_2p20_ms", (2**20,), "db4", 3, "float32"),
            ("flat_2d_2p22_ms", (2048, 2048), "db4", 3, "float32"),
            ("flat_2d_2p22_bf16_ms", (2048, 2048), "db4", 3, "bfloat16"),
            ("flat_2d_2p20_f64_ms", (1024, 1024), "db4", 3, "float64"),
            ("flat_2d_2p22_db20_ms", (2048, 2048), "db20", 2, "float32"),
            ("flat_3d_160_ms", (160, 160, 160), "db4", 3, "float32"),
            ("flat_3d_64_db20_ms", (64, 64, 64), "db20", 2, "float32"),
            ("flat_4d_2p18_ms", (32, 32, 16, 16), "db4", 3, "float32"),
            ("flat_5d_ms", (16, 16, 8, 8, 8), "db2", 2, "float32"))
KEYS += tuple(f[0] for f in FAMILIES) + tuple(f[0].replace("_ms", "_queued_ms")
                                              for f in FAMILIES)
KEYS += tuple(k.replace("_ms", suffix) for suffix in ("_queued_ms", "_host_ms")
              for k in LANE_KEYS + FLAT_KEYS)


def three_ways(fn, reps):
    """Per call, 5 repeats of ``reps`` calls each: the unqueued time, the
    time queued behind a sleep (the kernels alone) and the host's time."""
    import torch

    for _ in range(3):
        fn()
    plain, queued, host = [], [], []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        plain.append(s.elapsed_time(e) / reps)
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # cycles: about 25 ms
        s.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        e.record()
        torch.cuda.synchronize()
        queued.append(s.elapsed_time(e) / reps)
        host.append((t1 - t0) * 1e3 / reps)
    return plain, queued, host


def flat_calls(tw, torch, gen, out) -> int:
    """Time the one-launch flat kernels' calls through the plan into
    ``out``; 1 if one disagrees with the direct path or launches other
    kernels."""
    from non_decimated_wavelets_tpu_torch.models import fista_inpaint, fista_inpaint_split
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck

    shape = (256, 256)
    plan = tw.NDDWT("db4", shape, preserve_l2=True, device="cuda")
    direct = tw.NDDWT("db4", shape, preserve_l2=True, path="direct", device="cuda")
    mask = (torch.rand(shape, generator=gen, device="cuda") < 0.4).float()
    xs = torch.randn((2,) + shape, generator=gen, device="cuda")
    cplan = tw.NDDWT(("db1", "db3"), (264, 264), device="cuda")
    cdirect = tw.NDDWT(("db1", "db3"), (264, 264), path="direct", device="cuda")
    xc = torch.randn((264, 264), generator=gen, device="cuda")
    lams_n = [0.2 * 0.1 ** (i / 19) for i in range(20)]
    cube = tw.NDDWT("db4", (64, 64, 64), device="cuda")
    cdir = tw.NDDWT("db4", (64, 64, 64), path="direct", device="cuda")
    x3 = torch.randn((64, 64, 64), generator=gen, device="cuda")

    def chain_ref():
        y = xc
        for lam in lams_n:
            y = cdirect.dec_rec(y, 3, threshold=lam, band_axis=0)[1]
        return y

    calls = (  # (key, kernel, calls a repeat, tolerance, the call on a plan)
        ("fista_256_ms", "nddwt_flat_iter", 3, 2e-3,
         lambda p: fista_inpaint(p, mask * xs[0], mask, 0.05, 3, 100)),
        ("fista_split_256_ms", "nddwt_flat_iter", 3, 2e-3,
         lambda p: fista_inpaint_split(p, mask * xs, mask, 0.05, 3, 100)),
        ("chain_264_ms", "nddwt_flat_iter", 5, 1e-4, None),
        ("flat_pair_256_ms", "nddwt_flat_pair", 20, 1e-4,
         lambda p: p.dec_rec(xs[0], 3, threshold=0.1, band_axis=0)[1]),
        ("flat_pair_64_ms", "nddwt_flat_pair", 20, 1e-4, None),
    )
    for key, kernel, reps, tol, solve in calls:
        if key == "chain_264_ms":
            fn, want = (lambda: cplan.dec_rec_n(xc, 3, lams_n)), chain_ref()
        elif key == "flat_pair_64_ms":
            fn = lambda: cube.dec_rec(x3, 3, threshold=0.1, band_axis=0)[1]  # noqa: E731
            want = cdir.dec_rec(x3, 3, threshold=0.1, band_axis=0)[1]
        else:
            fn, want = (lambda s=solve: s(plan)), solve(direct)
        ck.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        launched = {k: v for k, v in ck.launch_counts.items() if v}
        err = (got - want).abs().max().item()
        if launched != {kernel: 1} or err > tol * want.abs().max().item():
            print(f"{key}: launched {launched}, {err} against the direct path",
                  file=sys.stderr)
            return 1
        plain, queued, host = three_ways(fn, reps)
        out[key] = plain
        out[key.replace("_ms", "_queued_ms")] = queued
        out[key.replace("_ms", "_host_ms")] = host
    return 0


def family_calls(tw, torch, gen, out) -> int:
    """Time ``nddwt_flat_pair`` on the families of ``FAMILIES`` into
    ``out``; 1 if a round trip misses."""
    from non_decimated_wavelets_tpu_torch.ops import flat

    for key, shape, wv, level, dtype in FAMILIES:
        dt = getattr(torch, dtype)
        taps = tw.NDDWT(wv, shape, device="cuda").taps_hp
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        err = (flat.pair_flat(x, taps, level, False, 0.0)[1].double()
               - x.double()).abs().max().item()
        tol = {"bfloat16": 1e-1, "float64": 1e-10}.get(dtype, 1e-4)
        if err > tol * x.abs().max().item():
            print(f"{key}: round trip {err}", file=sys.stderr)
            return 1
        plain, queued, _ = three_ways(lambda: flat.pair_flat(x, taps, level, False, 0.1), 3)
        out[key] = plain
        out[key.replace("_ms", "_queued_ms")] = queued
        del x
        torch.cuda.empty_cache()
    return 0


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
    if flat_calls(tw, torch, gen, out) or family_calls(tw, torch, gen, out):
        return 1
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
