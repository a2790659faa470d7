#!/usr/bin/env python3
"""Profile the torch port's 256^3 db4 L3 pair and solvers, its 4D pair and
4D CS-MRI solver, its float64 and 1D pairs and a reference-style class, on
one NVIDIA GPU.

    python3 chip_profile.py

Prints the card's name, power limit and SM clock (before and after the
runs), then:

1. the dec+rec pair and the fused dec_rec step (threshold 0.1), in float32,
   bfloat16 and float64: 7 repeats of 10 calls each after 3 warm-up calls,
   timed with CUDA events, in ms per call, sorted;
2. 5 float32 pairs under ``torch.profiler``: device busy time, the device's
   idle share of the host-clock window (first launch to the final
   synchronize) and of the device span (first kernel start to last kernel
   end), and device time per kernel;
3. the same for one 3-iteration run of each FISTA solver (``fista_inpaint``,
   ``fista_inpaint_split``, ``fista_cs_mri``; float32, preserve_l2, lam
   0.05, 40 % sampling) after one warm-up run;
4. the 4D window: the (128, 128, 128, 32) db4 L3 float32 pair timed as in
   1, 3 pairs under ``torch.profiler``, and one 3-iteration run of
   ``fista_cs_mri`` on complex (128, 128, 64, 32) k-t data, profiled as in 3;
5. 3 float64 256^3 pairs, 5 float32 2^23-sample db6 L4 1D pairs, and 3
   dec+rec calls of ``nd_dwt_3D`` at the reference's (164, 64, 40)
   (db1, db3, db9) L2 on complex double data with ``compute='gpu'`` and
   with ``'gpu_off'`` (NumPy in and out: the copies show as idle device
   time), each profiled as in 2.

The last line is one JSON object with all of it. It exits non-zero
without a CUDA device. ``chip_smoke.py`` is the correctness check; this
script only measures.
"""

import json
import subprocess
import sys
import time

SHAPE = (256, 256, 256)
SHAPE4 = (128, 128, 128, 32)
CS_SHAPE4 = (128, 128, 64, 32)
N1 = 2**23
CLASS_SHAPE = (164, 64, 40)
LEVEL = 3
THRESHOLD = 0.1


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def repeats(fn, n_rep=7, n_call=10):
    import torch

    for _ in range(3):
        fn()
    out = []
    for _ in range(n_rep):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n_call):
            fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / n_call)
    return sorted(out)


def busy_time(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profiled(fn) -> dict:
    """Run ``fn`` under ``torch.profiler``: the device's busy time, its idle
    share of the host-clock window and of the device span, and its time per
    kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    iv = [(ev.time_range.start, ev.time_range.end) for ev in dev]
    busy = busy_time(iv)
    span = max(e for _, e in iv) - min(s for s, _ in iv) if iv else 0.0
    by_name = {}
    for ev in dev:
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    return dict(
        wall_us=wall_us,
        device_busy_us=busy,
        device_span_us=span,
        idle_share_of_wall=1 - busy / wall_us,
        idle_share_of_span=1 - busy / span if span else None,
        device_us_by_kernel=dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this runs only on a GPU",
              file=sys.stderr)
        return 1
    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch.models import (
        fista_cs_mri, fista_inpaint, fista_inpaint_split)

    out = {"card_before": card()}
    print(out["card_before"], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, device="cuda", generator=gen)
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        plan = tw.NDDWT("db4", SHAPE, dtype=dt, device="cuda")
        xd = x.to(dt)
        runs = {
            "pair": lambda: plan.rec(plan.dec(xd, LEVEL, band_axis=0), band_axis=0),
            "step": lambda: plan.dec_rec(xd, LEVEL, threshold=THRESHOLD, band_axis=0),
        }
        for name, fn in runs.items():
            key = f"{name}_{str(dt).removeprefix('torch.')}_ms"
            out[key] = repeats(fn)
            print(key, out[key], flush=True)

    plan = tw.NDDWT("db4", SHAPE, device="cuda")
    for _ in range(3):
        plan.rec(plan.dec(x, LEVEL, band_axis=0), band_axis=0)
    out["pairs"] = profiled(
        lambda: [plan.rec(plan.dec(x, LEVEL, band_axis=0), band_axis=0)
                 for _ in range(5)])

    splan = tw.NDDWT("db4", SHAPE, preserve_l2=True, device="cuda")
    xi = torch.randn(SHAPE, device="cuda", generator=gen)
    mask = (torch.rand(SHAPE, device="cuda", generator=gen) < 0.4).float()
    solvers = {
        "fista_inpaint": lambda: fista_inpaint(splan, mask * x, mask, 0.05,
                                               LEVEL, 3),
        "fista_inpaint_split": lambda: fista_inpaint_split(
            splan, mask * torch.stack([x, xi]), mask, 0.05, LEVEL, 3),
        "fista_cs_mri": lambda: fista_cs_mri(
            splan, mask * torch.fft.fftn(x, norm="ortho"), mask, 0.05, LEVEL, 3),
    }
    for name, fn in solvers.items():
        fn()
        out[name] = profiled(fn)
    del x, xi, mask, solvers
    torch.cuda.empty_cache()

    plan4 = tw.NDDWT("db4", SHAPE4, device="cuda")
    x4 = torch.randn(SHAPE4, device="cuda", generator=gen)

    def pair4():
        return plan4.rec(plan4.dec(x4, LEVEL, band_axis=0), band_axis=0)

    out["pair4_float32_ms"] = repeats(pair4, n_rep=5, n_call=3)
    print("pair4_float32_ms", out["pair4_float32_ms"], flush=True)
    out["pairs4"] = profiled(lambda: [pair4() for _ in range(3)])
    del x4
    torch.cuda.empty_cache()
    splan4 = tw.NDDWT("db4", CS_SHAPE4, preserve_l2=True, device="cuda")
    mask4 = (torch.rand(CS_SHAPE4, device="cuda", generator=gen) < 0.4).float()
    kt = mask4 * torch.fft.fftn(torch.randn(CS_SHAPE4, device="cuda", generator=gen),
                                norm="ortho")
    fn = lambda: fista_cs_mri(splan4, kt, mask4, 0.05, LEVEL, 3)  # noqa: E731
    fn()
    out["fista_cs_mri_4d"] = profiled(fn)
    del kt, mask4
    torch.cuda.empty_cache()

    plan64 = tw.NDDWT("db4", SHAPE, dtype="double", device="cuda")
    x64 = torch.randn(SHAPE, device="cuda", generator=gen, dtype=torch.float64)
    pair64 = lambda: plan64.rec(plan64.dec(x64, LEVEL, band_axis=0), band_axis=0)  # noqa: E731
    pair64()
    out["pairs_float64"] = profiled(lambda: [pair64() for _ in range(3)])
    del x64
    plan1 = tw.NDDWT("db6", (N1,), device="cuda")
    x1 = torch.randn(N1, device="cuda", generator=gen)
    pair1 = lambda: plan1.rec(plan1.dec(x1, 4, band_axis=0), band_axis=0)  # noqa: E731
    pair1()
    out["pairs_1d"] = profiled(lambda: [pair1() for _ in range(5)])
    import numpy as np

    z = np.random.default_rng(0).standard_normal(CLASS_SHAPE + (2,)) @ np.array([1, 1j])
    for compute in ("gpu", "gpu_off"):
        t = tw.nd_dwt_3D(("db1", "db3", "db9"), CLASS_SHAPE, compute=compute, device="cuda")
        zin = torch.from_numpy(z).cuda() if compute == "gpu" else z
        t.rec(t.dec(zin, 2))
        out[f"class_3d_{compute}"] = profiled(
            lambda: [t.rec(t.dec(zin, 2)) for _ in range(3)])
    windows = ["pairs", "fista_inpaint", "fista_inpaint_split", "fista_cs_mri",
               "pairs4", "fista_cs_mri_4d", "pairs_float64", "pairs_1d",
               "class_3d_gpu", "class_3d_gpu_off"]
    out["card_after"] = card()
    if not all(out[k]["device_busy_us"] for k in windows):
        print("chip_profile: the profiler saw no device time", file=sys.stderr)
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
