#!/usr/bin/env python3
"""A/B of the one-launch multilevel kernels on one NVIDIA GPU.

    python3 chip_ab_multi.py [VARIANT.cu ...]

Builds this checkout's ``ops/csrc/nddwt_multi.cu`` and every variant source
given (a copy of it with a change and the same C interface; built with the
checkout's ``csrc/`` on the include path), holds each build against the
kernels' plain versions (``ops/multi_ref.py``) at a small odd shape (an A/B
never times a wrong kernel), and times ``nddwt_dec_multi`` and
``nddwt_rec_multi`` per build with CUDA events, db4 L3 float32, at 128^3,
(256, 128, 128), 2048^2 and a batch of 16 x 256^2, beside the per-level
kernels' chains at the same shapes (L launches per item and direction),
after printing what ``ptxas`` reports for each build (registers, stack):
every build once in the order given, the per-level chains, then every build
once in reverse, so the card's clock drifts against no one build.

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

LEVEL = 3
SHAPES = (((128, 128, 128), 1), ((256, 128, 128), 1), ((2048, 2048), 1),
          ((256, 256), 16))


def timed(fn, reps=10):
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
        print("chip_ab_multi: no CUDA device; this runs only on a GPU",
              file=sys.stderr)
        return 1
    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
    from non_decimated_wavelets_tpu_torch.ops import multi, multi_ref

    import chip_flat_crossover as xover

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    sources = {"checkout": ck.CSRC / "nddwt_multi.cu",
               **{Path(v).name: Path(v).resolve() for v in sys.argv[1:]}}
    checkout_load = multi.load
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {
            name: subprocess.Popen(
                [ck._nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(ck.CSRC),
                 "-o", str(Path(tmp) / f"{i}.so"), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i, (name, src) in enumerate(sources.items())}
        for i, (name, proc) in enumerate(procs.items()):
            out, _ = proc.communicate()
            if proc.returncode:
                print(f"nvcc failed on {name}:\n{out}", file=sys.stderr)
                return 1
            print(f"  {name}: " + "; ".join(  # registers and stack per kernel
                line.split("info    : ")[-1] for line in out.splitlines()
                if "registers" in line))
            libs[name] = ctypes.CDLL(str(Path(tmp) / f"{i}.so"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def use(name):
        """Route the wrappers through build ``name``, declared as
        ``multi.load`` declares the checkout's."""
        multi.load.cache_clear()
        real = ck.library
        ck.library = lambda _: libs[name]
        try:
            checkout_load()
        finally:
            ck.library = real

    taps = tw.NDDWT("db4", (37, 29, 41), device=dev).taps_hp
    x = torch.randn((2, 37, 29, 41), generator=gen, device=dev)
    ref = multi_ref.dec_multi_ref(x, taps, LEVEL, 0.1)
    ref_x = multi_ref.rec_multi_ref(ref, taps, LEVEL, 0.125)
    for name in libs:
        use(name)
        bands = multi.dec_multi(x, taps, LEVEL, 0.1)
        back = multi.rec_multi(ref, taps, LEVEL, False)
        err = max((bands - ref).abs().max().item() / ref.abs().max().item(),
                  (back - ref_x).abs().max().item() / ref_x.abs().max().item())
        print(f"  {name}: max error {err:.3e} relative to the plain versions")
        if err > 1e-5:
            print(f"chip_ab_multi: {name} disagrees with the plain versions",
                  file=sys.stderr)
            return 1
    table = []
    for shape, items in SHAPES:
        taps = tw.NDDWT("db4", shape, device=dev).taps_hp
        x = torch.randn((items,) + shape, generator=gen, device=dev)
        y = multi.dec_multi(x, taps, LEVEL)
        row = {"shape": list(shape), "items": items}
        order = list(libs) + ["per-level"] + list(libs)[::-1]
        for name in order:
            if name == "per-level":
                with xover.limits(0, 0, 0):
                    times = (
                        timed(lambda: [ck.dec_levels(v, taps, LEVEL) for v in x]),
                        timed(lambda: [ck.rec_levels(v, taps, LEVEL, False) for v in y]))
            else:
                use(name)
                times = (timed(lambda: multi.dec_multi(x, taps, LEVEL)),
                         timed(lambda: multi.rec_multi(y, taps, LEVEL, False)))
            row.setdefault(name, []).append(times)
        table.append(row)
        print(f"  {items} x {shape} db4 L{LEVEL} f32, ms per call (dec, rec): "
              + " | ".join(f"{n} " + ", ".join(
                  f"{sum(t[i] for t in row[n]) / len(row[n]):.4f}" for i in (0, 1))
                  for n in dict.fromkeys(order)) + f" [{smi}]")
        del x, y
    use("checkout")
    print(json.dumps({"card": smi, "builds": list(libs), "table": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
