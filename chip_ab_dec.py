#!/usr/bin/env python3
"""``nddwt_dec_level`` on one NVIDIA GPU: checks, A/B against another
checkout, and plan sweeps of the analysis plane body.

    python3 chip_ab_dec.py --check
    python3 chip_ab_dec.py [--parent OTHER_CHECKOUT] [--sweep] [VARIANT ...]

``--check`` builds this checkout's ``nddwt_level.cu``, prints the registers,
stack and spills ``ptxas`` reports for every instantiation of the analysis
plane body (``plane_ana_kernel`` in ``csrc/nddwt_plane.cuh``) and the window
body's analysis, and holds ``ops.cuda_kernels.dec_level`` against
``level_ref.dec_level_ref`` (float32 1e-5, float64 1e-12, bfloat16 1e-2,
relative to max|plain|) over ``CASES``, each with ``lam`` 0 and 0.1 and
``final`` both ways: every dtype and filter length of the plane body, tiles
straddling the periodic wrap on both in-plane axes, whole-row windows and
row pieces, ragged tiles and chunks, each axis halo-padded, and views the
window body keeps (2D, db5, mixed filters, rows off 16 bytes). Each case
also checks the body the launch took against ``_dec_body`` (the counter
``nddwt.dec_level.body.*``: the body the wrapper names, which the library
runs or refuses), and where the plane body ran, holds it against
the window body on the same input moved off 16 bytes. Then it prints that
counter and the launch counts of one denoising call and one FISTA CS-MRI
iteration at knee3d's (320, 320, 256).

Without ``--check`` it times one ``nddwt_dec_level`` launch a call with
CUDA events (``chip_ab_rec._timed``: 3 warm-up calls, then 5 repeats of 10
calls, queued behind a sleep too, and the host's time a call) at the shapes
of ``TIMED``: knee3d's (320, 320, 256) and 256^3 db4, plain and with the
shrink, in float32, float64 and bfloat16 at knee3d, float64 at 256^3 and
the {"x": 2} block of 256^3 halo-padded on X, each checked once against
the plain version at 256^3 first, and prints the body each took.
With ``--parent`` the same runs in a fresh process for each checkout, each
importing and building its own package, in the order other, this, this,
other. ``--sweep`` times this checkout's float32 launches over the forced
plans of ``SWEEP`` (``_plane_ana_plan`` bypassed), in the order given and
then reversed. Each VARIANT is a copy of ``csrc/`` with one change, whose
``nddwt_level.cu`` is built and timed beside this checkout's build at
knee3d in float32, plain and with the shrink, every build in turn and then
in reverse, each checked first against the plain version; ``DIR:C,T1,T2``
times that build on the plan given instead of ``_plane_ana_plan``'s.

Prints the card's name and power limit first and one JSON object last. Exits
non-zero without a CUDA device or if a launch disagrees with its plain
version.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

from chip_ab_rec import _card, _timed

ROOT = Path(__file__).resolve().parent
# (output shape, wavelet, dtype name, halo-padded axes, forced plan or None,
# the body the launch takes)
CASES = [
    ((8, 12, 16), "db4", "float32", None, None, "plane"),  # slot 0 of extent K
    ((9, 10, 12), "db1", "float64", None, None, "plane"),
    ((10, 16, 24), "db2", "bfloat16", None, None, "plane"),
    ((12, 14, 16), "db3", "float32", None, None, "plane"),
    ((12, 14, 16), "db3", "float64", None, None, "plane"),
    ((9, 12, 20), "db4", "float32", None, (9, 64, 16), "plane"),  # tiles wider than n1, n2
    ((11, 40, 36), "db2", "float32", None, (4, 8, 128), "plane"),  # ragged rows and chunk
    ((11, 20, 40), "db2", "float32", None, (4, 32, 32), "plane"),  # row pieces, ragged
    ((10, 20, 34), "db4", "float64", None, (3, 16, 32), "plane"),
    ((12, 24, 72), "db3", "bfloat16", None, (5, 32, 32), "plane"),
    ((12, 9, 12), "db2", "float32", (True, False, False), None, "plane"),
    ((10, 12, 16), "db4", "float64", (False, True, False), None, "plane"),
    ((10, 9, 13), "db2", "float32", (False, False, True), None, "plane"),
    ((11, 12, 15), "db1", "bfloat16", (True, True, True), None, "plane"),
    ((40, 48, 64), "db4", "float32", None, None, "plane"),
    ((24, 40, 72), "db4", "bfloat16", None, None, "plane"),
    ((11, 21, 37), "db2", "float32", None, None, "window"),  # rows off 16 bytes
    ((10, 12, 14), ("db2", "db3", "db4"), "float64", None, None, "window"),
    ((12, 12, 16), "db5", "float32", None, None, "window"),
    ((9, 300), ("db2", "db6"), "float32", None, None, "window"),  # 2D
]
SHAPE, KNEE = (256, 256, 256), (320, 320, 256)
# key -> (shape, dtype name, lam, X halo-padded: the {"x": 2} block of the
# shape, as chip_ab_pairs.py times it)
TIMED = {
    "dec_knee_f32_ms": (KNEE, "float32", 0.0, False),
    "dec_knee_f32_shrink_ms": (KNEE, "float32", 0.1, False),
    "dec_256_f32_ms": (SHAPE, "float32", 0.0, False),
    "dec_256_f32_shrink_ms": (SHAPE, "float32", 0.1, False),
    "dec_knee_f64_ms": (KNEE, "float64", 0.0, False),
    "dec_knee_bf16_ms": (KNEE, "bfloat16", 0.0, False),
    "dec_256_f64_ms": (SHAPE, "float64", 0.0, False),
    "dec_256_padded_ms": (SHAPE, "float32", 0.0, True),
}
# Forced plans (C, T1, T2) per TIMED key: T1 * T2 = 1024 in float32; a tile
# of 256 columns spans the rows (whole-row windows).
SWEEP = {
    "dec_knee_f32_shrink_ms": [(107, 4, 256), (80, 4, 256), (160, 4, 256), (107, 2, 512),
                               (107, 8, 128)],
    "dec_256_f32_ms": [(64, 4, 256), (43, 4, 256), (128, 4, 256), (64, 8, 128)],
}


def _err(got, ref) -> float:
    return (got.double() - ref.double()).abs().max().item() / ref.double().abs().max().item()


def _check(torch, tw, ck, level_ref, tracing) -> list:
    """The CASES on the card; returns what disagreed."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    wrong = []
    real_plan = ck._plane_ana_plan
    for shape, wv, dname, padded, plan, want in CASES:
        dtype = getattr(torch, dname)
        tol = {"float64": 1e-12, "bfloat16": 1e-2}.get(dname, 1e-5)
        if plan is not None:
            ck._plane_ana_plan = lambda *a, t=plan: t
        taps = tw.NDDWT(wv, shape, device="cuda").taps_hp
        pad = padded or (False,) * len(shape)
        ins = tuple(n + (t.shape[1] - 1 if p else 0) for n, t, p in zip(shape, taps, pad))
        numel = 1
        for m in ins:
            numel *= m
        # x, and the same input one element into a larger buffer (off 16 bytes)
        x = torch.randn(ins, generator=gen, device="cuda").to(dtype)
        moved = torch.empty(numel + 1, dtype=dtype, device="cuda")[1:].view(ins).copy_(x)
        nb = 2 ** len(shape)
        for lam, final in ((0.0, False), (0.1, True), (0.1, False), (0.0, True)):
            outs = []
            for inp in (x, moved):
                big = torch.zeros((2 * nb - 1,) + shape, dtype=dtype, device="cuda")
                tracing.reset()
                tracing.enable()
                a = ck.dec_level(inp, big, nb, taps, lam, final, padded)
                torch.cuda.synchronize()
                tracing.disable()
                body = [k.rsplit(".", 1)[1] for k in tracing.summary()["counters"]
                        if k.startswith("nddwt.dec_level.body.")]
                outs.append((big, a, body))
            rb = torch.zeros((2 * nb - 1,) + shape, dtype=dtype)
            ra = level_ref.dec_level_ref(x.cpu(), rb, nb, taps, lam, final, padded)
            (big, a, body), (mbig, ma, mbody) = outs
            errs = [_err(big.cpu(), rb)] + ([] if final else [_err(a.cpu(), ra)])
            # the plane body against the window body on the same input
            if body == ["plane"]:
                errs += [_err(big, mbig)] + ([] if final else [_err(a, ma)])
            tag = f"{shape} {wv} {dname} padded={padded} plan={plan} lam={lam} final={final}"
            print(f"check {tag}: err {max(errs):.3e} body {body} moved {mbody}", flush=True)
            if not max(errs) <= tol or body != [want] or mbody != ["window"]:
                wrong.append(tag)
        ck._plane_ana_plan = real_plan
    return wrong


def _ptxas(ck) -> None:
    """Print ptxas's registers and spills of the analysis kernels of
    nddwt_level.cu, one line a kernel."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [ck._nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v", "-o", f"{tmp}/v.so",
             str(ck.CSRC / "nddwt_level.cu")], capture_output=True, text=True)
    name, info = None, []
    for line in (proc.stdout + proc.stderr).splitlines() + ["Compiling entry function"]:
        if "Compiling entry function" in line:
            if name and "ana_kernel" in name:
                print(f"ptxas {name}: {' '.join(info)}", flush=True)
            name = line.split("'")[1] if "'" in line else line
            name, info = name[name.find("ana_kernel") - 6:name.find("EEvPKT")], []
        elif "registers" in line or "spill" in line:
            info.append(line.split(":", 1)[-1].strip())


def _time_all(torch, tw, ck, level_ref, tracing, keys, check=True) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for key in keys:
        shape, dname, lam, padded = TIMED[key]
        dtype = getattr(torch, dname)
        pad = (True, False, False) if padded else None
        if padded:
            shape = (shape[0] // 2,) + shape[1:]
        taps = tw.NDDWT("db4", shape, device="cuda").taps_hp
        ins = (shape[0] + (7 if padded else 0),) + shape[1:]
        x = torch.randn(ins, generator=gen, device="cuda").to(dtype)
        big = torch.empty((8,) + shape, dtype=dtype, device="cuda")
        call = lambda: ck.dec_level(x, big, 1, taps, lam, True, pad)  # noqa: E731
        if check and shape[1:] == SHAPE[1:]:  # the plain version at 256^3 only
            call()
            ref = torch.empty((8,) + shape, dtype=dtype)
            level_ref.dec_level_ref(x.cpu(), ref, 1, taps, lam, True, pad)
            tol = {"float64": 1e-12, "bfloat16": 1e-2}.get(dname, 1e-5)
            if _err(big.cpu(), ref) > tol:
                raise RuntimeError(f"{key}: {_err(big.cpu(), ref)} against the plain version")
            del ref
        tracing.reset()
        tracing.enable()
        call()
        tracing.disable()
        out[key.replace("_ms", "_body")] = [k.rsplit(".", 1)[1] for k in
                                            tracing.summary()["counters"]
                                            if k.startswith("nddwt.dec_level.body.")]
        (out[key], out[key.replace("_ms", "_queued_ms")],
         out[key.replace("_ms", "_host_ms")]) = _timed(torch, call)
        print(f"{key}: {out[key]} body {out[key.replace('_ms', '_body')]}", flush=True)
        del x, big, call
        torch.cuda.empty_cache()
    return out


def _cells(torch, tw, tracing) -> dict:
    """The bodies nddwt_dec_level took, with tracing on, in one denoising
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
                                  if ".body." in k},
                     "launches": {k: v for k, v in ck.launch_counts.items() if v}}
        print(f"{name}: {out[name]}", flush=True)
    return out


def _variants(torch, tw, ck, level_ref, tracing, dirs) -> dict:
    """Time builds of ``nddwt_level.cu`` from the copies of ``csrc/`` in
    ``dirs`` beside this checkout's build."""
    libs = {"checkout": ck.load()}
    plans = {d: tuple(int(v) for v in d.split(":")[1].split(",")) for d in dirs if ":" in d}
    real_load, real_library, real_plan = ck.load, ck.library, ck._plane_ana_plan
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, d in enumerate(dirs):
            so = Path(tmp) / f"v{i}.so"
            d = d.split(":")[0]
            procs.append((d, so, subprocess.Popen(
                [ck._nvcc(), *ck.NVCC_FLAGS, "-o", str(so), str(Path(d) / "nddwt_level.cu")])))
        for d, (_, so, proc) in zip(dirs, procs):
            if proc.wait():
                raise RuntimeError(f"nvcc failed on {d}")
            ck.load.cache_clear()
            ck.library = lambda n, p=so: ctypes.CDLL(str(p))
            libs[d] = ck.load()
            ck.library = real_library
        ck.load.cache_clear()
        gen = torch.Generator(device="cuda").manual_seed(2)
        shape = (24, 40, 72)
        taps = tw.NDDWT("db4", shape, device="cuda").taps_hp
        x = torch.randn(shape, generator=gen, device="cuda")
        ref = torch.zeros((15,) + shape)
        ref_a = level_ref.dec_level_ref(x.cpu(), ref, 8, taps, 0.1, False)
        out = {}
        order = list(libs)
        for name in order + order[::-1]:
            ck.load = lambda lib=libs[name]: lib
            ck._plane_ana_plan = (lambda *a, t=plans[name]: t) if name in plans else real_plan
            big = torch.zeros((15,) + shape, device="cuda")
            a = ck.dec_level(x, big, 8, taps, 0.1, False)
            if max(_err(big.cpu(), ref), _err(a.cpu(), ref_a)) > 1e-5:
                raise RuntimeError(f"build {name!r} disagrees with the plain version")
            for key in ("dec_knee_f32_ms", "dec_knee_f32_shrink_ms"):
                t = statistics.median(_time_all(torch, tw, ck, level_ref, tracing, [key],
                                                False)[key])
                out.setdefault(name, {}).setdefault(key, []).append(t)
        ck.load, ck._plane_ana_plan = real_load, real_plan
    print(f"variants: {out}", flush=True)
    return out


def _package(root):
    sys.path.insert(0, root)
    import torch

    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch import tracing
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
    from non_decimated_wavelets_tpu_torch.ops import level_ref

    if not Path(tw.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {tw.__file__}, not the package under {root}")
    return torch, tw, ck, level_ref, tracing


def child(root: str, keys) -> int:
    """Time ``keys`` of TIMED with the package found at ``root``."""
    torch, tw, ck, level_ref, tracing = _package(root)
    print(json.dumps(_time_all(torch, tw, ck, level_ref, tracing, keys)))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--parent")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--keys", default=",".join(TIMED), help="the TIMED keys to time")
    ap.add_argument("--child")
    ap.add_argument("variants", nargs="*", help="copies of csrc/ with a change")
    args = ap.parse_args()
    keys = args.keys.split(",")
    if args.child:
        return child(args.child, keys)
    torch, tw, ck, level_ref, tracing = _package(str(ROOT))
    if not torch.cuda.is_available():
        print("chip_ab_dec: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    card = _card()
    print(card, flush=True)
    ck.build(("nddwt_level",))
    result = {"card": card}
    if args.check:
        _ptxas(ck)
        wrong = _check(torch, tw, ck, level_ref, tracing)
        if wrong:
            print(f"chip_ab_dec: disagrees or took another body: {wrong}", file=sys.stderr)
            return 1
        result["cells"] = _cells(torch, tw, tracing)
        print(json.dumps(result))
        return 0
    if args.parent:
        runs = {}
        for label, root in (("parent", args.parent), ("change", str(ROOT)),
                            ("change", str(ROOT)), ("parent", args.parent)):
            proc = subprocess.run([sys.executable, __file__, "--child", root,
                                   "--keys", args.keys], capture_output=True, text=True)
            if proc.returncode:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return 1
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            for key, value in got.items():
                if key.endswith("_ms"):
                    value = statistics.median(value)
                runs.setdefault(label, {}).setdefault(key, []).append(value)
            print(f"{label}: {got}", flush=True)
        result["runs"] = runs
    else:
        result["runs"] = {"change": _time_all(torch, tw, ck, level_ref, tracing, keys)}
    if args.sweep:
        real_plan = ck._plane_ana_plan
        sweep = {}
        for key, plans in SWEEP.items():
            for t in plans + plans[::-1]:
                ck._plane_ana_plan = lambda *a, t=t: t
                sweep.setdefault(f"{key} {t}", []).append(statistics.median(
                    _time_all(torch, tw, ck, level_ref, tracing, [key], False)[key]))
        ck._plane_ana_plan = real_plan
        result["sweep"] = sweep
    if args.variants:
        result["variants"] = _variants(torch, tw, ck, level_ref, tracing, args.variants)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
