"""The sharded phases of ``chip_smoke.py``: the halo-padded mode of the four
kernels (``nddwt_dec_level``, ``nddwt_rec_level``, ``nddwt_lead_dec``,
``nddwt_lead_adj``), and the sharded path through ``ShardedNDDWT`` on ranks
spawned on one card.

``check_padded``
    each kernel's padded mode against its plain version on the card, on one
    rank's halo-padded block cut from a global array (float32, bfloat16 and
    float64; one and two padded axes in 3D, X and X+Y in the 4D lead stage),
    and against the wrap-mode kernel's result on the whole array cut to the
    block: a sharded level must equal the unsharded one.
``run_sharded``
    spawns ``RANKS`` processes (start method ``spawn``; rank r on
    ``cuda:{r % device_count}``, so on one card every rank shares it) in a
    gloo group, and runs ``ShardedNDDWT`` at full width (``RUNS``): each rank
    holds its block against the single-card plan's result on that block,
    computed on the rank from the same seed, ranks taking turns for memory,
    and reports its exact launch counts and error scalars (no gather of the
    bands). Then the sharded 256^3 pair end to end per rank, with the halo
    exchange timed on its own.
``time_padded``
    each padded-mode kernel per call in one process, beside the same
    kernel's wrap mode on the same block, its plain version and one
    PyTorch call computing the same function (cuDNN ``conv3d`` for the
    level kernels, a depthwise ``F.conv2d`` for the lead stages), with the
    bytes bound.

Run it through ``chip_smoke.py``; it needs a CUDA device and the kernels
built (``cuda_kernels.build()``) in the parent first, so that the ranks do
not run ``nvcc`` at the same time.
"""

import json
import os
import socket
import tempfile
import time
import traceback

SHAPE = (256, 256, 256)
SHAPE4 = (128, 128, 128, 32)
LEVEL, THRESHOLD = 3, 0.1
RANKS = 4
F32_TOL, BF16_TOL, F64_TOL = 1e-5, 1e-2, 1e-12
RT_TOL, SOLVER_TOL = 1e-4, 1e-4
PADDED = ("nddwt_dec_level", "nddwt_rec_level", "nddwt_lead_dec", "nddwt_lead_adj")
STAGES = ("nddwt_lane_dec", "nddwt_lead_dec", "nddwt_lead_adj", "nddwt_lane_adj")
# name, mesh, spec, global shape, dtype, kind, level; the per-rank launches
# of one call are given by ``want_launches``.
RUNS = [
    ("256^3 f32 dec_rec", {"x": 2}, ("x", None, None), SHAPE, "float32", "dec_rec"),
    ("256^3 f32 dec_rec, 2x2 mesh", {"x": 2, "y": 2}, ("x", "y", None), SHAPE,
     "float32", "dec_rec"),
    ("256^3 f64 dec_rec", {"x": 2}, ("x", None, None), SHAPE, "float64", "dec_rec"),
    ("4D f32 dec_rec", {"x": 2}, ("x", None, None, None), SHAPE4, "float32", "dec_rec"),
    ("batch 2 x 128^3 f32 dec_rec", {"data": 2, "x": 2}, ("x", None, None),
     (128, 128, 128), "float32", "batch"),
    ("256^2 f32 dec_rec_split", {"x": 2}, ("x", None), (256, 256), "float32", "split"),
    ("256^3 f32 fista_inpaint, 3 iterations", {"x": 2}, ("x", None, None), SHAPE,
     "float32", "fista"),
]
FISTA_ITERS, FISTA_LAM = 3, 0.05
# The TPU kernels whose "valid" modes the padded mode replaces (row 23).
VALID_REPLACES = {
    "nddwt_dec_level": "non_decimated_wavelets_tpu/ops/pallas_kernels.py:776",
    "nddwt_rec_level": "non_decimated_wavelets_tpu/ops/pallas_kernels.py:1468",
    "nddwt_lead_dec": "non_decimated_wavelets_tpu/ops/pallas_4d.py:592",
    "nddwt_lead_adj": "non_decimated_wavelets_tpu/ops/pallas_4d.py:882",
}


def _dtype(name):
    import torch

    return getattr(torch, name)


def _rel(ref, dtype):
    """The tolerance relative to max|ref|, from two reductions (no copy of
    a large array)."""
    import torch

    rel = {torch.float32: F32_TOL, torch.float64: F64_TOL}.get(dtype, BF16_TOL)
    return rel * max(ref.max().item(), -ref.min().item())


def _err(a, b):
    import torch

    dt = torch.float64 if a.dtype == torch.float64 else torch.float32
    return (a.to(dt) - b.to(dt)).abs_().max().item()


def _block_err(sh, got, ref, lead):
    """max|got - this rank's block of ``ref``|, cut one index of the
    ``lead`` leading axes at a time (a band array's block is never copied
    whole)."""
    if lead == 0:
        return _err(got, sh._cut(ref, 0))
    return max(_block_err(sh, g, r, lead - 1) for g, r in zip(got, ref))


def _block(t, mesh, lead, widths=None):
    """The last rank's block of ``t`` on each sharded axis (spatial axis k
    at ``lead + k``; ``mesh[k]`` ranks), with ``widths[k]`` rows of the
    periodic neighbours around it when given."""
    import torch

    for ax, p in enumerate(mesh):
        if p == 1:
            continue
        axis, n = lead + ax, t.shape[lead + ax]
        w = n // p
        left, right = widths[ax] if widths else (0, 0)
        idx = torch.arange(n - w - left, n + right, device=t.device) % n
        t = t.index_select(axis, idx)
    return t.contiguous()


# ------------------------------------------------------------------ phase 2


def check_padded(check, card):
    """The padded mode of the four kernels against their plain versions and
    against the wrap mode on the whole array, cut to the block. Returns the
    largest error of each at the main path's shapes in float32."""
    import torch

    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
    from non_decimated_wavelets_tpu_torch.ops import level4_ref, level_ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    main_err = dict.fromkeys(PADDED, 0.0)

    def randn(shape, dt):
        draw = torch.float64 if dt == torch.float64 else torch.float32
        return torch.randn(shape, generator=gen, device=dev, dtype=draw).to(dt)

    for seed, (mesh, dt) in enumerate([
            ((2, 1, 1), torch.float32), ((2, 2, 1), torch.float32),
            ((2, 1, 1), torch.bfloat16), ((2, 2, 1), torch.bfloat16),
            ((2, 1, 1), torch.float64), ((2, 2, 1), torch.float64)]):
        gen.manual_seed(2000 + seed)
        taps = tw.NDDWT("db4", SHAPE, device=dev).taps_hp
        pad = tuple(p > 1 for p in mesh)
        local = tuple(n // p for n, p in zip(SHAPE, mesh))
        tag = f"{SHAPE} block {local} db4 {str(dt).removeprefix('torch.')}"
        x = randn(SHAPE, dt)
        xp = _block(x, mesh, 0, ck.halo_widths(taps, False))
        whole_big = torch.zeros((8,) + SHAPE, dtype=dt, device=dev)
        whole_app = ck.dec_level(x, whole_big, 1, taps, THRESHOLD)
        for final in (False, True):
            bk = torch.zeros((8,) + local, dtype=dt, device=dev)
            br = bk.clone()
            ak = ck.dec_level(xp, bk, 1, taps, THRESHOLD, final, pad)
            ar = level_ref.dec_level_ref(xp, br, 1, taps, THRESHOLD, final, pad)
            torch.cuda.synchronize()
            err = check(f"nddwt_dec_level padded {tag} final={final}", _err(bk, br),
                        _rel(br, dt))
            if not final:
                err = max(err, check("    next approx", _err(ak, ar), _rel(ar, dt)))
                check("    equals the wrap mode on the whole array, cut to the block",
                      max(_err(bk[1:], _block(whole_big[1:], mesh, 1)),
                          _err(ak, _block(whole_app, mesh, 0))), _rel(br, dt))
            if dt == torch.float32:
                main_err["nddwt_dec_level"] = max(main_err["nddwt_dec_level"], err)
        del whole_big, whole_app, bk, br, ak, ar, xp
        y = randn((15,) + SHAPE, dt)
        yp = _block(y, mesh, 1, ck.halo_widths(taps, True))
        ap = _block(x, mesh, 0, ck.halo_widths(taps, True))
        for src in ([("y", b) for b in range(8)],
                    [("a", 0)] + [("y", 7 + b) for b in range(1, 8)]):
            k = ck.rec_level(yp, ap, src, taps, 0.125, pad)
            r = level_ref.rec_level_ref(yp, ap, src, taps, 0.125, pad)
            whole = ck.rec_level(y, x, src, taps, 0.125)
            torch.cuda.synchronize()
            err = check(f"nddwt_rec_level padded {tag} band0={src[0]}", _err(k, r),
                        _rel(r, dt))
            check("    equals the wrap mode on the whole array, cut to the block",
                  _err(k, _block(whole, mesh, 0)), _rel(r, dt))
            if dt == torch.float32:
                main_err["nddwt_rec_level"] = max(main_err["nddwt_rec_level"], err)
        del x, y, yp, ap, k, r, whole
        torch.cuda.empty_cache()

    # The 4D lead stage: the main path's volume in float32; a quarter of it
    # in bfloat16 and float64 (a float64 band array of the whole volume
    # alone would take 17 GB).
    small4 = (64, 64, 64, 32)
    for seed, (mesh, dt, shape4) in enumerate([
            ((2, 1), torch.float32, SHAPE4), ((2, 2), torch.float32, SHAPE4),
            ((2, 1), torch.bfloat16, small4), ((2, 2), torch.bfloat16, small4),
            ((2, 1), torch.float64, small4), ((2, 2), torch.float64, small4)]):
        gen.manual_seed(2100 + seed)
        taps = tw.NDDWT("db4", shape4, device=dev).taps_hp
        m4 = mesh + (1, 1)
        pad = tuple(p > 1 for p in mesh)
        local = tuple(n // p for n, p in zip(shape4, m4))
        tag = f"{shape4} block {local} db4 {str(dt).removeprefix('torch.')}"
        temp = randn((4,) + shape4, dt)
        tp = _block(temp, m4, 1, ck.halo_widths(taps, False))
        whole_big = torch.zeros((16,) + shape4, dtype=dt, device=dev)
        whole_app = ck.lead_dec(temp, whole_big, 1, taps, THRESHOLD)
        bk = torch.zeros((16,) + local, dtype=dt, device=dev)
        br = bk.clone()
        ak = ck.lead_dec(tp, bk, 1, taps, THRESHOLD, False, pad)
        ar = level4_ref.lead_dec_ref(tp, br, 1, taps, THRESHOLD, False, pad)
        torch.cuda.synchronize()
        err = max(check(f"nddwt_lead_dec padded {tag}", _err(bk, br), _rel(br, dt)),
                  check("    next approx", _err(ak, ar), _rel(ar, dt)))
        check("    equals the wrap mode on the whole array, cut to the block",
              max(_err(bk[1:], _block(whole_big[1:], m4, 1)),
                  _err(ak, _block(whole_app, m4, 0))), _rel(br, dt))
        if dt == torch.float32 and shape4 == SHAPE4:
            main_err["nddwt_lead_dec"] = max(main_err["nddwt_lead_dec"], err)
        del temp, tp, whole_big, whole_app, bk, br, ak, ar
        torch.cuda.empty_cache()
        y = randn((16,) + shape4, dt)
        yp = _block(y, m4, 1, ck.halo_widths(taps, True))
        a = randn(shape4, dt)
        ap = _block(a, m4, 0, ck.halo_widths(taps, True))
        src = [("a", 0)] + [("y", b) for b in range(1, 16)]
        k = ck.lead_adj(yp, ap, src, taps, pad)
        r = level4_ref.lead_adj_ref(yp, ap, src, taps, pad)
        del yp, ap
        whole = ck.lead_adj(y, a, src, taps)
        torch.cuda.synchronize()
        err = check(f"nddwt_lead_adj padded {tag}", _err(k, r), _rel(r, dt))
        check("    equals the wrap mode on the whole array, cut to the block",
              _err(k, _block(whole, m4, 1)), _rel(r, dt))
        if dt == torch.float32 and shape4 == SHAPE4:
            main_err["nddwt_lead_adj"] = max(main_err["nddwt_lead_adj"], err)
        del y, a, k, r, whole
        torch.cuda.empty_cache()
    return main_err


# ------------------------------------------------------------------ phase 3


def want_launches(name, spec, shape, kind):
    """The exact per-rank launches of one call of a run: L analysis and L
    synthesis levels per array (2L + 2L stage launches in 4D), each level
    on a sharded axis in the padded mode; no flat or multilevel launch."""
    L = LEVEL
    n_arrays = {"split": 2, "fista": FISTA_ITERS}.get(kind, 1)
    if len(shape) == 4:
        want = dict.fromkeys(STAGES, L * n_arrays)
        padded = dict.fromkeys(("nddwt_lead_dec", "nddwt_lead_adj"), L * n_arrays)
    else:
        want = dict.fromkeys(("nddwt_dec_level", "nddwt_rec_level"), L * n_arrays)
        padded = dict(want)
    if kind == "split":
        want["nddwt_mag_shrink_pair"] = 1
    if kind == "fista":
        want["nddwt_fista_step"] = FISTA_ITERS
    return want, padded


def _rank(rank, world, port, out_dir):
    """One rank: every run of ``RUNS``, then the timed pair; writes its
    report to ``out_dir/rank<r>.json``. An exception ends the process with
    a non-zero code (the parent's join raises)."""
    import datetime

    import torch
    import torch.distributed as dist

    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch.models import fista_inpaint
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
    from non_decimated_wavelets_tpu_torch.parallel import ShardedNDDWT, make_mesh
    from non_decimated_wavelets_tpu_torch.parallel import sharded as shd

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    report = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
              "runs": {}}
    try:
        for name, mesh_sizes, spec, shape, dt_name, kind in RUNS:
            mesh = make_mesh(mesh_sizes, "cuda")
            inside = mesh.get_coordinate() is not None
            dist.barrier()
            if inside:
                dt = _dtype(dt_name)
                plan = tw.NDDWT("db4", shape, preserve_l2=kind == "fista", dtype=dt,
                                device=dev)
                sh = ShardedNDDWT(plan, mesh, spec, ("data",) if kind == "batch" else ())
                if not sh.use_pallas:
                    raise RuntimeError(f"{name}: not on the kernel bodies")
                gen = torch.Generator(device=dev).manual_seed(7)
                lead = (2,) if kind in ("batch", "split") else ()
                draw = torch.float64 if dt == torch.float64 else torch.float32
                x = torch.randn(lead + shape, generator=gen, device=dev,
                                dtype=draw).to(dt)
                mask = (torch.rand(shape, generator=gen, device=dev) < 0.4).to(dt)
                xs = sh.shard_input_split(x) if kind == "split" else sh.shard_input(x)
                torch.cuda.synchronize()
                ck.reset_launch_counts()
                t0 = time.perf_counter()
                if kind == "split":
                    y, xr = sh.dec_rec_split(xs, LEVEL, THRESHOLD)
                elif kind == "fista":
                    y, xr = None, fista_inpaint(sh, sh.shard_input(mask * x),
                                                sh.shard_input(mask), FISTA_LAM, LEVEL,
                                                FISTA_ITERS)
                else:
                    y, xr = sh.dec_rec(xs, LEVEL, THRESHOLD)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                got = {k: v for k, v in ck.launch_counts.items() if v}
                got_padded = {k: v for k, v in ck.padded_launch_counts.items() if v}
                finite = bool(torch.isfinite(xr).all()) and (
                    y is None or bool(torch.isfinite(y).all()))
                errs = {}
                torch.cuda.empty_cache()
            # The single-card plan on the whole array, the ranks in turn
            # (one reference on the card at a time).
            for turn in range(world):
                if turn == rank and inside:
                    if kind == "split":
                        yr, xrr = plan.dec_rec_split(x, LEVEL, THRESHOLD)
                        errs["bands"] = _block_err(sh, y, yr, 2)
                        errs["x"] = _block_err(sh, xr, xrr, 1)
                        errs["tol"] = [_rel(yr, dt), _rel(xrr, dt)]
                    elif kind == "fista":
                        xrr = fista_inpaint(plan, mask * x, mask, FISTA_LAM, LEVEL,
                                            FISTA_ITERS)
                        yr, errs["x"] = None, _err(xr, sh._cut(xrr, 0))
                        errs["tol"] = [None, SOLVER_TOL * xrr.abs().max().item()]
                    else:
                        if kind == "batch":
                            pairs = [plan.dec_rec(v, LEVEL, THRESHOLD, band_axis=0)
                                     for v in x]
                            yr = torch.stack([p[0] for p in pairs], dim=1)
                            xrr = torch.stack([p[1] for p in pairs])
                            del pairs
                        else:
                            yr, xrr = plan.dec_rec(x, LEVEL, THRESHOLD, band_axis=0)
                        errs["tol"] = [_rel(yr, dt), _rel(xrr, dt)]
                        errs["bands"] = _block_err(sh, y, yr, 1)
                        errs["x"] = _block_err(sh, xr, xrr, 0)
                    del yr, xrr
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                dist.barrier()
            if inside:
                del y, xr
                if kind in ("dec_rec", "batch"):  # threshold 0: the round trip
                    errs["round_trip"] = _err(sh.dec_rec(xs, LEVEL)[1], xs)
                report["runs"][name] = {
                    "kind": kind, "shape": shape, "mesh": mesh_sizes, "dtype": dt_name,
                    "launches": got, "padded_launches": got_padded, "seconds": seconds,
                    "finite": finite, "errors": errs,
                    "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                }
                del x, xs, mask
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
        # The sharded 256^3 pair end to end on {"x": 2}, each rank timed.
        mesh = make_mesh({"x": 2}, "cuda")
        if mesh.get_coordinate() is not None:
            plan = tw.NDDWT("db4", SHAPE, device=dev)
            sh = ShardedNDDWT(plan, mesh, ("x", None, None))
            gen = torch.Generator(device=dev).manual_seed(8)
            xs = sh.shard_input(torch.randn(SHAPE, generator=gen, device=dev))
            group = mesh.get_group("x")
            for _ in range(2):
                sh.dec_rec(xs, LEVEL, THRESHOLD)
            reps, times = 5, []
            for _ in range(reps):
                torch.cuda.synchronize()
                dist.barrier(group)
                t0 = time.perf_counter()
                sh.dec_rec(xs, LEVEL, THRESHOLD)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            # One more call with each halo exchange timed on its own: the
            # card synchronised before and after it, (bytes sent, seconds).
            each, exchange = [], shd._exchange

            def timed_exchange(tail, head, ring):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                got = exchange(tail, head, ring)
                torch.cuda.synchronize(dev)
                each.append(((tail.numel() + head.numel()) * tail.element_size(),
                             time.perf_counter() - t0))
                return got

            shd._exchange = timed_exchange
            try:
                dist.barrier(group)
                t0 = time.perf_counter()
                sh.dec_rec(xs, LEVEL, THRESHOLD)
                torch.cuda.synchronize()
                timed_total = time.perf_counter() - t0
            finally:
                shd._exchange = exchange
            report["pair"] = {
                "ms": 1e3 * sum(times) / reps, "ms_min": 1e3 * min(times),
                "exchange_ms": 1e3 * sum(t for _, t in each),
                "exchange_calls": len(each),
                "exchange_mb": sum(n for n, _ in each) / 1e6,
                "each": [(n / 1e6, 1e3 * t) for n, t in each],
                "with_exchange_timing_ms": 1e3 * timed_total,
            }
        dist.barrier()
    except Exception:
        report["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
        dist.destroy_process_group()


def valid_launches(reports, name):
    """Rank 0's padded launches of ``name`` in the sharded f32 step of its
    kind: the 256^3 step for the level kernels, the 4D step for the lead
    stage."""
    run = "4D f32 dec_rec" if "lead" in name else "256^3 f32 dec_rec"
    return reports[0]["runs"][run]["padded_launches"].get(name, 0)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_sharded(check, check_launches, failures, card):
    """Phase 3's sharded runs on ``RANKS`` spawned ranks; holds every
    rank's errors, launches and finiteness. Returns the rank reports."""
    from multiprocessing import resource_tracker

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_sharded_") as out_dir:
        t0 = time.perf_counter()
        try:
            mp.start_processes(_rank, args=(RANKS, _free_port(), out_dir),
                               nprocs=RANKS, join=True, start_method="spawn")
        finally:
            # Spawning starts multiprocessing's resource tracker, a process
            # that would outlive this script: stop it once the ranks are gone.
            resource_tracker._resource_tracker._stop()
        wall = time.perf_counter() - t0
        reports = []
        for r in range(RANKS):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    print(f"  {RANKS} ranks spawned, backend {reports[0]['backend']}, devices "
          f"{[r['device'] for r in reports]}, {wall:.1f} s in all {card}")
    for name, mesh_sizes, spec, shape, dt_name, kind in RUNS:
        want, want_padded = want_launches(name, spec, shape, kind)
        peaks = [rep["runs"][name]["peak_gb"] for rep in reports if name in rep["runs"]]
        print(f"  sharded {name} on {mesh_sizes}: at most {sum(peaks):.2f} GB allocated "
              f"on the card (the ranks' peaks summed)")
        if sum(peaks) > 60:
            failures.append(f"sharded {name}: {sum(peaks):.2f} GB, over 60 GB")
        for rep in reports:
            run = rep["runs"].get(name)
            if run is None:
                continue
            tag = f"sharded {name} on {mesh_sizes}, rank {rep['rank']}"
            e = run["errors"]
            if not run["finite"]:
                failures.append(f"{tag}: non-finite values")
            if "bands" in e:
                check(f"{tag}: bands vs the single-card plan's block", e["bands"],
                      e["tol"][0])
            check(f"{tag}: reconstruction vs the single-card plan's block", e["x"],
                  e["tol"][1])
            if "round_trip" in e:
                check(f"{tag}: threshold-0 round trip", e["round_trip"],
                      F64_TOL * 10 if dt_name == "float64" else RT_TOL)
            check_launches(f"{tag}", run["launches"], want)
            check_launches(f"{tag}, halo-padded", run["padded_launches"], want_padded)
            print(f"    {tag}: {1e3 * run['seconds']:.2f} ms (first call), peak "
                  f"{run['peak_gb']:.2f} GB allocated by this rank {card}")
    for rep in reports:
        if "pair" in rep:
            p = rep["pair"]
            print(f"  sharded dec_rec({THRESHOLD}) {SHAPE} db4 L{LEVEL} f32 on {{'x': 2}}, "
                  f"rank {rep['rank']}, 2 ranks computing ({RANKS} spawned) sharing one "
                  f"H100: {p['ms']:.2f} ms per call (min {p['ms_min']:.2f}); halo "
                  f"exchange {p['exchange_ms']:.2f} ms of {p['with_exchange_timing_ms']:.2f}"
                  f" ms in a call with the exchange timed ({p['exchange_calls']} "
                  f"exchanges, {p['exchange_mb']:.1f} MB sent, gloo through host memory; "
                  f"MB, ms each: "
                  + ", ".join(f"{mb:.2f}, {ms:.2f}" for mb, ms in p["each"]) + f") {card}")
    return reports


# ------------------------------------------------------------------ phase 4


def time_padded(timed, bound_ms, conv_weights, lead_conv, check, card):
    """Each padded-mode kernel per call beside the same kernel's wrap mode
    on the same block (the main paths' {"x": 2} blocks, float32), its plain
    version and one PyTorch call computing the same padded function
    (checked once against the plain version, TF32 off by the caller): a
    cuDNN ``conv3d`` for the 3D level kernels, a depthwise ``F.conv2d``
    (``lead_conv``, valid along the padded X) for the lead stages; the
    bound counts the padded input once. Returns ``{name: {"ms",
    "plain_ms", "wrap_ms", "library_ms", "library", "bound_ms", "bound_by",
    "shape"}}``."""
    import torch
    import torch.nn.functional as F

    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
    from non_decimated_wavelets_tpu_torch.ops import level4_ref, level_ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2200)
    f32, out = 4, {}
    taps = tw.NDDWT("db4", SHAPE, device=dev).taps_hp
    local = (SHAPE[0] // 2,) + SHAPE[1:]
    pad = (True, False, False)
    x = torch.randn(local, generator=gen, device=dev)
    xp = torch.randn((local[0] + 7,) + local[1:], generator=gen, device=dev)
    big = torch.empty((8,) + local, device=dev)
    y = torch.randn((8,) + local, generator=gen, device=dev)
    yp = torch.randn((8, local[0] + 7) + local[1:], generator=gen, device=dev)
    src = [("y", b) for b in range(8)]
    vox, vox_p = x.numel(), xp.numel()
    flops = vox * sum(2 ** (a + 2) * len(t[0]) for a, t in enumerate(taps))
    runs = {
        "nddwt_dec_level": (
            lambda: ck.dec_level(xp, big, 1, taps, padded=pad),
            lambda: level_ref.dec_level_ref(xp, big, 1, taps, padded=pad),
            lambda: ck.dec_level(x, big, 1, taps),
            bound_ms((vox_p + 8 * vox) * f32, flops)),
        "nddwt_rec_level": (
            lambda: ck.rec_level(yp, None, src, taps, 0.125, pad),
            lambda: level_ref.rec_level_ref(yp, None, src, taps, 0.125, pad),
            lambda: ck.rec_level(y, None, src, taps, 0.125),
            bound_ms((8 * vox_p + vox) * f32, flops)),
    }
    for name, (k, p, w, bnd) in runs.items():
        out[name] = {"ms": timed(k, 20), "plain_ms": timed(p, 3), "wrap_ms": timed(w, 20),
                     "bound_ms": bnd[0], "bound_by": bnd[1], "shape": local}

    # The yardstick: one cuDNN convolution computing the same padded level,
    # valid on the halo-padded X and circular on the local Y and Z (padded
    # before the timer, as the wrap mode's yardstick is).
    def conv_input(t, rec):
        pads = []
        for left, right in reversed(ck.halo_widths(taps, rec)[1:]):
            pads += [left, right]
        return F.pad(t[None], pads + [0, 0], mode="circular")

    xc, wdec = conv_input(xp[None], False), conv_weights(taps, rec=False)
    approx = level_ref.dec_level_ref(xp, big, 1, taps, padded=pad)
    conv = F.conv3d(xc, wdec)[0]
    check("cuDNN conv3d as one halo-padded analysis level",
          max(_err(conv[1:], big[1:]), _err(conv[0], approx)),
          F32_TOL * big[1:].abs().max().item())
    yc, wrec = conv_input(yp, True), conv_weights(taps, rec=True) / 8
    r = level_ref.rec_level_ref(yp, None, src, taps, 0.125, pad)
    check("cuDNN conv3d as one halo-padded synthesis level",
          _err(F.conv3d(yc, wrec)[0, 0], r), F32_TOL * r.abs().max().item())
    out["nddwt_dec_level"]["library_ms"] = timed(lambda: F.conv3d(xc, wdec), 5)
    out["nddwt_rec_level"]["library_ms"] = timed(lambda: F.conv3d(yc, wrec), 5)
    for name in ("nddwt_dec_level", "nddwt_rec_level"):
        out[name]["library"] = "cuDNN conv3d"
    del x, xp, big, y, yp, xc, yc, conv, approx, r
    torch.cuda.empty_cache()
    taps4 = tw.NDDWT("db4", SHAPE4, device=dev).taps_hp
    local4 = (SHAPE4[0] // 2,) + SHAPE4[1:]
    k4 = [len(t[0]) for t in taps4]
    vox4 = 1
    for n in local4:
        vox4 *= n
    vox4_p = vox4 // local4[0] * (local4[0] + 7)
    lead_flops = 4 * vox4 * (4 * k4[0] + 8 * k4[1])
    temp = torch.randn((4,) + local4, generator=gen, device=dev)
    temp_p = torch.randn((4, local4[0] + 7) + local4[1:], generator=gen, device=dev)
    big4 = torch.empty((16,) + local4, device=dev)
    runs = {
        "nddwt_lead_dec": (
            lambda: ck.lead_dec(temp_p, big4, 1, taps4, padded=(True, False)),
            lambda: level4_ref.lead_dec_ref(temp_p, big4, 1, taps4, padded=(True, False)),
            lambda: ck.lead_dec(temp, big4, 1, taps4),
            bound_ms((4 * vox4_p + 16 * vox4) * f32, lead_flops)),
    }
    for name, (k, p, w, bnd) in runs.items():
        out[name] = {"ms": timed(k, 10), "plain_ms": timed(p, 2, warm=1),
                     "wrap_ms": timed(w, 10), "bound_ms": bnd[0],
                     "bound_by": bnd[1], "shape": local4}
    del temp
    # The yardstick: one depthwise F.conv2d, valid along the padded X.
    call, bands = lead_conv(temp_p, taps4, False, padded=True)
    big4[0] = level4_ref.lead_dec_ref(temp_p, big4, 1, taps4, padded=(True, False))
    check("depthwise F.conv2d as one halo-padded nddwt_lead_dec",
          _err(bands(call()), big4), F32_TOL * big4.abs().max().item())
    out["nddwt_lead_dec"].update(library_ms=timed(call, 5), library="depthwise F.conv2d")
    del temp_p, call
    torch.cuda.empty_cache()
    y4 = torch.randn((16,) + local4, generator=gen, device=dev)
    y4p = torch.randn((16, local4[0] + 7) + local4[1:], generator=gen, device=dev)
    src16 = [("y", b) for b in range(16)]
    out["nddwt_lead_adj"] = {
        "ms": timed(lambda: ck.lead_adj(y4p, None, src16, taps4, (True, False)), 10),
        "plain_ms": timed(lambda: level4_ref.lead_adj_ref(y4p, None, src16, taps4,
                                                          (True, False)), 2, warm=1),
        "wrap_ms": timed(lambda: ck.lead_adj(y4, None, src16, taps4), 10),
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms((16 * vox4_p + 4 * vox4) * f32, lead_flops))),
        "shape": local4,
    }
    del y4, big4
    call, bands = lead_conv(y4p, taps4, True, padded=True)
    r = level4_ref.lead_adj_ref(y4p, None, src16, taps4, (True, False))
    check("depthwise F.conv2d as one halo-padded nddwt_lead_adj",
          _err(bands(call()), r), F32_TOL * r.abs().max().item())
    out["nddwt_lead_adj"].update(library_ms=timed(call, 5), library="depthwise F.conv2d")
    del y4p, call, r
    torch.cuda.empty_cache()
    for name in PADDED:
        t = out[name]
        lib = f"{t['library']} {t['library_ms']:.4f} ms"
        print(f"  {name} halo-padded, block {t['shape']} of a {{'x': 2}} mesh, db4 f32 per "
              f"call: kernel {t['ms']:.4f} ms, wrap mode on the same block "
              f"{t['wrap_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, {lib}, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}) {card}")
    return out
