#!/usr/bin/env python3
"""Drive the torch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

The main path is the flagship workload: a 3-level db4 3D non-decimated DWT
inside one denoising step (dec -> soft-threshold the details -> rec), at
256^3 float32, through ``NDDWT.dec_rec``. The solver paths run the FISTA
solvers of ``models/cs_recon.py`` at the same width: ``fista_inpaint``,
``fista_inpaint_split`` and ``fista_cs_mri`` on complex k-space. The 4D
paths run the same step on a (128, 128, 128, 32) dynamic volume (db4 L3
and Haar L1) and ``fista_cs_mri`` on complex (128, 128, 64, 32) k-t data,
through the lane and lead stage kernels. The class paths run the six
reference-style classes (``api.py``) at their default double precision on
complex data at the reference's own test configurations, through the 1D
kernels and the float64 level and stage kernels; then the 256^3 db4 L3
float64 transform and step, and 1D signals of 1M and 2^23 samples. The
one-launch paths run a whole solve or chain in one launch of
``nddwt_flat_iter`` (``fista_inpaint`` and ``fista_inpaint_split`` at
256^2, 100 iterations; ``dec_rec_n`` at 264^2, 20 sweeps) and a whole
transform in one ``nddwt_flat_pair`` (``dec_rec`` at 256^2, its main
path; ``dec_rec_split`` at 128^2; 5D plans). The multilevel paths run a
whole transform of a batch in one ``nddwt_dec_multi`` and one
``nddwt_rec_multi`` launch: ``dec_rec`` of a real 128^3 db4 L3 volume with
the flat kernel switched off, ``dec_batched``/``rec_batched`` of a
multi-coil slice (8 complex64 256^2 items, their main path; real float32
and float64 too), and a complex (128, 128, 160) ``dec_rec`` with a
threshold (with one ``nddwt_mag_shrink_pair`` between them). The older
paths' launch checks run with the flat and multilevel kernels switched off,
held to their per-level counts; again on the multilevel kernels (the flat
kernel off), held to one launch each way, where their shapes take them
(``ops/multi.py``); and on the plan's own route, held to the flat counts,
where their shapes fall within the flat kernel's size (``ops/flat.py``).
The sharded paths (``chip_sharded.py``) run ``parallel.ShardedNDDWT`` on
four ranks spawned on the card in a gloo group, through the halo-padded
mode of the level and lead-stage kernels: the 256^3 step on {"x": 2} in
float32 and float64 and on {"x": 2, "y": 2}, the 4D step on {"x": 2}, a
batch of two 128^3 volumes on {"data": 2, "x": 2}, ``dec_rec_split`` at
256^2 and three ``fista_inpaint`` iterations at 256^3 on {"x": 2}.
Phases:

1. the card's name and power limit; build every CUDA kernel from this
   checkout's sources (one ``nvcc`` per source, all at once), with the
   build time, ``nddwt_4d.cu``'s kernel instantiations and the lane body's
   registers and local memory (``cuobjdump -res-usage``);
2. each kernel against its plain torch version on the card, at the paths'
   shapes and at small, odd, mixed-wavelet, 2D and bfloat16 shapes; the
   stage kernels also at odd Z/T, T > 128 and on a 3D db20 plan (the
   long-filter route); every kernel in float64 too, and the 1D kernels at
   1M, 54321, 8 (N = K) and 2^23 samples in float32, bfloat16 and float64;
   the two flat kernels in every mode, with and without the split pair,
   at the JAX flat tests' shapes, two 5D shapes, N = K, the one-launch
   paths' shapes, a 3D shape whose plan takes its axes in groups and two
   db10 shapes whose windows are longer than their extents, in float32,
   bfloat16 and float64; the two multilevel
   kernels at the JAX multilevel tests' cases (mixed wavelets, L2-L4) and
   odd extents (37, 29, 41) and (50, 33), batches of 1, 2 and 3, and at
   ``MULTI_DEEP_CASES`` (L4 and L5, odd extents, an extent equal to K,
   batches of 1 to 16, runtime tap loops, 2D and 3D), lam 0 and 0.1, both
   normalizations, in float32, bfloat16 and float64, and at the
   multi-coil batch; the halo-padded mode of the level and lead-stage
   kernels on one rank's padded block cut from a global array (one and two
   padded axes; float32, bfloat16, float64), also against the wrap mode on
   the whole array, cut to the block; the streamed synthesis
   (``nddwt_rec_level``, ``nddwt_lead_adj``) at the cases its plan can get
   wrong (``STREAM_REC_CASES``, ``STREAM_LEAD_CASES``: a streamed axis of
   extent K, odd extents, 2 to 28 taps, 2D mixed filters) in float32,
   bfloat16 and float64, one line per case; and the streamed analysis
   (``nddwt_dec_level``, ``nddwt_lead_dec``) the same way
   (``STREAM_DEC_CASES``, ``STREAM_LEAD_DEC_CASES``: also runtime taps,
   the split walk, 2D and padded slots 0 and 1), lam 0 and 0.1, ``final``
   both ways, one line per case; and the lane body (``nddwt_lane_dec``,
   ``nddwt_lane_adj``) at the cases its plan and copies can get wrong
   (``LANE_CASES``: units and chunks ending ragged, a chunk split at the
   periodic wrap, inputs at an odd element offset with odd Z*T, Z = K,
   T = 1, T > 128 and > 256, K = 76, one unit buffer, fewer units than
   CTAs and many times more, and the tile body's class) in float32,
   bfloat16 and float64, one line per case and direction with its plan;
3. the main path at 256^3 (both normalizations) against the plain path on
   the card, the threshold-0 round trip, and the 64^3 flagship step of
   ``__graft_entry__.entry`` against the float64 NumPy oracle; the kernels'
   launch counts are set to 0 just before each main-path ``dec_rec`` and
   before the 64^3 step, read just after, and must be one per level each;
   then the solver paths, 10 iterations each at 256^3 db4 L3 float32
   (preserve_l2, 40 % sampling): each against the same solver on a
   ``path='direct'`` plan on the card, its launch counts zeroed just
   before the run and held to the exact numbers its route launches; then
   the 4D paths the same way (and a 3D db20 step on the long-filter route);
   then the class paths: each class at its reference configuration on
   complex double data, with ``compute='gpu'`` and ``'gpu_off'``, held to
   the float64 oracle (bands within 1e-12 max, round trip 1e-11, energy
   1e-12 with ``pres_l2_norm``) with exact launch counts; the 256^3 float64
   pair and step against the plain path on the card and a 64^3 float64
   step against the oracle; 1D float32 at 1M and 2^23 samples and float64
   at 2^23; then the one-launch paths, each against the same call on a
   ``path='direct'`` plan on the card, each whole solve, chain or transform
   exactly one launch; then the multilevel paths, each against the same
   call on a ``path='direct'`` plan on the card, with exact launch counts;
   then the sharded paths, each rank's block against the single-card
   plan's result on that block (computed on the rank from the same seed),
   with each rank's exact launch counts (no flat or multilevel launch).
   100 float32 FISTA iterations are held to the
   solver gate, 1e-4 max; if they drift past it (rounding compounds over
   the iterations, and the two routes sum in other orders), the drift is
   printed and the float64 solve is held to float64 direct within 1e-10
   instead: the algorithm, not float32 rounding, is what the gate tests;
4. timings with CUDA events: each kernel per call, the dec+rec pair, the
   fused dec_rec step and one iteration of each solver, each beside its
   plain version, in 3D and 4D; for the level kernels also one cuDNN
   convolution computing the same level (the yardstick ``library_ms``),
   for the stage kernels one ``F.conv2d`` (the lane stages: a 2D
   convolution over (Z, T) with X*Y as the batch; the lead stages: a
   depthwise one over (X, Y) in channels-last memory, the Z*T lane columns
   the groups), each checked once against the plain version; the 1D
   kernels at 2^23 db6 (also queued behind a sleep) and the float64 level
   kernels at 256^3 db4 the same way (``F.conv1d``, ``F.conv3d`` in
   float64), and the float64 and 1D pairs and steps; the flat kernels
   beside the per-level route (no PyTorch call computes a multilevel
   transform) and queued behind a sleep
   (the kernel alone, beside the call's own time), the whole solve per
   iteration beside one stepped iteration, ``dec_rec_n`` per sweep beside
   one per-level ``dec_rec``, the 128^3 db20 step on the stage and the
   flat kernels; the multilevel kernels per call at the multi-coil batch
   (16 real 256^2 components), also queued behind a sleep, beside the same
   batch on the per-level route and the flat kernel; the elementwise
   kernels also queued; and the crossover tables of
   ``chip_flat_crossover.py`` (the multilevel columns and the batched table
   among them); the sharded 256^3 step per rank with its halo exchange
   timed on its own, and each halo-padded kernel beside its wrap mode on
   the same block and one PyTorch call computing the padded function
   (a cuDNN ``conv3d`` of the padded level, a depthwise ``F.conv2d`` of
   the padded lead stage, valid along X), checked once against the plain
   version.

It exits non-zero, printing no result, without a CUDA device or if any
phase fails. The last line is ``{"ok": true, "device": {...}}``; the line
before it a JSON list of the kernels with their launches, errors, times and
bounds (the float64 instantiations of the per-level and 1D kernels in a
``float64`` entry each, the flat and multilevel kernels' per-level route
time in ``per_level_route_ms``, the kernel alone queued behind a sleep in
``queued_ms`` (the flat, multilevel, 1D and elementwise kernels), the
multilevel kernels' flat-kernel time in
``flat_route_ms``, the four kernels with a halo-padded mode their sharded
path's numbers in a ``valid`` entry, with the wrap mode's time on the same
block in ``wrap_ms`` and the padded function's library call in
``library_ms``); the line before that the card's name and power limit.
"""

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

SHAPE = (256, 256, 256)
LEVEL = 3
THRESHOLD = 0.1
F32_TOL = 1e-5  # relative to max|plain|: float32 sums taken in another order
BF16_TOL = 1e-2  # relative: bfloat16 storage rounds at 2^-8
F64_TOL = 1e-12  # relative: float64 sums taken in another order
SOLVER_TOL = 1e-4  # relative: 10 iterations of the above, float32 momentum
LAM, ITERS, SAMPLING = 0.05, 10, 0.4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12  # H100 SXM float64 outside the tensor cores (data sheet)
N1 = 2**23  # the long 1D signal: db6 L4
N1M = 1_000_000  # bench.py's 1D config: db4 L3
PAIR = (2, 22) + SHAPE  # the split pair of 256^3 L3 bands
SHAPE4 = (128, 128, 128, 32)  # a dynamic volume: 128^3 frames, 32 time points
CS_SHAPE4 = (128, 128, 64, 32)  # 4D CS-MRI k-t data
STAGE_KERNELS = ("nddwt_lane_dec", "nddwt_lead_dec", "nddwt_lead_adj",
                 "nddwt_lane_adj")
FLAT_KERNELS = ("nddwt_flat_pair", "nddwt_flat_iter")
FLAT_SOURCE = "non_decimated_wavelets_tpu_torch/ops/csrc/nddwt_flat.cu"
MULTI_KERNELS = ("nddwt_dec_multi", "nddwt_rec_multi")
MULTI_SOURCE = "non_decimated_wavelets_tpu_torch/ops/csrc/nddwt_multi.cu"
ONE_MULTI = dict.fromkeys(MULTI_KERNELS, 1)  # a dec and a rec on the multilevel kernels
# The multilevel paths: a real 128^3 step beyond the flat route, a multi-coil
# slice (N complex 256^2 items), a complex volume beyond the flat kernel.
MULTI_VOLUME, COILS, COIL_SHAPE, CPLX_VOLUME = (128, 128, 128), 8, (256, 256), (128, 128, 160)
# The JAX multilevel tests' cases (tests/test_pallas.py:45-50) and odd extents.
MULTI_CASES = [((64, 128), "db2", 3), ((32, 16, 128), "db4", 3),
               ((16, 16, 256), ("db1", "db3", "db2"), 2), ((24, 8, 128), ("db6", "db2", "db4"), 4),
               ((37, 29, 41), "db4", 3), ((50, 33), ("db2", "db6"), 4)]
# (shape, wavelet, level, batches) where the multilevel kernels' persistent
# schedule could go wrong: L4 and L5 (level 3 reads the ping slot that level
# 1 read and level 2 rewrote), odd extents, an extent equal to K, batches of
# 1 and 16 (a 2D batch fills the view's pass-through slot, four items' rows
# a plane tile), runtime tap loops (db5, mixed wavelets) in 2D and 3D.
MULTI_DEEP_CASES = [((37, 29, 41), "db4", 4, (1, 3)), ((37, 29, 41), "db4", 5, (2,)),
                    ((45, 61), "db4", 4, (1, 16)), ((45, 61), "db4", 5, (5,)),
                    ((40, 36, 20), "db5", 4, (2,)), ((100, 90), "db5", 5, (1, 16)),
                    ((24, 30, 28), ("db2", "db3", "db1"), 5, (1,)),
                    ((9, 300), ("db2", "db6"), 4, (16,)), ((8, 40), "db4", 4, (3,))]
SOLVE_SHAPE, SOLVE_ITERS = (256, 256), 100  # the one-launch FISTA solves
CHAIN_SHAPE, CHAIN_WV, CHAIN_SWEEPS = (264, 264), ("db1", "db3"), 20  # nd_dwt_2D's
SPLIT_SHAPE = (128, 128)  # the one-launch dec_rec_split
FLAT_GROUPS_SHAPE = (48, 40, 36)  # a 3D flat launch whose plan takes its axes in groups
FIVE_D = (((12, 10, 8, 6, 5), "db1", 2), ((8, 8, 8, 8, 8), "db2", 1))
# The streamed synthesis (nddwt_rec_level, built from nddwt_level.cu, and
# nddwt_lead_adj, from nddwt_4d.cu) is written in this header, and the cases
# its plan can get wrong: a streamed axis of extent K, extents no multiple of
# the plane tile or chunk, K = 2, the longest filter the per-level route takes
# (db14; db11 in float64), 2D mixed filters; X of extent K and odd extents.
STREAM_SOURCE = "non_decimated_wavelets_tpu_torch/ops/csrc/nddwt_stream.cuh"
# nddwt_rec_level's 3D views of 2 to 8 taps with rows on 16 bytes run the
# plane body instead (the cases above of those filters).
PLANE_SOURCE = "non_decimated_wavelets_tpu_torch/ops/csrc/nddwt_plane.cuh"
STREAM_REC_CASES = [((8, 40, 72), "db4"), ((37, 41, 45), "db4"), ((24, 40, 72), "db1"),
                    ((30, 30, 31), "db14"), ((24, 25, 26), "db11"), ((9, 300), ("db2", "db6"))]
STREAM_LEAD_CASES = [((8, 64, 20, 10), "db4"), ((37, 41, 20, 10), "db2")]
# The streamed analysis (nddwt_dec_level, nddwt_lead_dec) is written in the
# same header: (shape, wavelet, halo-padded axes) at a streamed axis of
# extent K, extents no multiple of the plane tile or chunk, db1, db2, db4,
# runtime taps (db10, db11: its walk split in float64; the db20 stage
# route), 2D (db38: its walk split in float64) and padded slots 0 and 1.
STREAM_DEC_CASES = [((8, 40, 72), "db4", None), ((37, 41, 45), "db2", None),
                    ((24, 40, 72), "db1", None), ((30, 30, 31), "db10", None),
                    ((24, 25, 26), "db11", None), ((9, 300), ("db2", "db6"), None),
                    ((80, 90), "db38", None), ((12, 9, 10), "db2", (True, False, False)),
                    ((10, 12, 9), "db4", (False, True, False))]
STREAM_LEAD_DEC_CASES = [((8, 64, 20, 10), "db4", None), ((37, 41, 20, 10), "db2", None),
                         ((40, 41, 45), "db20", None), ((9, 10, 4, 6), "db2", (True, False)),
                         ((9, 10, 6, 7), "db3", (False, True))]
# The lane body (nddwt_lane_dec, nddwt_lane_adj, built from nddwt_4d.cu) is
# written in this header, and the cases its plan and copies can get wrong:
# (shape, wavelet, forced plan (R, Zc, stages) or None, the input's element
# offset in its buffer): units of whole slabs and chunks of Z that end
# ragged, a chunk split at the periodic wrap, odd Z*T at an odd offset
# (ragged head and tail pieces; in bfloat16 a slab at an odd element),
# Z = K, T = 1 (the 3D long-filter route), T > 128 and > 256, K = 76, one
# unit buffer, mixed filters, fewer units than CTAs and many times more,
# and a T row too long for the lane body (the tile body's class).
LANE_SOURCE = "non_decimated_wavelets_tpu_torch/ops/csrc/nddwt_lane.cuh"
LANE_CASES = [((5, 3, 11, 9), "db2", (4, 11, 2), 1), ((3, 2, 13, 7), "db2", (1, 4, 2), 3),
              ((3, 2, 13, 7), "db3", (1, 5, 1), 1), ((4, 3, 8, 9), "db4", None, 1),
              ((4, 3, 8, 9), "db4", (1, 1, 2), 0), ((6, 5, 44), "db20", None, 1),
              ((16, 16, 44), "db20", (1, 5, 3), 0), ((2, 3, 4, 136), "db2", None, 0),
              ((6, 4, 4, 300), "db2", None, 1), ((3, 2, 76, 77), "db38", None, 1),
              ((8, 16, 8, 16), ("db1", "db2", "db3", "db2"), None, 0),
              ((2, 2, 20, 10), "db2", None, 0), ((256, 256, 20, 10), "db2", None, 1),
              ((4, 4, 8, 1600), "db4", None, 0)]
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "nddwt_dec_level": (STREAM_SOURCE, "non_decimated_wavelets_tpu/ops/pallas_kernels.py:519"),
    "nddwt_rec_level": (PLANE_SOURCE + " (3D, 2-8 taps); " + STREAM_SOURCE,
                        "non_decimated_wavelets_tpu/ops/pallas_kernels.py:1389"),
    "nddwt_mag_shrink_pair": (
        "non_decimated_wavelets_tpu_torch/ops/csrc/nddwt_elemwise.cu",
        "non_decimated_wavelets_tpu/ops/pallas_elemwise.py:57"),
    "nddwt_fista_step": (
        "non_decimated_wavelets_tpu_torch/ops/csrc/nddwt_elemwise.cu",
        "non_decimated_wavelets_tpu/ops/pallas_elemwise.py:108"),
    **{name: (STREAM_SOURCE if name in ("nddwt_lead_dec", "nddwt_lead_adj") else LANE_SOURCE,
              f"non_decimated_wavelets_tpu/ops/pallas_4d.py:{line}")
       for name, line in zip(STAGE_KERNELS, (503, 592, 882, 998))},
    "nddwt_dec1_level": ("non_decimated_wavelets_tpu_torch/ops/csrc/nddwt_1d.cu",
                         "non_decimated_wavelets_tpu/ops/pallas_padded.py:501"),
    "nddwt_rec1_level": ("non_decimated_wavelets_tpu_torch/ops/csrc/nddwt_1d.cu",
                         "non_decimated_wavelets_tpu/ops/pallas_padded.py:572"),
    "nddwt_flat_pair": (FLAT_SOURCE, "non_decimated_wavelets_tpu/ops/pallas_flat.py:269; "
                        "non_decimated_wavelets_tpu/ops/pallas_resident.py:84,269,350"),
    "nddwt_flat_iter": (FLAT_SOURCE, "non_decimated_wavelets_tpu/ops/pallas_flat.py:495"),
    "nddwt_dec_multi": (MULTI_SOURCE, "non_decimated_wavelets_tpu/ops/pallas_kernels.py:1037"),
    "nddwt_rec_multi": (MULTI_SOURCE, "non_decimated_wavelets_tpu/ops/pallas_kernels.py:1526"),
}
# The float64 instantiations of the per-level kernels replace the TPU's
# float64-accurate (double-f32) levels.
F64_REPLACES = {"nddwt_dec_level": "non_decimated_wavelets_tpu/ops/pallas_df32.py:271",
                "nddwt_rec_level": "non_decimated_wavelets_tpu/ops/pallas_df32.py:392"}
LEVEL1 = {"nddwt_dec1_level", "nddwt_rec1_level"}
# The reference's own test configurations (Test/nddwt{1,2,3,4}D_test.m:5,
# tests/test_reference_configs.py), at full size: class, sizes, wavelets, level.
CLASS_CONFIGS = [
    ("nd_dwt_1D", (54321,), "db4", 3),
    ("nd_dwt_2D", (264, 264), ("db1", "db3"), 3),
    ("nd_dwt_3D", (164, 64, 40), ("db1", "db3", "db9"), 2),
    ("nd_dwt_4D", (64, 64, 20, 10), "db2", 2),
    ("harr_nddwt_2D", (264, 264), "db1", 2),
    ("harr_nddwt_4D", (64, 64, 20, 10), "db1", 2),
]

failures = []


def check(what, err, tol, show=True):
    """Hold ``err`` to ``tol``; print the check (a failure always)."""
    ok = err <= tol
    if show or not ok:
        print(f"  {what}: max_abs_err {err:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(what)
    return err


def check_launches(what, got, want):
    """Hold the launch counts read just after one run against ``want``; a
    kernel that ``want`` does not name must not have launched."""
    want = {**dict.fromkeys(got, 0), **want}
    ok = got == want
    print(f"  launches, {what}: {got} {'ok' if ok else f'FAIL (want {want})'}")
    if not ok:
        failures.append(f"launches, {what}: {got}, want {want}")
    return got


def max_err(a, b):
    """max |a - b|, in float64 for float64 and complex128 arrays."""
    import torch

    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    dt = torch.float64 if a.dtype == torch.float64 else torch.float32
    return (a.to(dt) - b.to(dt)).abs().max().item()


def rel_tol(ref, dtype):
    import torch

    rel = {torch.float32: F32_TOL, torch.float64: F64_TOL}.get(dtype, BF16_TOL)
    return rel * ref.double().abs().max().item()


def timed(fn, reps, warm=2):
    """Mean ms per call over ``reps`` calls after ``warm`` warm-up calls."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_queued(fn, reps, warm=2):
    """Mean ms per call of ``reps`` calls enqueued behind a ~25 ms
    ``torch.cuda._sleep``: the card runs them back to back, so the events
    read the kernels alone and never a gap where the card waits for the
    host."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, flops, flops_per_s=F32_FLOPS):
    """The least time for the work: bytes over the memory rate or flops over
    the compute type's rate, whichever is larger; and which of the two it
    is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv_weights(taps, rec, dtype=None):
    """The 8 bands of one 3D level as a convolution's weights: band b's
    filter is the outer product of axis a's lo (bit a of b clear) or hi row;
    flipped for the synthesis, whose input is the 8 bands."""
    import numpy as np
    import torch

    w = np.stack([
        np.einsum("i,j,k->ijk", *(t[(b >> a) & 1] for a, t in enumerate(taps)))
        for b in range(8)
    ])
    if rec:
        w = w[:, ::-1, ::-1, ::-1][None]
    else:
        w = w[:, None]
    return torch.from_numpy(np.ascontiguousarray(w)).to(dtype or torch.float32).cuda()


def conv1d_weights(taps, rec, dtype):
    """One 1D level as a convolution's weights: the lo and hi rows as two
    output channels, or, flipped, as two input channels of the synthesis."""
    import numpy as np
    import torch

    t = np.asarray(taps[0])
    w = t[:, None, :] if not rec else t[None, :, ::-1]
    return torch.from_numpy(np.ascontiguousarray(w)).to(dtype).cuda()


def conv_pad(x, taps, rec):
    """Circular pad of a (C, *s) array for the convolution: the analysis
    halo (K/2 - 1, K/2) per axis, the synthesis halo mirrored."""
    import torch.nn.functional as F

    pads = []
    for t in reversed(taps):
        k = len(t[0])
        left = k // 2 - 1
        pads += [k - 1 - left, left] if rec else [left, k - 1 - left]
    return F.pad(x[None], pads, mode="circular")


LIBRARY_CALL = {"nddwt_lane_dec": "F.conv2d", "nddwt_lane_adj": "F.conv2d",
                "nddwt_lead_dec": "depthwise F.conv2d", "nddwt_lead_adj": "depthwise F.conv2d"}


def _stage_halo(K, rec):
    """(left, right) circular pad of one axis: the analysis halo (K/2 - 1,
    K/2), mirrored for the adjoint."""
    left = K // 2 - 1
    return (K - 1 - left, left) if rec else (left, K - 1 - left)


def _band_weights(rows, cols, rec):
    """The 4 bands of a 2D stage, band b = bit0 + 2 bit1: outer(rows[bit0],
    cols[bit1]), flipped for the adjoint."""
    import numpy as np

    w = np.stack([np.outer(rows[b & 1], cols[b >> 1]) for b in range(4)])
    return np.ascontiguousarray(w[:, ::-1, ::-1] if rec else w)


def lead_conv(v, taps, rec, padded=False):
    """A 4D lead stage as one depthwise ``F.conv2d`` over (X, Y) in
    channels-last memory, the Z*T lane columns the groups (4 outputs a
    group, or 4 inputs for the adjoint); the caller turns TF32 off. ``v``:
    the 4 lane bands (4, X, Y, Z, T), or for the adjoint (``rec``) the 16
    bands; ``padded``: X carries the halo of the halo-padded mode
    (``halo_widths``), so the convolution is valid along X, else X is padded
    circularly; Y is padded circularly. The input is padded and laid out
    here, before any timer. Returns ``(call, bands)``: ``call()`` runs the
    convolution, ``bands(out)`` views its output as the plain version's
    (16 or 4, X, Y, Z, T), band ``4 c + a`` of lane band ``c``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    nb, Xp, Y, Z, T = v.shape
    zt, (tx, ty) = Z * T, taps[:2]
    kx, ky = len(tx[0]), len(ty[0])
    X = Xp - (kx - 1) if padded else Xp
    pads = _stage_halo(ky, rec) + ((0, 0) if padded else _stage_halo(kx, rec))
    if rec:  # (4, 4 Z*T, X, Y), channel 4 zt + a, groups Z*T -> (4, Z*T, X, Y)
        w = np.tile(_band_weights(tx, ty, True)[None], (zt, 1, 1, 1))
        lay = v.view(4, 4, Xp, Y, zt).permute(0, 2, 3, 4, 1).reshape(4, Xp, Y, 4 * zt)
        lay = lay.permute(0, 3, 1, 2)

        def bands(out):
            return out.permute(0, 2, 3, 1).reshape(4, X, Y, Z, T)
    else:  # (4, Z*T, X, Y), groups Z*T -> (4, 4 Z*T, X, Y), channel 4 zt + a
        w = np.tile(_band_weights(tx, ty, False), (zt, 1, 1))[:, None]
        lay = v.view(4, Xp, Y, zt).permute(0, 3, 1, 2)

        def bands(out):
            return out.view(4, zt, 4, X, Y).permute(0, 2, 3, 4, 1).reshape(16, X, Y, Z, T)
    cl = torch.channels_last
    inp = F.pad(lay, pads, mode="circular").contiguous(memory_format=cl)
    del lay
    w = torch.from_numpy(w).to(v.device, v.dtype).contiguous(memory_format=cl)
    return (lambda: F.conv2d(inp, w, groups=zt)), bands


def stage_library(x, temp, big, taps):
    """One PyTorch call computing each 4D stage on the kernels' arrays (the
    yardstick ``library_ms``, TF32 off), each checked once against its plain
    version (``level4_ref``): the lane stage is a 2D convolution over (Z,
    T) on the (X*Y, Z, T) view, X*Y the batch (the analysis 4 output
    channels of the lo/hi outer products, the adjoint 4 input channels of
    the reversed ones); the lead stage a depthwise 2D convolution over (X,
    Y) in channels-last memory (``lead_conv``). The inputs are padded
    circularly and laid out before the timer. ``x`` (X, Y, Z, T), ``temp``
    its lane bands, ``big`` 16 bands."""
    import torch
    import torch.nn.functional as F

    from non_decimated_wavelets_tpu_torch.ops import level4_ref

    X, Y, Z, T = x.shape
    xy = X * Y

    def pad(v, k_h, k_w, rec):
        return F.pad(v, _stage_halo(k_w, rec) + _stage_halo(k_h, rec), mode="circular")

    out = {}
    tz, tt = taps[2], taps[3]
    kz, kt = len(tz[0]), len(tt[0])
    # lane analysis: (X*Y, 1, Z, T) -> (X*Y, 4, Z, T)
    w = torch.from_numpy(_band_weights(tz, tt, False)[:, None].copy()).float().cuda()
    xp = pad(x.reshape(xy, 1, Z, T), kz, kt, False)
    want = level4_ref.lane_dec_ref(x, taps)
    check("F.conv2d as nddwt_lane_dec",
          max_err(F.conv2d(xp, w), want.view(4, xy, Z, T).transpose(0, 1)),
          F32_TOL * want.abs().max().item())
    del want
    out["nddwt_lane_dec"] = timed(lambda: F.conv2d(xp, w), 3, warm=1)
    del xp
    # lane adjoint, scale 1/16: (X*Y, 4, Z, T) -> (X*Y, 1, Z, T)
    w = torch.from_numpy(_band_weights(tz, tt, True)[None] / 16).float().cuda()
    tp = pad(temp.view(4, xy, Z, T).transpose(0, 1), kz, kt, True)
    want = level4_ref.lane_adj_ref(temp, taps, 1 / 16)
    check("F.conv2d as nddwt_lane_adj", max_err(F.conv2d(tp, w).view(x.shape), want),
          F32_TOL * want.abs().max().item())
    del want
    out["nddwt_lane_adj"] = timed(lambda: F.conv2d(tp, w), 3, warm=1)
    del tp
    torch.cuda.empty_cache()
    # lead analysis
    call, bands = lead_conv(temp, taps, False)
    want = torch.empty((16,) + tuple(x.shape), device=x.device)
    want[0] = level4_ref.lead_dec_ref(temp, want, 1, taps)
    check("depthwise F.conv2d as nddwt_lead_dec", max_err(bands(call()), want),
          F32_TOL * want.abs().max().item())
    del want
    out["nddwt_lead_dec"] = timed(call, 2, warm=1)
    del call
    torch.cuda.empty_cache()
    # lead adjoint
    call, bands = lead_conv(big, taps, True)
    want = level4_ref.lead_adj_ref(big, None, [("y", b) for b in range(16)], taps)
    check("depthwise F.conv2d as nddwt_lead_adj", max_err(bands(call()), want),
          F32_TOL * want.abs().max().item())
    del want
    out["nddwt_lead_adj"] = timed(call, 2, warm=1)
    del call
    torch.cuda.empty_cache()
    return out


def _stop_children() -> list:
    """Stops every child of this process that is still there when the
    script ends (it must leave no process running); returns their command
    lines."""
    import os
    import signal

    left = []
    for pid in os.listdir("/proc") if os.path.isdir("/proc") else ():
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == os.getpid():
            left.append((int(pid), cmd))
    for pid, _ in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + 10
    for pid, _ in left:
        with contextlib.suppress(ChildProcessError):
            while os.waitpid(pid, os.WNOHANG)[0] == 0:
                if time.monotonic() > deadline:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                    break
                time.sleep(0.05)
    return [cmd for _, cmd in left]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    import non_decimated_wavelets_tpu_torch as tw
    from non_decimated_wavelets_tpu_torch import oracle
    from non_decimated_wavelets_tpu_torch.models import (
        fista_cs_mri, fista_inpaint, fista_inpaint_split, soft_threshold)
    from non_decimated_wavelets_tpu_torch.models.cs_recon import _fista_schedule
    from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
    from non_decimated_wavelets_tpu_torch.ops import (
        direct_path, elemwise, elemwise_ref, flat, flat_ref, level4_ref, level_ref, multi,
        multi_ref)

    import chip_flat_crossover as xover
    import chip_sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"

    # ---------------------------------------------------------- phase 1
    print(f"phase 1: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = ck.build()
    ck.load()
    ck.load4()
    ck.load1()
    elemwise.load()
    flat.load()
    multi.load()
    print(f"  built and loaded {', '.join(p.name for p in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    # The kernels each library holds (cuobjdump's resource usage): the
    # instantiations a source costs the build, and the lane body's registers
    # and local memory (spills) per instantiation.
    usage = subprocess.run([str(Path(ck._nvcc()).parent / "cuobjdump"), "-res-usage",
                            str(ck.library_path("nddwt_4d"))],
                           capture_output=True, text=True, timeout=120).stdout.splitlines()
    funcs = [(line.split("Function ", 1)[1].rstrip(":"), usage[i + 1].strip())
             for i, line in enumerate(usage[:-1]) if line.strip().startswith("Function ")]
    lane_funcs = [f for f in funcs if "lane_body" in f[0]]
    print(f"  nddwt_4d.cu: {len(funcs)} kernel instantiations, {len(lane_funcs)} of the "
          "lane body (nddwt_lane.cuh)")
    for name, res in lane_funcs:
        print(f"    {name[:64]}: {res}")

    # ---------------------------------------------------------- phase 2
    print("phase 2: each kernel against its plain version on the card")
    gen = torch.Generator(device=dev)

    def randn(shape, dt=torch.float32):
        """Seeded normal values, drawn in float64 for float64 arrays."""
        draw = torch.float64 if dt == torch.float64 else torch.float32
        return torch.randn(shape, generator=gen, device=dev, dtype=draw).to(dt)

    main_err = {name: 0.0 for name in KERNELS}
    main_err64 = {name: 0.0 for name in (*F64_REPLACES, *LEVEL1)}
    cases = [
        ((24, 40, 72), "db4", torch.float32),
        ((16, 16, 128), ("db2", "db3", "db4"), torch.float32),
        ((32, 256), ("db2", "db6"), torch.float32),
        ((24, 40, 72), "db4", torch.bfloat16),
        (SHAPE, "db4", torch.float32),
        ((24, 40, 72), ("db2", "db3", "db4"), torch.float64),
        ((32, 256), ("db2", "db6"), torch.float64),
        (SHAPE, "db4", torch.float64),
    ]
    for seed, (shape, wv, dt) in enumerate(cases):
        gen.manual_seed(seed)
        plan = tw.NDDWT(wv, shape, device=dev)
        nd = len(shape)
        nb, B = 2**nd, tw.num_bands(nd, LEVEL)
        tag = f"{shape} {wv} {str(dt).removeprefix('torch.')}"
        errs = main_err64 if dt == torch.float64 else main_err
        x = randn(shape, dt)
        for lam in (0.0, THRESHOLD):
            for final in (False, True):
                bk = torch.zeros((B,) + shape, dtype=dt, device=dev)
                br = bk.clone()
                ak = ck.dec_level(x, bk, B - (nb - 1), plan.taps_hp, lam, final)
                ar = level_ref.dec_level_ref(x, br, B - (nb - 1), plan.taps_hp,
                                             lam, final)
                torch.cuda.synchronize()
                tol = rel_tol(br, dt)
                err = check(f"nddwt_dec_level {tag} lam={lam} final={final}",
                            max_err(bk, br), tol)
                if not final:
                    err = max(err, check("    next approx", max_err(ak, ar), tol))
                if shape == SHAPE:
                    errs["nddwt_dec_level"] = max(errs["nddwt_dec_level"], err)
        y = randn((B,) + shape, dt)
        for src in ([("y", b) for b in range(nb)],
                    [("a", 0)] + [("y", nb + b - 1) for b in range(1, nb)]):
            for scale in (1.0, 1.0 / nb):
                k = ck.rec_level(y, x, src, plan.taps_hp, scale)
                r = level_ref.rec_level_ref(y, x, src, plan.taps_hp, scale)
                torch.cuda.synchronize()
                err = check(f"nddwt_rec_level {tag} band0={src[0]} scale={scale}",
                            max_err(k, r), rel_tol(r, dt))
                if shape == SHAPE:
                    errs["nddwt_rec_level"] = max(errs["nddwt_rec_level"], err)
        del x, y, bk, br, ak, ar, k, r
        torch.cuda.empty_cache()

    for seed, (shape, dt) in enumerate([
        (PAIR, torch.float32),
        ((2, 15, 24, 40, 72), torch.float32),
        ((2, 15, 23, 41, 73), torch.float32),  # odd count: element accesses
        ((2, 15, 24, 40, 72), torch.bfloat16),
        ((2, 15, 23, 41, 73), torch.bfloat16),
        ((2, 15, 24, 40, 72), torch.float64),
        ((2, 15, 23, 41, 73), torch.float64),
    ]):
        gen.manual_seed(10 + seed)
        y = randn(shape, dt)
        for lam in (0.0, THRESHOLD):
            k = elemwise.mag_shrink_pair(y, lam)
            r = elemwise_ref.mag_shrink_pair_ref(y, lam)
            torch.cuda.synchronize()
            err = check(f"nddwt_mag_shrink_pair {shape} "
                        f"{str(dt).removeprefix('torch.')} lam={lam}",
                        max_err(k, r), rel_tol(r, dt))
            if not torch.equal(k[:, 0], y[:, 0]):
                failures.append(f"nddwt_mag_shrink_pair {shape}: band 0 changed")
            if shape == PAIR:
                main_err["nddwt_mag_shrink_pair"] = max(
                    main_err["nddwt_mag_shrink_pair"], err)
        del y, k, r

    # (array shape, mask shape, dtype, offset): the offset views the
    # operands one element past an aligned base (element accesses).
    for seed, (shape, mshape, dt, off) in enumerate([
        (SHAPE, SHAPE, torch.float32, 0),
        ((2,) + SHAPE, SHAPE, torch.float32, 0),
        ((24, 40, 72), (24, 40, 72), torch.float32, 1),
        ((2, 23, 41, 73), (23, 41, 73), torch.float32, 0),
        ((2, 24, 40, 72), (24, 40, 72), torch.bfloat16, 0),
        ((23, 41, 73), (23, 41, 73), torch.bfloat16, 1),
        ((2,) + SHAPE, SHAPE, torch.float64, 0),
        ((23, 41, 73), (23, 41, 73), torch.float64, 1),
    ]):
        gen.manual_seed(20 + seed)
        n = int(np.prod(shape))
        buf = randn(3 * n + off, dt)
        xn, xp, b = (buf[off + i * n: off + (i + 1) * n].view(shape) for i in range(3))
        mask = (torch.rand(mshape, generator=gen, device=dev) < SAMPLING).to(dt)
        k = elemwise.fista_step(xn, xp, mask, b, 0.6, 1.0)
        r = elemwise_ref.fista_step_ref(xn, xp, mask, b, 0.6, 1.0)
        torch.cuda.synchronize()
        err = check(f"nddwt_fista_step {shape} mask {mshape} "
                    f"{str(dt).removeprefix('torch.')} offset {off}",
                    max_err(k, r), rel_tol(r, dt))
        if shape == SHAPE:
            main_err["nddwt_fista_step"] = err
        del buf, xn, xp, b, mask, k, r
    torch.cuda.empty_cache()

    # The stage kernels of the 4D level; a 3D db20 plan takes them too.
    for seed, (shape, wv, dt) in enumerate([
        ((64, 64, 20, 10), "db2", torch.float32),  # the reference's odd 4D volume
        ((64, 64, 20, 10), "db2", torch.bfloat16),
        ((16, 16, 8, 160), "db4", torch.float32),  # T > 128
        ((40, 41, 45), "db20", torch.float32),  # the 3D long-filter route
        ((40, 41, 45), "db20", torch.bfloat16),
        ((64, 64, 20, 10), "db2", torch.float64),
        ((40, 41, 45), "db20", torch.float64),
        (SHAPE4, "db4", torch.float32),
    ]):
        gen.manual_seed(30 + seed)
        taps = tw.NDDWT(wv, shape, device=dev).taps_hp
        tag = f"{shape} {wv} {str(dt).removeprefix('torch.')}"
        errs = dict.fromkeys(STAGE_KERNELS, 0.0)
        x = randn(shape, dt)
        k = ck.lane_dec(x, taps)
        temp = level4_ref.lane_dec_ref(x, taps)
        torch.cuda.synchronize()
        errs["nddwt_lane_dec"] = check(f"nddwt_lane_dec {tag}", max_err(k, temp),
                                       rel_tol(temp, dt))
        del k
        nb = 4 * temp.shape[0]
        for lam in (0.0, THRESHOLD):
            for final in (False, True):
                bk = torch.zeros((nb,) + shape, dtype=dt, device=dev)
                br = bk.clone()
                ak = ck.lead_dec(temp, bk, 1, taps, lam, final)
                ar = level4_ref.lead_dec_ref(temp, br, 1, taps, lam, final)
                torch.cuda.synchronize()
                tol = rel_tol(br, dt)
                err = check(f"nddwt_lead_dec {tag} lam={lam} final={final}",
                            max_err(bk, br), tol)
                if not final:
                    err = max(err, check("    next approx", max_err(ak, ar), tol))
                errs["nddwt_lead_dec"] = max(errs["nddwt_lead_dec"], err)
                del bk, br, ak, ar
        y = randn((2 * nb - 1,) + shape, dt)
        for src in ([("y", b) for b in range(nb)],
                    [("a", 0)] + [("y", nb + b - 1) for b in range(1, nb)]):
            k = ck.lead_adj(y, x, src, taps)
            r = level4_ref.lead_adj_ref(y, x, src, taps)
            torch.cuda.synchronize()
            errs["nddwt_lead_adj"] = max(errs["nddwt_lead_adj"], check(
                f"nddwt_lead_adj {tag} band0={src[0]}", max_err(k, r), rel_tol(r, dt)))
            del k, r
        del y
        for scale in (1.0, 1.0 / nb):
            k = ck.lane_adj(temp, taps, scale)
            r = level4_ref.lane_adj_ref(temp, taps, scale)
            torch.cuda.synchronize()
            errs["nddwt_lane_adj"] = max(errs["nddwt_lane_adj"], check(
                f"nddwt_lane_adj {tag} scale={scale}", max_err(k, r), rel_tol(r, dt)))
            del k, r
        if shape == SHAPE4:
            main_err.update(errs)
        del x, temp
        torch.cuda.empty_cache()

    # The lane body's edge cases (LANE_CASES) in each dtype; one line per case
    # and direction, with the route and plan it took (a forced plan replaces
    # the plan function for that case), the adjoint at two scales.
    lane_plan = ck._lane_plan
    for seed, ((shape, wv, plan, off), dt) in enumerate(
            (c, d) for c in LANE_CASES
            for d in (torch.float32, torch.bfloat16, torch.float64)):
        gen.manual_seed(1800 + seed)
        taps = tw.NDDWT(wv, (80,) * len(shape), device=dev).taps_hp  # K <= 80 on any axis
        nl = 2 ** (len(shape) - 2)
        vox = int(np.prod(shape))
        x = randn((vox + off,), dt)[off:].view(shape)
        part = randn((nl * vox + off,), dt)[off:].view((nl,) + shape)
        if plan:
            ck._lane_plan = lambda *a, p=plan: p
        try:
            routes_of = [ck._stage_geometry(shape, taps, True, adj, dt) for adj in (0, 1)]
            k = ck.lane_dec(x, taps)
            r = level4_ref.lane_dec_ref(x, taps)
            torch.cuda.synchronize()
            err_dec, tol_dec = max_err(k, r), rel_tol(r, dt)
            err = tol = 0.0
            for scale in (1.0, 1.0 / (4 * nl)):
                k = ck.lane_adj(part, taps, scale)
                r = level4_ref.lane_adj_ref(part, taps, scale)
                torch.cuda.synchronize()
                err, tol = max(err, max_err(k, r)), max(tol, rel_tol(r, dt))
        finally:
            ck._lane_plan = lane_plan
        tag = f"{shape} {wv} offset {off} {str(dt).removeprefix('torch.')}"
        for name, e, t, (geo, body) in (("nddwt_lane_dec", err_dec, tol_dec, routes_of[0]),
                                        ("nddwt_lane_adj", err, tol, routes_of[1])):
            how = f"plan {tuple(geo[2])}" if body == "lane" else f"tile body {tuple(geo[2])}"
            check(f"{name} lane {tag}, {how}", e, t)
        del x, part, k, r
    torch.cuda.empty_cache()

    # The streamed synthesis' edge cases (STREAM_REC_CASES, STREAM_LEAD_CASES)
    # in each dtype; one line per case, both band sources (y only, and band 0
    # from approx). The longest filter is the per-level route's own for the
    # dtype (db14 takes the stage kernels in float64).
    for seed, ((shape, wv), dt) in enumerate(
            (c, d) for c in STREAM_REC_CASES + STREAM_LEAD_CASES
            for d in (torch.float32, torch.bfloat16, torch.float64)):
        if wv == ("db14" if dt == torch.float64 else "db11"):
            continue
        gen.manual_seed(1600 + seed)
        taps = tw.NDDWT(wv, shape, device=dev).taps_hp
        nb = 2 ** len(shape)
        lead = len(shape) == 4
        kernel, plain = ((ck.lead_adj, level4_ref.lead_adj_ref) if lead else
                         (lambda *a: ck.rec_level(*a, 1 / nb),
                          lambda *a: level_ref.rec_level_ref(*a, 1 / nb)))
        y, x = randn((2 * nb - 1,) + shape, dt), randn(shape, dt)
        err = tol = 0.0
        for src in ([("y", b) for b in range(nb)],
                    [("a", 0)] + [("y", nb + b - 1) for b in range(1, nb)]):
            k, r = kernel(y, x, src, taps), plain(y, x, src, taps)
            torch.cuda.synchronize()
            err, tol = max(err, max_err(k, r)), max(tol, rel_tol(r, dt))
        check(f"{'nddwt_lead_adj' if lead else 'nddwt_rec_level'} streamed {shape} {wv} "
              f"{str(dt).removeprefix('torch.')}", err, tol)
        del y, x, k, r
    torch.cuda.empty_cache()

    # The streamed analysis' edge cases (STREAM_DEC_CASES,
    # STREAM_LEAD_DEC_CASES) in each dtype; one line per case: lam 0 and
    # 0.1, final both ways, the details written past band 1.
    for seed, ((shape, wv, pad), dt) in enumerate(
            (c, d) for c in STREAM_DEC_CASES + STREAM_LEAD_DEC_CASES
            for d in (torch.float32, torch.bfloat16, torch.float64)):
        gen.manual_seed(1700 + seed)
        taps = tw.NDDWT(wv, shape, device=dev).taps_hp
        stage = wv == "db20" or len(shape) == 4  # the lead stage's view
        nl = 2 ** (len(shape) - 2) if stage else 1
        flags = (pad or (False,) * (2 if stage else len(shape)))
        ins = ck._padded_shape(shape, taps, flags + (False,) * (len(shape) - len(flags)))
        x = randn(((nl,) if stage else ()) + ins, dt)
        nbands = 4 * nl if stage else 2 ** len(shape)
        kernel, plain = ((ck.lead_dec, level4_ref.lead_dec_ref) if stage else
                         (ck.dec_level, level_ref.dec_level_ref))
        err = tol = 0.0
        for lam in (0.0, THRESHOLD):
            for final in (False, True):
                bk = torch.zeros((2 * nbands - 1,) + shape, dtype=dt, device=dev)
                br = bk.clone()
                ak = kernel(x, bk, nbands, taps, lam, final, pad)
                ar = plain(x, br, nbands, taps, lam, final, pad)
                torch.cuda.synchronize()
                err, tol = max(err, max_err(bk, br)), max(tol, rel_tol(br, dt))
                if not final:
                    err = max(err, max_err(ak, ar))
        check(f"{'nddwt_lead_dec' if stage else 'nddwt_dec_level'} streamed {shape} {wv} "
              f"pad={pad} {str(dt).removeprefix('torch.')}", err, tol)
        del x, bk, br, ak, ar
    torch.cuda.empty_cache()

    # The 1D level kernels: bench.py's 1M-sample signal, the reference's
    # 54321-sample test length, N = K, and a 2^23-sample db6 signal.
    for seed, (n, wv) in enumerate([(N1M, "db4"), (54321, "db4"), (8, "db4"), (N1, "db6")]):
        taps = tw.NDDWT(wv, (n,), device=dev).taps_hp
        for dt in (torch.float32, torch.bfloat16, torch.float64):
            gen.manual_seed(40 + seed)
            tag = f"({n},) {wv} {str(dt).removeprefix('torch.')}"
            errs = dict.fromkeys(LEVEL1, 0.0)
            x = randn((n,), dt)
            for lam in (0.0, THRESHOLD):
                for final in (False, True):
                    bk = torch.zeros((3, n), dtype=dt, device=dev)
                    br = bk.clone()
                    ak = ck.dec1_level(x, bk, 2, taps, lam, final)
                    ar = level_ref.dec_level_ref(x, br, 2, taps, lam, final)
                    torch.cuda.synchronize()
                    tol = rel_tol(br, dt)
                    err = check(f"nddwt_dec1_level {tag} lam={lam} final={final}",
                                max_err(bk, br), tol)
                    if not final:
                        err = max(err, check("    next approx", max_err(ak, ar), tol))
                    errs["nddwt_dec1_level"] = max(errs["nddwt_dec1_level"], err)
            y = randn((3, n), dt)
            for src in ([("y", 0), ("y", 1)], [("a", 0), ("y", 2)]):
                for scale in (1.0, 0.5):
                    k = ck.rec1_level(y, x, src, taps, scale)
                    r = level_ref.rec_level_ref(y, x, src, taps, scale)
                    torch.cuda.synchronize()
                    errs["nddwt_rec1_level"] = max(errs["nddwt_rec1_level"], check(
                        f"nddwt_rec1_level {tag} band0={src[0]} scale={scale}",
                        max_err(k, r), rel_tol(r, dt)))
            if n >= 54321 and dt != torch.bfloat16:  # the class and 1D paths' shapes
                into = main_err64 if dt == torch.float64 else main_err
                for name in LEVEL1:
                    into[name] = max(into[name], errs[name])
            del x, y, bk, br, ak, ar, k, r
    torch.cuda.empty_cache()

    # The one-launch kernels: every mode, with and without the split pair,
    # at the JAX flat tests' shapes (tests/test_pallas.py:284-291), two 5D
    # shapes, N = K, the one-launch paths' shapes, a 3D shape whose plan
    # takes the axes in groups (FLAT_GROUPS_SHAPE) and a long filter whose
    # windows are longer than the extents (they wrap on both sides), also
    # on a last extent whose rows are copied in 16-byte pieces; one line
    # per case.
    flat_cases = [
        ((64, 64), "db2", 2), ((54,), "db4", 3), ((26, 26), ("db1", "db3"), 2),
        ((24, 18, 10), ("db2", "db3", "db2"), 2), ((264, 264), "db4", 1),
        ((14, 10, 6, 6), "db1", 2), *FIVE_D, ((8,), "db4", 3), ((8, 8), "db4", 2),
        (SOLVE_SHAPE, "db4", LEVEL), (CHAIN_SHAPE, CHAIN_WV, LEVEL),
        (SPLIT_SHAPE, "db4", LEVEL), (FLAT_GROUPS_SHAPE, "db4", 2), ((20, 22), "db10", 2),
        ((20, 24), "db10", 2),
    ]
    for shape, wv, lvl in flat_cases[-3:]:
        k = tuple(len(t[0]) for t in tw.NDDWT(wv, shape, device=dev).taps_hp)
        plans = {(dt, b): flat._flat_plan(shape, k, dt, b)
                 for dt in (torch.float32, torch.bfloat16, torch.float64) for b in (0, 2)}
        print(f"  flat plans at {shape} {wv}: " + "; ".join(
            f"{str(dt).removeprefix('torch.')} batch {b}: groups {p.ends} tile {p.tile}"
            for (dt, b), p in plans.items()))
        if shape == FLAT_GROUPS_SHAPE and all(len(p.ends) == 1 for p in plans.values()):
            failures.append(f"{shape}: no plan takes the axes in groups")
    lams3, moms3 = [0.3, 0.12, 0.05], [0.0, 0.28, 0.43]
    for seed, (shape, wv, lvl) in enumerate(flat_cases):
        # The tight frame's taps: the iterates (preserve_l2) keep their scale.
        taps = tw.NDDWT(wv, shape, preserve_l2=True, device=dev).taps_hp
        for dt in (torch.float32, torch.bfloat16, torch.float64):
            for batch in (0, 2):
                gen.manual_seed(50 + seed)
                lead = (2,) if batch else ()
                tag = f"{lead + shape} {wv} L{lvl} {str(dt).removeprefix('torch.')}"
                errs = dict.fromkeys(FLAT_KERNELS, 0.0)
                x = randn(lead + shape, dt)
                runs = []  # (kernel, what, kernel's result, plain result)
                for lam in (0.0, THRESHOLD):
                    k = flat._call("pair", x, taps, lvl, lam > 0, lam, shape, batch)
                    r = flat_ref.flat_pair_ref("pair", x, taps, lvl, lam > 0, lam, batch)
                    runs += [("nddwt_flat_pair", f"pair lam={lam} bands", k[0], r[0]),
                             ("nddwt_flat_pair", f"pair lam={lam} reconstruction",
                              k[1], r[1])]
                runs.append(("nddwt_flat_pair", "dec",
                             flat._call("dec", x, taps, lvl, False, 0.0, shape, batch),
                             flat_ref.flat_pair_ref("dec", x, taps, lvl, batch=batch)))
                runs.append(("nddwt_flat_pair", "rec",
                             flat._call("rec", r[0], taps, lvl, False, 0.0, shape, batch),
                             flat_ref.flat_pair_ref("rec", r[0], taps, lvl, batch=batch)))
                mask = (torch.rand(shape, generator=gen, device=dev) < SAMPLING).to(dt)
                b = (mask * x).to(dt)
                runs.append(("nddwt_flat_iter", "chain",
                             flat._call_iter("chain", x, None, taps, lvl, True, lams3,
                                             None, 0.0, shape, batch),
                             flat_ref.flat_iter_ref("chain", x, None, taps, lvl, True,
                                                    lams3, None, 0.0, batch)))
                runs.append(("nddwt_flat_iter", "fista",
                             flat._call_iter("fista", b, mask, taps, lvl, True, lams3,
                                             moms3, 1.0, shape, batch),
                             flat_ref.flat_iter_ref("fista", b, mask, taps, lvl, True,
                                                    lams3, moms3, 1.0, batch)))
                torch.cuda.synchronize()
                for name, what, k, r in runs:
                    errs[name] = max(errs[name], check(f"{name} {what} {tag}", max_err(k, r),
                                                       rel_tol(r, dt), show=False))
                print(f"  flat kernels {tag}: {len(runs)} checks, max_abs_err "
                      + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
                if (shape, dt, batch) == (SOLVE_SHAPE, torch.float32, 0):  # the main path's
                    main_err.update(errs)
                del x, mask, b, runs, k, r
    torch.cuda.empty_cache()

    # The multilevel kernels: the JAX multilevel tests' cases, odd extents,
    # batches of 1-3, and the deeper cases (L4, L5, batches of 1 and 16,
    # runtime taps), lam 0 and 0.1, both normalizations, every dtype; and
    # the multi-coil path's batch (2 N real components of 256^2), its main
    # path, in float32.
    for seed, (shape, wv, lvl, batches) in enumerate(
            [case + ((1, 2, 3),) for case in MULTI_CASES] + MULTI_DEEP_CASES
            + [(COIL_SHAPE, "db4", LEVEL, (2 * COILS,))]):
        taps = tw.NDDWT(wv, shape, device=dev).taps_hp
        main = shape == COIL_SHAPE
        for dt in ((torch.float32,) if main else (torch.float32, torch.bfloat16,
                                                  torch.float64)):
            for batch in batches:
                gen.manual_seed(60 + seed)
                tag = f"{(batch,) + shape} {wv} L{lvl} {str(dt).removeprefix('torch.')}"
                errs = dict.fromkeys(MULTI_KERNELS, 0.0)
                x = randn((batch,) + shape, dt)
                for lam in (0.0, THRESHOLD):
                    k = multi.dec_multi(x, taps, lvl, lam)
                    r = multi_ref.dec_multi_ref(x, taps, lvl, lam)
                    torch.cuda.synchronize()
                    errs["nddwt_dec_multi"] = max(errs["nddwt_dec_multi"], check(
                        f"nddwt_dec_multi {tag} lam={lam}", max_err(k, r), rel_tol(r, dt),
                        show=False))
                for pl2 in (False, True):
                    k = multi.rec_multi(r, taps, lvl, pl2)
                    rr = multi_ref.rec_multi_ref(r, taps, lvl,
                                                 1.0 if pl2 else 0.5 ** len(shape))
                    torch.cuda.synchronize()
                    errs["nddwt_rec_multi"] = max(errs["nddwt_rec_multi"], check(
                        f"nddwt_rec_multi {tag} preserve_l2={pl2}", max_err(k, rr),
                        rel_tol(rr, dt), show=False))
                print(f"  multilevel kernels {tag}: 4 checks, max_abs_err "
                      + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
                if main:
                    main_err.update(errs)
                del x, k, r, rr
    torch.cuda.empty_cache()

    # The halo-padded mode of the level and lead-stage kernels.
    padded_err = chip_sharded.check_padded(check, card)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 3
    print(f"phase 3: the main path, NDDWT.dec_rec at {SHAPE} db4 L{LEVEL} f32")
    to_flat = []  # older launch checks whose shapes also take the flat kernel
    to_multi = []  # and those whose shapes take the multilevel kernels

    def routes(what, plan, dtype, batch, level, per_level, on_flat, run):
        """``run()`` (a dec and a rec, or a dec_rec, of ``level`` levels) on
        the per-level route (the flat and multilevel kernels switched off),
        held to the launches ``per_level``; where ``plan``'s items take the
        multilevel kernels, on them (the flat kernel switched off), held to
        one launch each way, both components of a pair in one; and, where
        ``plan``'s shape (with a pair when ``batch`` is 2) is within the flat
        kernel's size, on the plan's own route, held to ``on_flat`` (else
        the plan's own route is one of the first two). Returns (route,
        result) for each run; the counts are set to 0 just before each."""
        ways = [("per-level route", lambda: xover.limits(0, 0, 0), per_level)]
        with xover.limits(0, 0, multi.MULTI_MAX_NUMEL):
            on_multi = plan.route(dtype, level) == "multi"
        if on_multi:
            to_multi.append(what)
            ways.append(("multilevel route",
                         lambda: xover.limits(0, 0, multi.MULTI_MAX_NUMEL), ONE_MULTI))
        if plan.route(dtype, level, pair=batch == 2) == "flat":
            to_flat.append(what)
            ways.append(("flat route", contextlib.nullcontext, on_flat))
        out = []
        for route, switch, want in ways:
            with switch():
                ck.reset_launch_counts()
                result = run()
                torch.cuda.synchronize()
                check_launches(f"{what}, {route}", dict(ck.launch_counts), want)
            out.append((route, result))
        return out

    gen.manual_seed(100)
    x = torch.randn(SHAPE, generator=gen, device=dev)
    per_level = dict.fromkeys(("nddwt_dec_level", "nddwt_rec_level"), LEVEL)
    for pl2 in (False, True):
        plan = tw.NDDWT("db4", SHAPE, preserve_l2=pl2, device=dev)
        ck.reset_launch_counts()
        y, xr = plan.dec_rec(x, LEVEL, threshold=THRESHOLD, band_axis=0)
        got = check_launches(f"main path, preserve_l2={pl2}",
                             dict(ck.launch_counts), per_level)
        if not pl2:
            launches = dict(got)  # the flagship's normalization: the main path's own
        _, xr0 = plan.dec_rec(x, LEVEL, band_axis=0)
        torch.cuda.synchronize()
        B = plan.num_bands(LEVEL)
        if y.shape != (B,) + SHAPE or xr.shape != SHAPE:
            failures.append(f"shapes {tuple(y.shape)} {tuple(xr.shape)}")
        if not (torch.isfinite(y).all() and torch.isfinite(xr).all()):
            failures.append(f"non-finite output, preserve_l2={pl2}")
        yp = direct_path.dec_direct(x, plan.taps, LEVEL)
        yp = torch.cat([yp[:1], soft_threshold(yp[1:], THRESHOLD)])
        xp = direct_path.rec_direct(yp, plan.taps, LEVEL, pl2)
        check(f"bands vs plain path, preserve_l2={pl2}", max_err(y, yp),
              F32_TOL * yp.abs().max().item())
        check(f"reconstruction vs plain path, preserve_l2={pl2}", max_err(xr, xp),
              F32_TOL * xp.abs().max().item())
        check(f"threshold-0 round trip, preserve_l2={pl2}", max_err(xr0, x), 1e-4)
        del y, xr, xr0, yp, xp
    def step_of(plan, x):
        """__graft_entry__.entry's step: dec, soft-threshold the details at
        0.1, rec; on the host."""
        y = plan.dec(x, LEVEL, band_axis=0)
        y = torch.cat([y[:1], soft_threshold(y[1:], THRESHOLD)])
        return plan.rec(y, band_axis=0).cpu().numpy()

    def oracle_step(x):
        yo = oracle.dec(x.astype(np.float64), "db4", LEVEL)
        d = yo[..., 1:]
        yo[..., 1:] = d * np.maximum(np.abs(d) - THRESHOLD, 0) / np.maximum(np.abs(d), 1e-30)
        return oracle.rec(yo, "db4")

    # __graft_entry__.entry's step: 64^3 db4 L3 float32.
    x64 = np.random.default_rng(0).standard_normal((64, 64, 64)).astype(np.float32)
    plan64 = tw.NDDWT("db4", (64, 64, 64), device=dev)
    gold = oracle_step(x64)
    for route, step in routes("64^3 flagship step", plan64, torch.float32, 0, LEVEL,
                              per_level, {"nddwt_flat_pair": 2},
                              lambda: step_of(plan64, x64)):
        check(f"64^3 flagship step vs float64 oracle, {route}",
              float(np.abs(step - gold).max()), 1e-4)

    print(f"phase 3: the solver paths at {SHAPE} db4 L{LEVEL} f32, preserve_l2, "
          f"{ITERS} iterations, lam {LAM}, {SAMPLING:.0%} sampling")
    splan = tw.NDDWT("db4", SHAPE, preserve_l2=True, device=dev)
    dplan = tw.NDDWT("db4", SHAPE, preserve_l2=True, path="direct", device=dev)
    gen.manual_seed(200)
    xi = torch.randn(SHAPE, generator=gen, device=dev)
    mask = (torch.rand(SHAPE, generator=gen, device=dev) < SAMPLING).float()
    L = LEVEL * ITERS
    solvers = {  # name: (run on a plan, launches per run on the kernels)
        "fista_inpaint": (
            lambda p: fista_inpaint(p, mask * x, mask, LAM, LEVEL, ITERS),
            {"nddwt_dec_level": L, "nddwt_rec_level": L,
             "nddwt_mag_shrink_pair": 0, "nddwt_fista_step": ITERS}),
        "fista_inpaint_split": (
            lambda p: fista_inpaint_split(p, mask * torch.stack([x, xi]), mask,
                                          LAM, LEVEL, ITERS),
            {"nddwt_dec_level": 2 * L, "nddwt_rec_level": 2 * L,
             "nddwt_mag_shrink_pair": ITERS, "nddwt_fista_step": ITERS}),
        "fista_cs_mri": (
            lambda p: fista_cs_mri(p, mask * torch.fft.fftn(x, norm="ortho"), mask,
                                   LAM, LEVEL, ITERS),
            {"nddwt_dec_level": 2 * L, "nddwt_rec_level": 2 * L,
             "nddwt_mag_shrink_pair": ITERS, "nddwt_fista_step": 0}),
    }
    for name, (run, want) in solvers.items():
        ck.reset_launch_counts()
        out = run(splan)
        got = check_launches(name, dict(ck.launch_counts), want)
        for kernel in ("nddwt_mag_shrink_pair", "nddwt_fista_step"):
            if got[kernel]:
                launches[kernel] = got[kernel]
        ck.reset_launch_counts()
        ref = run(dplan)
        torch.cuda.synchronize()
        if any(ck.launch_counts.values()):
            failures.append(f"{name}: the plain route launched {ck.launch_counts}")
        want_shape = (2,) + SHAPE if name.endswith("split") else SHAPE
        if tuple(out.shape) != want_shape or not torch.isfinite(out).all():
            failures.append(f"{name}: shape {tuple(out.shape)} or non-finite values")
        if out.is_complex():
            out, ref = torch.view_as_real(out), torch.view_as_real(ref)
        check(f"{name} vs the plain route", max_err(out, ref),
              SOLVER_TOL * ref.abs().max().item())
        del out, ref
    torch.cuda.empty_cache()

    print(f"phase 3: the 4D path, NDDWT.dec_rec at {SHAPE4} f32, db4 L{LEVEL} "
          "and haar L1")
    gen.manual_seed(400)
    x4 = torch.randn(SHAPE4, generator=gen, device=dev)
    for wv, lvl, pl2 in (("db4", LEVEL, False), ("db4", LEVEL, True), ("haar", 1, False)):
        plan4 = tw.NDDWT(wv, SHAPE4, preserve_l2=pl2, device=dev)
        tag = f"4D {wv} L{lvl}, preserve_l2={pl2}"
        ck.reset_launch_counts()
        y, xr = plan4.dec_rec(x4, lvl, threshold=THRESHOLD, band_axis=0)
        got = check_launches(tag, dict(ck.launch_counts),
                             dict.fromkeys(STAGE_KERNELS, lvl))
        if (wv, pl2) == ("db4", False):  # the 4D path's own launches
            launches.update({name: got[name] for name in STAGE_KERNELS})
        torch.cuda.synchronize()
        B = plan4.num_bands(lvl)
        if y.shape != (B,) + SHAPE4 or xr.shape != SHAPE4:
            failures.append(f"{tag}: shapes {tuple(y.shape)} {tuple(xr.shape)}")
        if not (torch.isfinite(y).all() and torch.isfinite(xr).all()):
            failures.append(f"{tag}: non-finite output")
        yp = direct_path.dec_direct(x4, plan4.taps, lvl)
        yp = torch.cat([yp[:1], soft_threshold(yp[1:], THRESHOLD)])
        check(f"bands vs plain path, {tag}", max_err(y, yp),
              F32_TOL * yp.abs().max().item())
        del y
        xp = direct_path.rec_direct(yp, plan4.taps, lvl, pl2)
        del yp
        check(f"reconstruction vs plain path, {tag}", max_err(xr, xp),
              F32_TOL * xp.abs().max().item())
        _, xr0 = plan4.dec_rec(x4, lvl, band_axis=0)
        check(f"threshold-0 round trip, {tag}", max_err(xr0, x4), 1e-4)
        del xr, xp, xr0, _
        torch.cuda.empty_cache()

    # A 3D plan whose filters are too long for the per-level kernels' tile
    # runs on the stage kernels (one lane axis, 8 bands).
    plan20 = tw.NDDWT("db20", (128, 128, 128), device=dev)
    x20 = torch.randn(plan20.shape, generator=gen, device=dev)
    yp = direct_path.dec_direct(x20, plan20.taps, 2)
    yp = torch.cat([yp[:1], soft_threshold(yp[1:], THRESHOLD)])
    xp = direct_path.rec_direct(yp, plan20.taps, 2, False)
    for route, (y, xr) in routes(
            "3D db20 L2 step, the long-filter route", plan20, torch.float32, 0, 2,
            dict.fromkeys(STAGE_KERNELS, 2), {"nddwt_flat_pair": 1},
            lambda: plan20.dec_rec(x20, 2, threshold=THRESHOLD, band_axis=0)):
        check(f"3D db20 bands vs plain path, {route}", max_err(y, yp),
              F32_TOL * yp.abs().max().item())
        check(f"3D db20 reconstruction vs plain path, {route}", max_err(xr, xp),
              F32_TOL * xp.abs().max().item())
    del y, xr, yp, xp

    print(f"phase 3: 4D fista_cs_mri at {CS_SHAPE4} db4 L{LEVEL} f32, preserve_l2, "
          f"{ITERS} iterations, lam {LAM}, {SAMPLING:.0%} sampling")
    del x4
    torch.cuda.empty_cache()
    splan4 = tw.NDDWT("db4", CS_SHAPE4, preserve_l2=True, device=dev)
    dplan4 = tw.NDDWT("db4", CS_SHAPE4, preserve_l2=True, path="direct", device=dev)
    gen.manual_seed(500)
    mask4 = (torch.rand(CS_SHAPE4, generator=gen, device=dev) < SAMPLING).float()
    kt = mask4 * torch.fft.fftn(torch.randn(CS_SHAPE4, generator=gen, device=dev),
                                norm="ortho")  # undersampled k-t data

    def cs_mri4(p, iters=ITERS):
        return fista_cs_mri(p, kt, mask4, LAM, LEVEL, iters)

    ck.reset_launch_counts()
    out = cs_mri4(splan4)
    check_launches("4D fista_cs_mri", dict(ck.launch_counts),
                   {**dict.fromkeys(STAGE_KERNELS, 2 * L), "nddwt_mag_shrink_pair": ITERS})
    torch.cuda.empty_cache()
    ck.reset_launch_counts()
    ref = cs_mri4(dplan4)
    torch.cuda.synchronize()
    if any(ck.launch_counts.values()):
        failures.append(f"4D fista_cs_mri: the plain route launched {ck.launch_counts}")
    if tuple(out.shape) != CS_SHAPE4 or not torch.isfinite(torch.view_as_real(out)).all():
        failures.append(f"4D fista_cs_mri: shape {tuple(out.shape)} or non-finite values")
    out, ref = torch.view_as_real(out), torch.view_as_real(ref)
    check("4D fista_cs_mri vs the plain route", max_err(out, ref),
          SOLVER_TOL * ref.abs().max().item())
    del out, ref
    torch.cuda.empty_cache()

    print("phase 3: the class paths, each class at its reference configuration, "
          "complex double, pres_l2_norm, compute 'gpu' and 'gpu_off'")
    by_ndim = {1: ("nddwt_dec1_level", "nddwt_rec1_level"),
               2: ("nddwt_dec_level", "nddwt_rec_level"),
               3: ("nddwt_dec_level", "nddwt_rec_level"), 4: STAGE_KERNELS}
    np_rng = np.random.default_rng(700)
    for name, sizes, wv, lvl in CLASS_CONFIGS:
        nd = len(sizes)
        xc = np_rng.standard_normal(sizes) + 1j * np_rng.standard_normal(sizes)
        gold = oracle.dec(xc, wv, lvl, preserve_l2=True)
        route_plan = tw.NDDWT(wv, sizes, device=dev)  # the class's shape and taps
        for compute in ("gpu", "gpu_off"):
            tag = f"{name}{sizes} {wv} L{lvl} compute={compute}"
            args = (sizes,) if name.startswith("harr") else (wv, sizes)
            t = getattr(tw, name)(*args, pres_l2_norm=True, compute=compute, device=dev)
            xin = torch.from_numpy(xc).to(dev) if compute == "gpu" else xc

            def dec_rec():
                y = t.dec(xin, lvl)
                return y, t.rec(y)

            for route, (y, xr) in routes(  # two components
                    tag, route_plan, torch.float64, 2, lvl,
                    dict.fromkeys(by_ndim[nd], 2 * lvl),
                    {"nddwt_flat_pair": 2}, dec_rec):
                what = f"{tag}, {route}"
                if compute == "gpu":
                    if not (isinstance(y, torch.Tensor) and y.dtype == torch.complex128):
                        failures.append(f"{what}: bands are not complex128 on the card")
                    y, xr = y.cpu().numpy(), xr.cpu().numpy()
                elif not (isinstance(y, np.ndarray) and isinstance(xr, np.ndarray)):
                    failures.append(f"{what}: 'gpu_off' did not return NumPy arrays")
                if y.shape != gold.shape or y.dtype != np.complex128:
                    failures.append(f"{what}: bands {y.shape} {y.dtype}")
                check(f"{what} bands vs float64 oracle", float(np.abs(y - gold).max()),
                      F64_TOL * float(np.abs(gold).max()))
                check(f"{what} round trip", float(np.abs(xr - xc).max()), 1e-11)
                check(f"{what} energy ratio - 1",
                      abs(float(np.linalg.norm(y) / np.linalg.norm(xc)) - 1), 1e-12)
            del t, y, xr, xin
        torch.cuda.empty_cache()

    print(f"phase 3: NDDWT at {SHAPE} db4 L{LEVEL} float64, dec+rec and "
          f"dec_rec({THRESHOLD})")
    plan64 = tw.NDDWT("db4", SHAPE, dtype="double", device=dev)
    gen.manual_seed(800)
    xd = randn(SHAPE, torch.float64)
    ck.reset_launch_counts()
    y = plan64.dec(xd, LEVEL, band_axis=0)
    xr = plan64.rec(y, band_axis=0)
    launches64 = check_launches("256^3 f64 dec+rec", dict(ck.launch_counts),
                                dict.fromkeys(F64_REPLACES, LEVEL))
    torch.cuda.synchronize()
    if y.dtype != torch.float64 or not torch.isfinite(y).all():
        failures.append(f"256^3 f64 bands: {y.dtype} or non-finite")
    check("256^3 f64 round trip", max_err(xr, xd), 1e-12)
    yp = direct_path.dec_direct(xd, plan64.taps, LEVEL)
    check("256^3 f64 bands vs plain path", max_err(y, yp), F64_TOL * yp.abs().max().item())
    del y, xr
    ck.reset_launch_counts()
    y, xr = plan64.dec_rec(xd, LEVEL, threshold=THRESHOLD, band_axis=0)
    check_launches("256^3 f64 dec_rec", dict(ck.launch_counts),
                   dict.fromkeys(F64_REPLACES, LEVEL))
    yp = torch.cat([yp[:1], soft_threshold(yp[1:], THRESHOLD)])
    check("256^3 f64 dec_rec bands vs plain path", max_err(y, yp),
          F64_TOL * yp.abs().max().item())
    xp = direct_path.rec_direct(yp, plan64.taps, LEVEL, False)
    check("256^3 f64 dec_rec reconstruction vs plain path", max_err(xr, xp),
          F64_TOL * xp.abs().max().item())
    del y, xr, yp, xp
    torch.cuda.empty_cache()
    x64 = np.random.default_rng(0).standard_normal((64, 64, 64))
    plan64s = tw.NDDWT("db4", (64, 64, 64), dtype="double", device=dev)
    gold = oracle_step(x64)
    for route, step in routes("64^3 f64 step", plan64s, torch.float64, 0, LEVEL,
                              dict.fromkeys(F64_REPLACES, LEVEL), {"nddwt_flat_pair": 2},
                              lambda: step_of(plan64s, x64)):
        check(f"64^3 f64 step vs float64 oracle, {route}",
              float(np.abs(step - gold).max()), 1e-12)

    print(f"phase 3: 1D float32, {N1M} samples db4 L3 and {N1} samples db6 L4 dec_rec")
    x1 = np.random.default_rng(900).standard_normal(N1M).astype(np.float32)
    plan1 = tw.NDDWT("db4", (N1M,), device=dev)
    gold = oracle.dec(x1.astype(np.float64), "db4", LEVEL)

    def dec_rec1():
        y = plan1.dec(x1, LEVEL)
        return y, plan1.rec(y)

    for route, (y1, xr1) in routes(f"1D {N1M} db4 L{LEVEL} dec+rec", plan1, torch.float32,
                                   0, LEVEL, dict.fromkeys(LEVEL1, LEVEL),
                                   {"nddwt_flat_pair": 2},
                                   dec_rec1):
        check(f"1D {N1M} bands vs float64 oracle, {route}",
              float(np.abs(y1.cpu().numpy() - gold).max()), 1e-4)
        check(f"1D {N1M} round trip, {route}", float(np.abs(xr1.cpu().numpy() - x1).max()),
              1e-4)
    plan1l = tw.NDDWT("db6", (N1,), device=dev)
    gen.manual_seed(901)
    xl = randn((N1,))
    ck.reset_launch_counts()
    y, xr = plan1l.dec_rec(xl, 4, threshold=THRESHOLD, band_axis=0)
    if plan1l.route(torch.float32, 4) == "flat":
        failures.append(f"1D {N1}: within the flat kernel's size, no path runs the 1D kernels")
    got = check_launches(f"1D {N1} db6 L4 dec_rec", dict(ck.launch_counts),
                         dict.fromkeys(LEVEL1, 4))
    launches.update({k: got[k] for k in LEVEL1})  # the 1D float32 path's own
    yp = direct_path.dec_direct(xl, plan1l.taps, 4)
    yp = torch.cat([yp[:1], soft_threshold(yp[1:], THRESHOLD)])
    xp = direct_path.rec_direct(yp, plan1l.taps, 4, False)
    check(f"1D {N1} bands vs plain path", max_err(y, yp), F32_TOL * yp.abs().max().item())
    check(f"1D {N1} reconstruction vs plain path", max_err(xr, xp),
          F32_TOL * xp.abs().max().item())
    del y, xr, yp, xp, y1, xr1
    # float64 at 2^23: the 1D kernels' float64 path (the 1D class at its
    # reference length now takes the flat kernel).
    plan1l64 = tw.NDDWT("db6", (N1,), dtype="double", device=dev)
    xl64 = randn((N1,), torch.float64)
    ck.reset_launch_counts()
    y, xr = plan1l64.dec_rec(xl64, 4, threshold=THRESHOLD, band_axis=0)
    launches1_64 = check_launches(f"1D {N1} db6 L4 f64 dec_rec", dict(ck.launch_counts),
                                  dict.fromkeys(LEVEL1, 4))
    yp = direct_path.dec_direct(xl64, plan1l64.taps, 4)
    yp = torch.cat([yp[:1], soft_threshold(yp[1:], THRESHOLD)])
    check(f"1D {N1} f64 bands vs plain path", max_err(y, yp), F64_TOL * yp.abs().max().item())
    xp = direct_path.rec_direct(yp, plan1l64.taps, 4, False)
    check(f"1D {N1} f64 reconstruction vs plain path", max_err(xr, xp),
          F64_TOL * xp.abs().max().item())
    del y, xr, yp, xp, xl64
    torch.cuda.empty_cache()
    print(f"  launch checks also run on the flat route: {', '.join(to_flat) or 'none'}")
    print(f"  and on the multilevel route: {', '.join(to_multi) or 'none'}")

    print(f"phase 3: the one-launch solves, fista_inpaint and fista_inpaint_split at "
          f"{SOLVE_SHAPE} db4 L{LEVEL} f32, preserve_l2, {SOLVE_ITERS} iterations, "
          f"lam {LAM}, {SAMPLING:.0%} sampling")
    gen.manual_seed(1200)
    xs = torch.randn((2,) + SOLVE_SHAPE, generator=gen, device=dev)
    smask = (torch.rand(SOLVE_SHAPE, generator=gen, device=dev) < SAMPLING).float()
    one_launch = {
        "fista_inpaint": lambda p: fista_inpaint(p, smask * xs[0], smask, LAM, LEVEL,
                                                 SOLVE_ITERS),
        "fista_inpaint_split": lambda p: fista_inpaint_split(p, smask * xs, smask, LAM,
                                                             LEVEL, SOLVE_ITERS),
    }

    def solver_plans(dtype):
        return (tw.NDDWT("db4", SOLVE_SHAPE, preserve_l2=True, dtype=dtype, device=dev),
                tw.NDDWT("db4", SOLVE_SHAPE, preserve_l2=True, dtype=dtype, path="direct",
                         device=dev))

    fplan, fdirect = solver_plans("float32")
    # The flat pair's main path: one dec_rec step at the solves' shape.
    ck.reset_launch_counts()
    y, xr = fplan.dec_rec(xs[0], LEVEL, threshold=THRESHOLD, band_axis=0)
    got = check_launches(f"dec_rec at {SOLVE_SHAPE}, one launch", dict(ck.launch_counts),
                         {"nddwt_flat_pair": 1})
    launches["nddwt_flat_pair"] = got["nddwt_flat_pair"]
    yr, xrr = fdirect.dec_rec(xs[0], LEVEL, threshold=THRESHOLD, band_axis=0)
    check(f"dec_rec at {SOLVE_SHAPE} bands vs the plain route", max_err(y, yr),
          F32_TOL * yr.abs().max().item())
    check(f"dec_rec at {SOLVE_SHAPE} reconstruction vs the plain route", max_err(xr, xrr),
          F32_TOL * xrr.abs().max().item())
    for name, run in one_launch.items():
        ck.reset_launch_counts()
        out = run(fplan)
        got = check_launches(f"{name}, one whole solve", dict(ck.launch_counts),
                             {"nddwt_flat_iter": 1})
        launches["nddwt_flat_iter"] = got["nddwt_flat_iter"]
        ref = run(fdirect)
        torch.cuda.synchronize()
        want_shape = (2,) + SOLVE_SHAPE if name.endswith("split") else SOLVE_SHAPE
        if tuple(out.shape) != want_shape or not torch.isfinite(out).all():
            failures.append(f"{name}: shape {tuple(out.shape)} or non-finite values")
        drift, gate = max_err(out, ref), SOLVER_TOL * ref.abs().max().item()
        if drift <= gate:
            check(f"{name} vs the plain route", drift, gate)
            continue
        print(f"  {name}: float32 drift {drift:.3e} past the solver gate {gate:.3e} "
              f"after {SOLVE_ITERS} iterations; holding the float64 solve instead")
        p64, d64 = solver_plans("float64")
        ck.reset_launch_counts()
        out = run(p64)
        check_launches(f"{name} f64, one whole solve", dict(ck.launch_counts),
                       {"nddwt_flat_iter": 1})
        ref = run(d64)
        check(f"{name} f64 vs the plain route f64", max_err(out, ref),
              1e-10 * ref.abs().max().item())
    del out, ref

    lams_n = [0.2 * 0.1 ** (i / (CHAIN_SWEEPS - 1)) for i in range(CHAIN_SWEEPS)]
    print(f"phase 3: dec_rec_n at {CHAIN_SHAPE} {CHAIN_WV} L{LEVEL} f32, {CHAIN_SWEEPS} "
          f"sweeps, thresholds {lams_n[0]:.2f} -> {lams_n[-1]:.2f} geometric")
    cplan = tw.NDDWT(CHAIN_WV, CHAIN_SHAPE, device=dev)
    cdirect = tw.NDDWT(CHAIN_WV, CHAIN_SHAPE, path="direct", device=dev)
    xc = torch.randn(CHAIN_SHAPE, generator=gen, device=dev)
    ck.reset_launch_counts()
    out = cplan.dec_rec_n(xc, LEVEL, lams_n)
    check_launches(f"dec_rec_n, {CHAIN_SWEEPS} sweeps", dict(ck.launch_counts),
                   {"nddwt_flat_iter": 1})
    ref = xc
    for lam in lams_n:
        _, ref = cdirect.dec_rec(ref, LEVEL, threshold=lam, band_axis=0)
    if tuple(out.shape) != CHAIN_SHAPE or not torch.isfinite(out).all():
        failures.append(f"dec_rec_n: shape {tuple(out.shape)} or non-finite values")
    check("dec_rec_n vs a loop of dec_rec on the plain route", max_err(out, ref),
          SOLVER_TOL * ref.abs().max().item())

    split_shape = SPLIT_SHAPE
    while tw.NDDWT("db4", split_shape, device=dev).route(torch.float32, LEVEL,
                                                         pair=True) != "flat":
        split_shape = tuple(n // 2 for n in split_shape)
    if split_shape != SPLIT_SHAPE:
        print(f"  the flat kernel's limit is below 2 * {SPLIT_SHAPE}: the split "
              f"iterate runs at {split_shape}, the largest square within it")
    print(f"phase 3: dec_rec_split at {split_shape} db4 L{LEVEL} f32, threshold {THRESHOLD}")
    pplan = tw.NDDWT("db4", split_shape, preserve_l2=True, device=dev)
    pdirect = tw.NDDWT("db4", split_shape, preserve_l2=True, path="direct", device=dev)
    xp2 = torch.randn((2,) + split_shape, generator=gen, device=dev)
    ck.reset_launch_counts()
    y, xr = pplan.dec_rec_split(xp2, LEVEL, THRESHOLD)
    check_launches("dec_rec_split, one launch", dict(ck.launch_counts),
                   {"nddwt_flat_pair": 1})
    yr, xrr = pdirect.dec_rec_split(xp2, LEVEL, THRESHOLD)
    check("dec_rec_split bands vs the plain route", max_err(y, yr),
          F32_TOL * yr.abs().max().item())
    check("dec_rec_split reconstruction vs the plain route", max_err(xr, xrr),
          F32_TOL * xrr.abs().max().item())

    for shape5, wv5, lvl5 in FIVE_D:
        for dt in (torch.float32, torch.float64):
            tag = f"5D {shape5} {wv5} L{lvl5} {str(dt).removeprefix('torch.')}"
            p5 = tw.NDDWT(wv5, shape5, dtype=dt, device=dev)
            d5 = tw.NDDWT(wv5, shape5, dtype=dt, path="direct", device=dev)
            x5 = randn(shape5, dt)
            ck.reset_launch_counts()
            y5 = p5.dec(x5, lvl5, band_axis=0)
            xr5 = p5.rec(y5, band_axis=0)
            yb5, xb5 = p5.dec_rec(x5, lvl5, threshold=THRESHOLD, band_axis=0)
            check_launches(f"{tag} dec, rec, dec_rec", dict(ck.launch_counts),
                           {"nddwt_flat_pair": 3})
            yd5 = d5.dec(x5, lvl5, band_axis=0)
            ybd, xbd = d5.dec_rec(x5, lvl5, threshold=THRESHOLD, band_axis=0)
            tol = F64_TOL if dt == torch.float64 else F32_TOL
            check(f"{tag} bands vs plain path", max_err(y5, yd5), tol * yd5.abs().max().item())
            check(f"{tag} round trip", max_err(xr5, x5),
                  1e-12 if dt == torch.float64 else 1e-4)
            check(f"{tag} dec_rec vs plain path", max(max_err(yb5, ybd), max_err(xb5, xbd)),
                  tol * ybd.abs().max().item())
    del y, xr, yr, xrr, xp2
    torch.cuda.empty_cache()

    print(f"phase 3: the multilevel paths, db4 L{LEVEL}: a real {MULTI_VOLUME} f32 "
          f"dec_rec beyond the flat route, a multi-coil slice ({COILS} x {COIL_SHAPE}) "
          f"through dec_batched/rec_batched, a complex {CPLX_VOLUME} dec_rec({THRESHOLD})")

    def on_card(what, want, run, ref, tol):
        """``run()`` with the counts set to 0 just before it, held to the
        launches ``want``; each of its results against ``ref()``'s, within
        ``tol`` times the largest magnitude of each, and finite."""
        ck.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        counts = check_launches(what, dict(ck.launch_counts), want)
        for i, (g, r) in enumerate(zip(got, ref())):
            if g.shape != r.shape or not torch.isfinite(torch.view_as_real(g) if g.is_complex()
                                                         else g).all():
                failures.append(f"{what}: result {i} {tuple(g.shape)} or non-finite values")
            check(f"{what}, result {i} vs the plain route", max_err(g, r),
                  tol * r.abs().max().item())
        return counts

    def batched_pair(p, xb):
        y = p.dec_batched(xb, LEVEL)
        return y, p.rec_batched(y)

    gen.manual_seed(1300)
    mplan = tw.NDDWT("db4", MULTI_VOLUME, device=dev)
    mdirect = tw.NDDWT("db4", MULTI_VOLUME, path="direct", device=dev)
    xm = torch.randn(MULTI_VOLUME, generator=gen, device=dev)
    with xover.limits(0, 0, multi.MULTI_MAX_NUMEL):  # the flat route switched off
        on_card(f"dec_rec {MULTI_VOLUME} f32, flat route off", ONE_MULTI,
                lambda: mplan.dec_rec(xm, LEVEL, threshold=THRESHOLD, band_axis=0),
                lambda: mdirect.dec_rec(xm, LEVEL, threshold=THRESHOLD, band_axis=0),
                F32_TOL)
    del xm
    for dt in (torch.complex64, torch.float32, torch.float64):
        real = {torch.complex64: torch.float32}.get(dt, dt)
        coil_plan = tw.NDDWT("db4", COIL_SHAPE, dtype=real, device=dev)
        coil_direct = tw.NDDWT("db4", COIL_SHAPE, dtype=real, path="direct", device=dev)
        xb = torch.randn((COILS,) + COIL_SHAPE, generator=gen, device=dev, dtype=dt)
        tag = f"{COILS} x {COIL_SHAPE} {str(dt).removeprefix('torch.')}"
        got = on_card(f"dec_batched + rec_batched, {tag}", ONE_MULTI,
                      lambda: batched_pair(coil_plan, xb), lambda: batched_pair(coil_direct, xb),
                      F64_TOL if real == torch.float64 else F32_TOL)
        if dt == torch.complex64:  # the multilevel kernels' main path
            launches.update({k: got[k] for k in MULTI_KERNELS})
        check(f"dec_batched + rec_batched, {tag}, round trip",
              max_err(batched_pair(coil_plan, xb)[1], xb),
              1e-12 if real == torch.float64 else 1e-4)
    del xb
    vplan = tw.NDDWT("db4", CPLX_VOLUME, device=dev)
    vdirect = tw.NDDWT("db4", CPLX_VOLUME, path="direct", device=dev)
    xv = torch.randn(CPLX_VOLUME, generator=gen, device=dev, dtype=torch.complex64)
    if vplan.route(torch.complex64, LEVEL) == "flat":
        failures.append(f"complex {CPLX_VOLUME}: within the flat kernel's size")
    on_card(f"complex dec_rec({THRESHOLD}) {CPLX_VOLUME}",
            {**ONE_MULTI, "nddwt_mag_shrink_pair": 1},
            lambda: vplan.dec_rec(xv, LEVEL, threshold=THRESHOLD, band_axis=0),
            lambda: vdirect.dec_rec(xv, LEVEL, threshold=THRESHOLD, band_axis=0), F32_TOL)
    del xv
    torch.cuda.empty_cache()

    print(f"phase 3: the sharded paths, ShardedNDDWT on {chip_sharded.RANKS} spawned ranks "
          f"sharing the card (gloo), held against the single-card plan on each block; "
          f"this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    sharded = chip_sharded.run_sharded(check, check_launches, failures, card)

    # ---------------------------------------------------------- phase 4
    print(f"phase 4: timings (CUDA events) {card}")
    plan = tw.NDDWT("db4", SHAPE, device=dev)
    nb, B = 8, plan.num_bands(LEVEL)
    gen.manual_seed(300)
    big = torch.randn((B,) + SHAPE, generator=gen, device=dev)
    src = [("y", b) for b in range(nb)]
    ypair = torch.randn(PAIR, generator=gen, device=dev)
    xn, xp, b = (torch.randn(SHAPE, generator=gen, device=dev) for _ in range(3))
    pn, pp, pb = (torch.randn((2,) + SHAPE, generator=gen, device=dev)
                  for _ in range(3))
    ms = {
        "nddwt_dec_level": (
            timed(lambda: ck.dec_level(x, big, B - 7, plan.taps_hp), 20),
            timed(lambda: level_ref.dec_level_ref(x, big, B - 7, plan.taps_hp), 5),
        ),
        "nddwt_rec_level": (
            timed(lambda: ck.rec_level(big, None, src, plan.taps_hp, 1 / nb), 20),
            timed(lambda: level_ref.rec_level_ref(big, None, src, plan.taps_hp,
                                                  1 / nb), 5),
        ),
        "nddwt_mag_shrink_pair": (
            timed(lambda: elemwise.mag_shrink_pair(ypair, THRESHOLD), 20),
            timed(lambda: elemwise_ref.mag_shrink_pair_ref(ypair, THRESHOLD), 5),
        ),
        "nddwt_fista_step": (
            timed(lambda: elemwise.fista_step(xn, xp, mask, b, 0.6, 1.0), 20),
            timed(lambda: elemwise_ref.fista_step_ref(xn, xp, mask, b, 0.6, 1.0), 5),
        ),
    }
    queued = {  # the kernels alone, behind a sleep
        "nddwt_mag_shrink_pair": timed_queued(
            lambda: elemwise.mag_shrink_pair(ypair, THRESHOLD), 20),
        "nddwt_fista_step": timed_queued(
            lambda: elemwise.fista_step(xn, xp, mask, b, 0.6, 1.0), 20),
    }
    split_step = (
        timed(lambda: elemwise.fista_step(pn, pp, mask, pb, 0.6, 1.0), 20),
        timed(lambda: elemwise_ref.fista_step_ref(pn, pp, mask, pb, 0.6, 1.0), 5),
    )
    vox, f32 = int(np.prod(SHAPE)), 4
    flops_level = vox * sum(2 ** (a + 2) * len(t[0]) for a, t in enumerate(plan.taps_hp))
    bound = {
        # one level: 1 array in, 8 out (dec); 8 in, 1 out (rec)
        "nddwt_dec_level": bound_ms(9 * vox * f32, flops_level),
        "nddwt_rec_level": bound_ms(9 * vox * f32, flops_level),
        # the pair in and out; about 10 flops per detail element pair
        "nddwt_mag_shrink_pair": bound_ms(2 * ypair.numel() * f32,
                                          10 * ypair[0].numel()),
        # x_new, x_prev, mask, b in; v out; 7 flops per element
        "nddwt_fista_step": bound_ms(5 * vox * f32, 7 * vox),
    }
    split_bound = bound_ms(9 * vox * f32, 14 * vox)

    # The yardstick: one cuDNN convolution computing the same level.
    xpad = conv_pad(x[None], plan.taps_hp, rec=False)
    wdec = conv_weights(plan.taps_hp, rec=False)
    ck.dec_level(x, big, B - 7, plan.taps_hp, final=False)
    approx = level_ref.dec_level_ref(x, big.clone(), B - 7, plan.taps_hp)
    conv = F.conv3d(xpad, wdec)[0]
    check("cuDNN conv3d as one analysis level",
          max(max_err(conv[1:], big[B - 7:]), max_err(conv[0], approx)),
          F32_TOL * big[B - 7:].abs().max().item())
    ypad = conv_pad(big[:nb], plan.taps_hp, rec=True)
    wrec = conv_weights(plan.taps_hp, rec=True) / nb
    r = level_ref.rec_level_ref(big, None, src, plan.taps_hp, 1 / nb)
    check("cuDNN conv3d as one synthesis level", max_err(F.conv3d(ypad, wrec)[0, 0], r),
          F32_TOL * r.abs().max().item())
    library = {
        "nddwt_dec_level": timed(lambda: F.conv3d(xpad, wdec), 5),
        "nddwt_rec_level": timed(lambda: F.conv3d(ypad, wrec), 5),
        "nddwt_mag_shrink_pair": None,  # no single torch call shrinks a pair
        "nddwt_fista_step": None,  # nor computes the step
    }
    del xpad, ypad, conv, approx, r
    for name, (k, p) in ms.items():  # the 3D and solver kernels
        lib = f", cuDNN conv3d {library[name]:.4f} ms" if library[name] else ""
        alone = f", queued {queued[name]:.4f} ms" if name in queued else ""
        print(f"  {name} {SHAPE} db4 f32 per call: kernel {k:.4f} ms{alone}, plain "
              f"{p:.4f} ms{lib}, bound {bound[name][0]:.4f} ms "
              f"({bound[name][1]}) {card}")
    print(f"  nddwt_fista_step split pair {(2,) + SHAPE} f32 per call: kernel "
          f"{split_step[0]:.4f} ms, plain {split_step[1]:.4f} ms, bound "
          f"{split_bound[0]:.4f} ms ({split_bound[1]}) {card}")

    def plain_pair(thr):
        yp = direct_path.dec_direct(x, plan.taps, LEVEL)
        if thr:
            yp = torch.cat([yp[:1], soft_threshold(yp[1:], thr)])
        return direct_path.rec_direct(yp, plan.taps, LEVEL, False)

    steps = {
        "dec+rec pair": (
            lambda: plan.rec(plan.dec(x, LEVEL, band_axis=0), band_axis=0),
            lambda: plain_pair(0.0),
        ),
        f"fused dec_rec step (threshold {THRESHOLD})": (
            lambda: plan.dec_rec(x, LEVEL, threshold=THRESHOLD, band_axis=0),
            lambda: plain_pair(THRESHOLD),
        ),
    }
    for what, (fn, plain) in steps.items():
        k, p = timed(fn, 10), timed(plain, 3)
        print(f"  {what} {SHAPE} db4 L{LEVEL} f32: kernels {k:.4f} ms "
              f"({vox / k / 1e3:.1f} Mvox/s), plain {p:.4f} ms "
              f"({vox / p / 1e3:.1f} Mvox/s) {card}")
    del big, ypair, xn, xp, b, pn, pp, pb
    torch.cuda.empty_cache()
    for name, (run, _) in solvers.items():
        k = timed(lambda: run(splan), 1) / ITERS
        p = timed(lambda: run(dplan), 1) / ITERS
        print(f"  {name} {SHAPE} db4 L{LEVEL} f32 per iteration: kernels "
              f"{k:.4f} ms, plain route {p:.4f} ms {card}")
    del x, xi, mask
    torch.cuda.empty_cache()

    plan4 = tw.NDDWT("db4", SHAPE4, device=dev)
    taps4 = plan4.taps_hp
    gen.manual_seed(600)
    x4 = torch.randn(SHAPE4, generator=gen, device=dev)
    temp = ck.lane_dec(x4, taps4)
    big4 = torch.randn((16,) + SHAPE4, generator=gen, device=dev)
    src16 = [("y", b) for b in range(16)]
    ms.update({
        "nddwt_lane_dec": (
            timed(lambda: ck.lane_dec(x4, taps4), 10),
            timed(lambda: level4_ref.lane_dec_ref(x4, taps4), 3)),
        "nddwt_lead_dec": (
            timed(lambda: ck.lead_dec(temp, big4, 1, taps4), 10),
            timed(lambda: level4_ref.lead_dec_ref(temp, big4, 1, taps4), 3)),
        "nddwt_lead_adj": (
            timed(lambda: ck.lead_adj(big4, None, src16, taps4), 10),
            timed(lambda: level4_ref.lead_adj_ref(big4, None, src16, taps4), 3)),
        "nddwt_lane_adj": (
            timed(lambda: ck.lane_adj(temp, taps4, 1 / 16), 10),
            timed(lambda: level4_ref.lane_adj_ref(temp, taps4, 1 / 16), 3)),
    })
    library.update(stage_library(x4, temp, big4, taps4))
    del temp, big4
    torch.cuda.empty_cache()
    vox4 = int(np.prod(SHAPE4))
    k4 = [len(t[0]) for t in taps4]
    # Lane stage: 2 outputs of Kz taps, then 4 of Kt, per voxel; the lead
    # stage the same over X and Y for each of the 4 lane bands. The
    # adjoints do the same multiply-adds. Bytes: lane 1 array in and 4 out
    # (4 in, 1 out for the adjoint); lead 4 in, 16 out (16 in, 4 out).
    lane_flops = vox4 * (4 * k4[2] + 8 * k4[3])
    lead_flops = 4 * vox4 * (4 * k4[0] + 8 * k4[1])
    bound.update({
        "nddwt_lane_dec": bound_ms(5 * vox4 * f32, lane_flops),
        "nddwt_lead_dec": bound_ms(20 * vox4 * f32, lead_flops),
        "nddwt_lead_adj": bound_ms(20 * vox4 * f32, lead_flops),
        "nddwt_lane_adj": bound_ms(5 * vox4 * f32, lane_flops),
    })
    for name in STAGE_KERNELS:
        k, p = ms[name]
        lib = library[name]
        print(f"  {name} {SHAPE4} db4 f32 per call: kernel {k:.4f} ms, plain "
              f"{p:.4f} ms, {LIBRARY_CALL[name]} {lib:.4f} ms, bound "
              f"{bound[name][0]:.4f} ms ({bound[name][1]}) {card}")

    def plain_pair4(thr):
        yp = direct_path.dec_direct(x4, plan4.taps, LEVEL)
        if thr:
            yp = torch.cat([yp[:1], soft_threshold(yp[1:], thr)])
        return direct_path.rec_direct(yp, plan4.taps, LEVEL, False)

    steps4 = {
        "4D dec+rec pair": (
            lambda: plan4.rec(plan4.dec(x4, LEVEL, band_axis=0), band_axis=0),
            lambda: plain_pair4(0.0)),
        f"4D fused dec_rec step (threshold {THRESHOLD})": (
            lambda: plan4.dec_rec(x4, LEVEL, threshold=THRESHOLD, band_axis=0),
            lambda: plain_pair4(THRESHOLD)),
    }
    for what, (fn, plain) in steps4.items():
        k, p = timed(fn, 5), timed(plain, 2, warm=1)
        print(f"  {what} {SHAPE4} db4 L{LEVEL} f32: kernels {k:.4f} ms "
              f"({vox4 / k / 1e3:.1f} Mvox/s), plain {p:.4f} ms "
              f"({vox4 / p / 1e3:.1f} Mvox/s) {card}")
    del x4
    torch.cuda.empty_cache()
    k = timed(lambda: cs_mri4(splan4, 3), 1, warm=1) / 3
    p = timed(lambda: cs_mri4(dplan4, 3), 1, warm=1) / 3
    print(f"  4D fista_cs_mri {CS_SHAPE4} db4 L{LEVEL} f32 per iteration: kernels "
          f"{k:.4f} ms, plain route {p:.4f} ms {card}")
    del kt, mask4
    torch.cuda.empty_cache()

    # The float64 level kernels at 256^3 db4, the same work as the float32
    # ones above in twice the bytes, at the float64 rate.
    taps64, B64 = plan64.taps_hp, plan64.num_bands(LEVEL)
    gen.manual_seed(1000)
    big64 = randn((B64,) + SHAPE, torch.float64)
    ms64 = {
        "nddwt_dec_level": (
            timed(lambda: ck.dec_level(xd, big64, B64 - 7, taps64), 10),
            timed(lambda: level_ref.dec_level_ref(xd, big64, B64 - 7, taps64), 3)),
        "nddwt_rec_level": (
            timed(lambda: ck.rec_level(big64, None, src, taps64, 1 / nb), 10),
            timed(lambda: level_ref.rec_level_ref(big64, None, src, taps64, 1 / nb), 3)),
    }
    bound64 = {name: bound_ms(9 * vox * 8, flops_level, F64_FLOPS) for name in F64_REPLACES}
    xpad = conv_pad(xd[None], taps64, rec=False)
    wdec = conv_weights(taps64, rec=False, dtype=torch.float64)
    approx = level_ref.dec_level_ref(xd, big64, B64 - 7, taps64)
    conv = F.conv3d(xpad, wdec)[0]
    check("cuDNN conv3d f64 as one analysis level",
          max(max_err(conv[1:], big64[B64 - 7:]), max_err(conv[0], approx)),
          F64_TOL * big64[B64 - 7:].abs().max().item())
    del conv, approx
    ypad = conv_pad(big64[:nb], taps64, rec=True)
    wrec = conv_weights(taps64, rec=True, dtype=torch.float64) / nb
    r = level_ref.rec_level_ref(big64, None, src, taps64, 1 / nb)
    check("cuDNN conv3d f64 as one synthesis level",
          max_err(F.conv3d(ypad, wrec)[0, 0], r), F64_TOL * r.abs().max().item())
    library64 = {
        "nddwt_dec_level": timed(lambda: F.conv3d(xpad, wdec), 2, warm=1),
        "nddwt_rec_level": timed(lambda: F.conv3d(ypad, wrec), 2, warm=1),
    }
    del xpad, ypad, r, big64
    torch.cuda.empty_cache()
    for name, (k, p) in ms64.items():
        print(f"  {name} {SHAPE} db4 f64 per call: kernel {k:.4f} ms, plain {p:.4f} ms, "
              f"cuDNN conv3d f64 {library64[name]:.4f} ms, bound {bound64[name][0]:.4f} "
              f"ms ({bound64[name][1]}) {card}")

    def plain_pair64(thr):
        yp = direct_path.dec_direct(xd, plan64.taps, LEVEL)
        if thr:
            yp = torch.cat([yp[:1], soft_threshold(yp[1:], thr)])
        return direct_path.rec_direct(yp, plan64.taps, LEVEL, False)

    for what, (fn, plain) in {
        "f64 dec+rec pair": (
            lambda: plan64.rec(plan64.dec(xd, LEVEL, band_axis=0), band_axis=0),
            lambda: plain_pair64(0.0)),
        f"f64 fused dec_rec step (threshold {THRESHOLD})": (
            lambda: plan64.dec_rec(xd, LEVEL, threshold=THRESHOLD, band_axis=0),
            lambda: plain_pair64(THRESHOLD)),
    }.items():
        k, p = timed(fn, 5), timed(plain, 2, warm=1)
        print(f"  {what} {SHAPE} db4 L{LEVEL}: kernels {k:.4f} ms "
              f"({vox / k / 1e3:.1f} Mvox/s), plain {p:.4f} ms "
              f"({vox / p / 1e3:.1f} Mvox/s) {card}")
    del xd
    torch.cuda.empty_cache()

    # The 1D kernels at 2^23 db6, float32 (the top-level entries) and float64.
    taps1 = plan1l.taps_hp
    k1 = len(taps1[0][0])
    ms1, bound1, library1, queued1 = {}, {}, {}, {}
    for dt, word, rate in ((torch.float32, 4, F32_FLOPS), (torch.float64, 8, F64_FLOPS)):
        gen.manual_seed(1100)
        x1d = randn((N1,), dt)
        big1 = randn((5, N1), dt)
        s1 = [("y", 0), ("y", 1)]
        ms1[dt] = {
            "nddwt_dec1_level": (
                timed(lambda: ck.dec1_level(x1d, big1, 4, taps1), 50),
                timed(lambda: level_ref.dec_level_ref(x1d, big1, 4, taps1), 10)),
            "nddwt_rec1_level": (
                timed(lambda: ck.rec1_level(big1, None, s1, taps1, 0.5), 50),
                timed(lambda: level_ref.rec_level_ref(big1, None, s1, taps1, 0.5), 10)),
        }
        queued1[dt] = {  # the kernels alone, behind a sleep
            "nddwt_dec1_level": timed_queued(lambda: ck.dec1_level(x1d, big1, 4, taps1), 50),
            "nddwt_rec1_level": timed_queued(
                lambda: ck.rec1_level(big1, None, s1, taps1, 0.5), 50),
        }
        # 1 array in, 2 out (or 2 in, 1 out); 2 K multiply-adds per sample
        bound1[dt] = dict.fromkeys(LEVEL1, bound_ms(3 * N1 * word, 4 * k1 * N1, rate))
        xpad = F.pad(x1d[None, None], (k1 // 2 - 1, k1 - k1 // 2), mode="circular")
        wdec = conv1d_weights(taps1, False, dt)
        approx = level_ref.dec_level_ref(x1d, big1, 4, taps1)
        conv = F.conv1d(xpad, wdec)[0]
        tol = rel_tol(big1[4], dt)
        check(f"F.conv1d {str(dt).removeprefix('torch.')} as one 1D analysis level",
              max(max_err(conv[1], big1[4]), max_err(conv[0], approx)), tol)
        ypad = F.pad(big1[None, :2], (k1 // 2, k1 - 1 - k1 // 2), mode="circular")
        wrec = conv1d_weights(taps1, True, dt) * 0.5
        r = level_ref.rec_level_ref(big1, None, s1, taps1, 0.5)
        check(f"F.conv1d {str(dt).removeprefix('torch.')} as one 1D synthesis level",
              max_err(F.conv1d(ypad, wrec)[0, 0], r), rel_tol(r, dt))
        library1[dt] = {"nddwt_dec1_level": timed(lambda: F.conv1d(xpad, wdec), 20),
                        "nddwt_rec1_level": timed(lambda: F.conv1d(ypad, wrec), 20)}
        for name, (k, p) in ms1[dt].items():
            print(f"  {name} ({N1},) db6 {str(dt).removeprefix('torch.')} per call: kernel "
                  f"{k:.4f} ms, queued {queued1[dt][name]:.4f} ms, plain {p:.4f} ms, "
                  f"F.conv1d {library1[dt][name]:.4f} ms, "
                  f"bound {bound1[dt][name][0]:.4f} ms ({bound1[dt][name][1]}) {card}")
        del x1d, big1, xpad, ypad, conv, approx, r

    def plain_pair1(thr):
        yp = direct_path.dec_direct(xl, plan1l.taps, 4)
        if thr:
            yp = torch.cat([yp[:1], soft_threshold(yp[1:], thr)])
        return direct_path.rec_direct(yp, plan1l.taps, 4, False)

    for what, (fn, plain) in {
        "1D dec+rec pair": (
            lambda: plan1l.rec(plan1l.dec(xl, 4, band_axis=0), band_axis=0),
            lambda: plain_pair1(0.0)),
        f"1D fused dec_rec step (threshold {THRESHOLD})": (
            lambda: plan1l.dec_rec(xl, 4, threshold=THRESHOLD, band_axis=0),
            lambda: plain_pair1(THRESHOLD)),
    }.items():
        k, p = timed(fn, 20), timed(plain, 5)
        print(f"  {what} ({N1},) db6 L4 f32: kernels {k:.4f} ms "
              f"({N1 / k / 1e3:.1f} Msamples/s), plain {p:.4f} ms "
              f"({N1 / p / 1e3:.1f} Msamples/s) {card}")
    # The one-launch kernels at the one-launch solves' shape, beside the
    # per-level route: no PyTorch call computes a multilevel transform.
    taps_s = fplan.taps_hp
    x0, b0 = xs[0], smask * xs[0]
    lams_s, moms_s = _fista_schedule(SOLVE_ITERS, LAM, 1.0)
    ms["nddwt_flat_pair"] = (
        timed(lambda: flat.pair_flat(x0, taps_s, LEVEL, True, THRESHOLD), 50),
        timed(lambda: flat_ref.flat_pair_ref("pair", x0, taps_s, LEVEL, True, THRESHOLD), 10))
    ms["nddwt_flat_iter"] = (
        timed(lambda: flat.fista_flat(b0, smask, taps_s, LEVEL, True, lams_s, moms_s, 1.0), 5),
        timed(lambda: flat_ref.flat_iter_ref("fista", b0, smask, taps_s, LEVEL, True, lams_s,
                                             moms_s, 1.0), 1, warm=1))
    queued.update({  # the kernels alone, behind a sleep
        "nddwt_flat_pair": timed_queued(
            lambda: flat.pair_flat(x0, taps_s, LEVEL, True, THRESHOLD), 50),
        "nddwt_flat_iter": timed_queued(
            lambda: flat.fista_flat(b0, smask, taps_s, LEVEL, True, lams_s, moms_s, 1.0), 5),
    })
    with xover.limits(0, 0, 0):  # the per-level route at the same shapes
        per_level_route = {
            "nddwt_flat_pair": timed(
                lambda: fplan.dec_rec(x0, LEVEL, threshold=THRESHOLD, band_axis=0), 50),
            "nddwt_flat_iter": timed(
                lambda: fista_inpaint(fplan, b0, smask, LAM, LEVEL, 10), 2, warm=1)
            * SOLVE_ITERS / 10,
        }
        split_stepped = timed(lambda: one_launch["fista_inpaint_split"](fplan), 1, warm=1)
        chain_stepped = timed(
            lambda: cplan.dec_rec(xc, LEVEL, threshold=lams_n[0], band_axis=0), 20)
    split_one = timed(lambda: one_launch["fista_inpaint_split"](fplan), 3)
    chain_one = timed(lambda: cplan.dec_rec_n(xc, LEVEL, lams_n), 10)
    nsp = int(np.prod(SOLVE_SHAPE))
    # Multiply-adds (2 flops each) of one analysis and one synthesis: per
    # level and axis a, K_a taps for each of the 2^(a+1) bands at that depth.
    flops_pair = 2 * 2 * LEVEL * nsp * sum(
        len(t[0]) * 2 ** (a + 1) for a, t in enumerate(taps_s))
    bound.update({
        # x in; the B bands and x out
        "nddwt_flat_pair": bound_ms((1 + fplan.num_bands(LEVEL) + 1) * nsp * f32, flops_pair),
        # b and the mask in, x out; the bands are scratch
        "nddwt_flat_iter": bound_ms(3 * nsp * f32, SOLVE_ITERS * flops_pair),
    })
    library.update(dict.fromkeys(FLAT_KERNELS))
    for name, what in (("nddwt_flat_pair", f"one dec_rec pair, threshold {THRESHOLD}"),
                       ("nddwt_flat_iter", f"one {SOLVE_ITERS}-iteration fista_inpaint")):
        k, p = ms[name]
        print(f"  {name} {SOLVE_SHAPE} db4 L{LEVEL} f32 per call ({what}): kernel {k:.4f} ms, "
              f"queued {queued[name]:.4f} ms, plain {p:.4f} ms, per-level route "
              f"{per_level_route[name]:.4f} ms, library none, bound {bound[name][0]:.4f} ms "
              f"({bound[name][1]}) {card}")
    print(f"  fista_inpaint {SOLVE_SHAPE} per iteration: one launch "
          f"{ms['nddwt_flat_iter'][0] / SOLVE_ITERS:.4f} ms, per-level stepped "
          f"{per_level_route['nddwt_flat_iter'] / SOLVE_ITERS:.4f} ms {card}")
    print(f"  fista_inpaint_split {SOLVE_SHAPE} per iteration: one launch "
          f"{split_one / SOLVE_ITERS:.4f} ms, per-level stepped "
          f"{split_stepped / SOLVE_ITERS:.4f} ms {card}")
    print(f"  dec_rec_n {CHAIN_SHAPE} {CHAIN_WV} L{LEVEL} per sweep: one launch "
          f"{chain_one / CHAIN_SWEEPS:.4f} ms, one per-level dec_rec {chain_stepped:.4f} ms "
          f"{card}")
    # The long-filter step on both routes, whichever the plan takes.
    step20 = lambda: plan20.dec_rec(x20, 2, threshold=THRESHOLD, band_axis=0)  # noqa: E731
    t20 = {}
    for route, cap in (("stage kernels", 0), ("flat kernel", 2**62), ("flat kernel", 2**62),
                       ("stage kernels", 0)):
        with xover.limits(cap, cap, 0):
            t20.setdefault(route, []).append(timed(step20, 10))
    own = plan20.route(torch.float32, 2) == "flat"
    print(f"  dec_rec {plan20.shape} db20 L2 f32 per call: stage kernels "
          f"{sum(t20['stage kernels']) / 2:.4f} ms, flat kernel {sum(t20['flat kernel']) / 2:.4f} "
          f"ms (the plan takes the {'flat' if own else 'stage'} route) {card}")
    # The multilevel kernels at their main path's call, the multi-coil
    # slice's 2 N real components of 256^2 db4 L3 f32, beside the same batch
    # through dec_batched/rec_batched on the per-level route and on the flat
    # kernel (no PyTorch call computes a multilevel transform).
    taps_c = tw.NDDWT("db4", COIL_SHAPE, device=dev).taps_hp
    rplan = tw.NDDWT("db4", COIL_SHAPE, device=dev)
    gen.manual_seed(1400)
    xbm = torch.randn((2 * COILS,) + COIL_SHAPE, generator=gen, device=dev)
    ybm = multi.dec_multi(xbm, taps_c, LEVEL)
    ms["nddwt_dec_multi"] = (timed(lambda: multi.dec_multi(xbm, taps_c, LEVEL), 50),
                             timed(lambda: multi_ref.dec_multi_ref(xbm, taps_c, LEVEL), 5))
    ms["nddwt_rec_multi"] = (
        timed(lambda: multi.rec_multi(ybm, taps_c, LEVEL, False), 50),
        timed(lambda: multi_ref.rec_multi_ref(ybm, taps_c, LEVEL, 0.25), 5))
    queued["nddwt_dec_multi"] = timed_queued(lambda: multi.dec_multi(xbm, taps_c, LEVEL), 50)
    queued["nddwt_rec_multi"] = timed_queued(
        lambda: multi.rec_multi(ybm, taps_c, LEVEL, False), 50)
    flat_route = {}
    nitems = 2 * COILS
    for route, caps, per_item, store in (
            ("per-level", (0, 0, 0), ("nddwt_dec_level", "nddwt_rec_level", LEVEL),
             per_level_route),
            ("flat", (2**62, 2**62, 0), ("nddwt_flat_pair", "nddwt_flat_pair", 1),
             flat_route)):
        with xover.limits(*caps):
            for name, fn in (("nddwt_dec_multi", lambda: rplan.dec_batched(xbm, LEVEL)),
                             ("nddwt_rec_multi", lambda: rplan.rec_batched(ybm))):
                kernel = per_item[0] if name == "nddwt_dec_multi" else per_item[1]
                got = xover.launches(fn)
                if got != {kernel: nitems * per_item[2]}:
                    failures.append(f"{name} on the {route} route launched {got}")
                store[name] = timed(fn, 20)
    nvc = nitems * int(np.prod(COIL_SHAPE))
    flops_multi = LEVEL * nvc * sum(2 ** (a + 2) * len(t[0]) for a, t in enumerate(taps_c))
    bytes_multi = (1 + rplan.num_bands(LEVEL)) * nvc * f32  # x and the bands, once each
    bound.update(dict.fromkeys(MULTI_KERNELS, bound_ms(bytes_multi, flops_multi)))
    library.update(dict.fromkeys(MULTI_KERNELS))
    for name in MULTI_KERNELS:
        k, p = ms[name]
        print(f"  {name} {(nitems,) + COIL_SHAPE} db4 L{LEVEL} f32 per call: kernel {k:.4f} ms, "
              f"queued {queued[name]:.4f} ms, plain {p:.4f} ms, per-level route "
              f"{per_level_route[name]:.4f} ms, flat "
              f"kernel {flat_route[name]:.4f} ms, library none, bound {bound[name][0]:.4f} ms "
              f"({bound[name][1]}) {card}")
    del xbm, ybm
    torch.cuda.empty_cache()
    print(f"  crossover, one launch against the per-level route ({xover.__name__}.py) {card}:")
    table = xover.measure(log=lambda line: print(f"    {line}"), max_reps=20)
    print("    " + json.dumps({k: table[k] for k in (
        "flat_no_slower_up_to", "one_launch_solve_no_slower_up_to",
        "multi_no_slower_than_per_level_up_to", "multi_10pct_faster_than_flat_from",
        "batched_multi_no_slower_than_per_level_up_to")}))
    padded_ms = chip_sharded.time_padded(timed, bound_ms, conv_weights, lead_conv,
                                           check, card)
    ms.update(ms1[torch.float32])
    queued.update(queued1[torch.float32])
    bound.update(bound1[torch.float32])
    library.update(library1[torch.float32])
    f64_entry = {  # name: (replaces, launches, error, times, bound, library)
        **{name: (F64_REPLACES[name], launches64[name], main_err64[name], ms64[name],
                  bound64[name], library64[name]) for name in F64_REPLACES},
        **{name: (KERNELS[name][1], launches1_64[name], main_err64[name],
                  ms1[torch.float64][name], bound1[torch.float64][name],
                  library1[torch.float64][name]) for name in LEVEL1},
    }

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(smi)

    def entry(where, n, err, times, bnd, lib):
        return {"replaces": where, "launches": n, "max_abs_err": err, "ms": times[0],
                "plain_ms": times[1], "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": lib}

    kernels = []
    for name, (source, where) in KERNELS.items():
        k = {"name": name, "route": "cuda", "source": source,
             **entry(where, launches[name], main_err[name], ms[name], bound[name],
                     library[name])}
        if name in f64_entry:  # the float64 instantiation
            k["float64"] = entry(*f64_entry[name])
            if name in LEVEL1:
                k["float64"]["queued_ms"] = queued1[torch.float64][name]
        if name in per_level_route:  # in place of a library call
            k["per_level_route_ms"] = per_level_route[name]
        if name in queued:  # the kernel alone, behind a sleep
            k["queued_ms"] = queued[name]
        if name in flat_route:
            k["flat_route_ms"] = flat_route[name]
        if name in padded_ms:  # the halo-padded mode, on the sharded path
            t = padded_ms[name]
            k["valid"] = {
                **entry(chip_sharded.VALID_REPLACES[name],
                        chip_sharded.valid_launches(sharded, name), padded_err[name],
                        (t["ms"], t["plain_ms"]), (t["bound_ms"], t["bound_by"]),
                        t["library_ms"]),
                "wrap_ms": t["wrap_ms"]}
        kernels.append(k)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stopped = _stop_children()
        if stopped:
            print(f"chip_smoke: stopped {len(stopped)} process(es) still running at "
                  f"the end: {stopped}", file=sys.stderr)
    sys.exit(code)
