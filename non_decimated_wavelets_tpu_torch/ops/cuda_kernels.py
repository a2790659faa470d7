"""The CUDA kernels' build, and the level kernels: bind, launch, loops.

Every source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` at first
use into its own shared library in ``non_decimated_wavelets_tpu_torch/_build/``,
under a name keyed by a hash of the source, the shared header and the flags,
and loaded with ``ctypes`` (a plain C interface: no PyTorch headers, so a
build takes seconds). ``build()`` starts one ``nvcc`` per source, all at
once. Importing this module builds nothing.

``csrc/nddwt_level.cu`` holds the two hand-written Hopper kernels of a 2D or
3D level (``non_decimated_wavelets_tpu/ops/pallas_kernels.py``):

* ``nddwt_dec_level`` for ``_fused_dec_level`` / ``_make_dec_kernel``;
* ``nddwt_rec_level`` for ``_fused_rec_level`` / ``_make_rec_kernel``.

``csrc/nddwt_4d.cu`` holds the four stage kernels of a 4D level
(``non_decimated_wavelets_tpu/ops/pallas_4d.py``), two launches per level
and direction:

* ``nddwt_lane_dec`` for ``_lane_dec_call``, ``nddwt_lead_dec`` for
  ``_lead_dec_call``;
* ``nddwt_lead_adj`` for ``_lead_adj_call``, ``nddwt_lane_adj`` for
  ``_lane_adj_call``.

``nddwt_rec_level`` and ``nddwt_lead_adj`` run one streamed synthesis body,
``nddwt_dec_level`` and ``nddwt_lead_dec`` one streamed analysis body
(``csrc/nddwt_stream.cuh``): a CTA walks a chunk of the slowest halo axis
plane by plane, copying each plane's window once, with a ring of partial
output planes (synthesis) or of the last K planes' in-plane bands
(analysis); ``_stream_plan`` lays out its chunk and plane tile, and
``ops/stream_ref.py`` replays both schedules on the CPU for the tests.
``nddwt_rec_level`` of a 3D level with 2 to 8 taps on every axis and
input rows on 16 bytes runs the plane body instead
(``csrc/nddwt_plane.cuh``, ``_plane_plan``, ``stream_ref.plane_replay``):
bulk copies of each (input plane, s0) stage's four band windows on an
mbarrier, slot 1 before slot 2; ``nddwt_dec_level`` of the same levels the
analysis plane body of the same header (``_plane_ana_plan``,
``stream_ref.plane_ana_replay``): one input plane's window a stage.
``nddwt_lane_dec`` and ``nddwt_lane_adj`` run the lane body
(``csrc/nddwt_lane.cuh``): persistent CTAs walk units of whole (Z, T)
slabs of the (X*Y, Z, T) view (or chunks of Z with their halo rows), each
copied once by bulk asynchronous copies into a ring of unit buffers;
``_lane_plan`` lays out the unit and ``stream_ref.lane_replay`` replays
it. A lane stage whose T row is too long for it runs on the older tile
body (where ``_lane_plan`` finds no plan).

The wrapper decides the body of every launch of these three kernels
(``dec_stream_args``, ``rec_stream_args``, ``_stage_geometry``), builds
that body's plan alone and names the body to the library, which runs it
and refuses (``cudaErrorInvalidValue``) a plan that does not fit it; the
counters ``nddwt.{dec,rec}_level.body.{plane,window}`` count the
wrapper's choice.

A 3D level whose filters are too long for the tile the per-level kernels
had before they streamed (about 30 taps and up on every axis, db15 and
longer: ``stage_route``) runs on the stage kernels too, with one lane axis;
``NDDWT.route`` picks that route and ``dec_levels``/``rec_levels`` run it.

``csrc/nddwt_1d.cu`` holds the two kernels of a 1D level
(``non_decimated_wavelets_tpu/ops/pallas_padded.py``):

* ``nddwt_dec1_level`` for ``_dec1_level``, ``nddwt_rec1_level`` for
  ``_rec1_level``.

``csrc/nddwt_elemwise.cu`` holds the solvers' elementwise kernels, bound in
``ops/elemwise.py``; ``csrc/nddwt_flat.cu`` the one-launch whole-transform
and whole-solve kernels of small arrays of any ndim, bound in
``ops/flat.py``; ``csrc/nddwt_multi.cu`` the one-launch multilevel kernels
of batches of 2D and 3D arrays, bound in ``ops/multi.py``, which run the
streamed bodies for every level and item in one launch.

Every kernel takes float32 and bfloat16 arrays, computing in float32, and
float64 arrays, computing in float64 with float64 taps: the float64
instantiations of ``nddwt_dec_level``/``nddwt_rec_level`` replace the TPU's
float64-accurate levels (``pallas_df32._dec_level_df``/``_rec_level_df``).
A launch's taps and its shared-memory words are in the compute type.

Each wrapper launches its kernel for a CUDA tensor and raises if the
launch fails; for a CPU tensor it runs the kernel's plain version
(``ops/level_ref.py``, ``ops/level4_ref.py``, ``ops/elemwise_ref.py``).
Nothing falls back from CUDA to the plain version. ``launch_counts`` counts
the launches of every kernel, so a run can show which kernels a path went
through; the host work of each launch (here and in ``ops/flat.py``,
``ops/multi.py``, ``ops/elemwise.py``) runs inside the span
``nddwt.launch.<kernel>`` (``tracing.py``).

``dec_level``, ``rec_level``, ``lead_dec`` and ``lead_adj`` have a
halo-padded mode (``padded=``, one flag per axis; the lead stages' flags
cover axes 0 and 1): a flagged axis of the input is one rank's block of an
axis sharded across ranks, with its ring neighbours' rows around it, by
the widths ``halo_widths`` gives. The kernels read it without wrapping and
the outputs keep the block's extent. It replaces the "valid" modes of the
TPU kernels (TPU kernel table row 23), which only the sharded bodies call
(``non_decimated_wavelets_tpu/parallel/sharded.py:338-600``;
``parallel/sharded.py`` here). ``padded_launch_counts`` counts those
launches a second time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import itertools
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import tracing
from ..oracle import num_bands
from .level4_ref import lane_adj_ref, lane_dec_ref, lead_adj_ref, lead_dec_ref
from .level_ref import dec_level_ref, rec_level_ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("nddwt_level", "nddwt_elemwise", "nddwt_4d", "nddwt_1d",
           "nddwt_flat", "nddwt_multi")  # csrc/<name>.cu
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
)
_MAX_TAPS = 76  # kMaxTaps in the source
# The tile body's lane-stage tiles (csrc/nddwt_4d.cu: the class no plan of
# the lane body fits, _lane_plan) take less, so that more CTAs share an SM
# and hide each other's window loads: the budget that was fastest in a sweep
# of tiles at (128, 128, 128, 32) db4 on an H100 (PERF.md).
_LANE_SMEM_BUDGET = 32 * 1024
# The lane body (csrc/nddwt_lane.cuh): the most unit buffers in flight
# (kLaneMaxStages), the elements a unit of whole slabs aims at, and the
# dynamic shared memory at which two CTAs still share an SM (228 KB less
# each CTA's static tap table and reserve).
_LANE_MAX_STAGES = 4
_LANE_UNIT = 4096
_LANE_TWO_PER_SM = 108 * 1024
_THREADS = 256  # kThreads in the sources
# The streamed bodies (csrc/nddwt_stream.cuh: the synthesis of
# nddwt_rec_level and nddwt_lead_adj, the analysis of nddwt_dec_level and
# nddwt_lead_dec): the filter lengths whose tap loops and ring are unrolled
# (stream_unrolled), the synthesis's plane elements per thread there
# (kStreamItems; 1 otherwise), the 32-bit registers the analysis's ring may
# take there (kAnaRingRegs, which sets its plane elements per thread:
# ana_items), the most window buffers in flight (kStreamMaxStages), the
# dynamic shared memory a CTA may take (kStreamSmemBudget: 227 KB less the
# static tap table), the synthesis's preferred plane width T2 per kind, the
# analysis's preferred plane height T1 (the same in every dtype and kind)
# and the CTAs of one wave (two per SM of an H100), which set the chunk along
# the streamed slot: the fastest in sweeps of (C, T1, T2) at 256^3 db4 and
# (128, 128, 128, 32) db4 on an H100 (PERF.md).
_STREAM_UNROLLED = (2, 4, 6, 8)
_STREAM_ITEMS = 4
_ANA_RING_REGS = 64
_STREAM_MAX_STAGES = 4
_STREAM_SMEM_BUDGET = 200 * 1024
_STREAM_T2 = {"rec": 128, "lead": 256}
_ANA_T1 = 8
_ANALYSIS = ("dec", "lead_dec")
_STREAM_CTAS = 2 * 132
# The plane bodies of nddwt_rec_level's and nddwt_dec_level's 3D views
# (csrc/nddwt_plane.cuh): their threads (kPlaneThreads, one CTA an SM), the
# most stage buffers in flight (kPlaneMaxStages), the dynamic shared memory
# a CTA may take (kPlaneSmem), the alignment of its buffers (kPlaneAlign),
# the rows of a slot-1 item of the synthesis (kPlaneRows) and of the
# analysis (kPlaneAnaRows), the slot-1 items a thread at most
# (kPlaneRounds), the plane elements a thread (NI) by compute word, and the
# synthesis's plane tile's preferred and most rows where the tile cannot
# span slot 2: the fastest in sweeps of (C, T1, T2) at (320, 320, 256) and
# 256^3 db4 on an H100 (PERF.md).
_PLANE_THREADS = 512
_PLANE_MAX_STAGES = 4
_PLANE_SMEM = 220 * 1024
_PLANE_ALIGN = 128
_PLANE_ROWS = 4
_PLANE_ANA_ROWS = 2
_PLANE_ROUNDS = 3
_PLANE_ITEMS = {4: 4, 8: 2}
_PLANE_T1 = 8
_PLANE_T1_MAX = 64
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

launch_counts = {
    "nddwt_dec_level": 0,
    "nddwt_rec_level": 0,
    "nddwt_mag_shrink_pair": 0,
    "nddwt_fista_step": 0,
    "nddwt_lane_dec": 0,
    "nddwt_lead_dec": 0,
    "nddwt_lead_adj": 0,
    "nddwt_lane_adj": 0,
    "nddwt_dec1_level": 0,
    "nddwt_rec1_level": 0,
    "nddwt_flat_pair": 0,
    "nddwt_flat_iter": 0,
    "nddwt_dec_multi": 0,
    "nddwt_rec_multi": 0,
}


# The launches in the halo-padded mode, counted in ``launch_counts`` too.
padded_launch_counts = dict.fromkeys(
    ("nddwt_dec_level", "nddwt_rec_level", "nddwt_lead_dec", "nddwt_lead_adj"), 0)


def reset_launch_counts() -> None:
    for counts in (launch_counts, padded_launch_counts):
        for name in counts:
            counts[name] = 0


def _count(name: str, pad) -> None:
    launch_counts[name] += 1
    if any(pad):
        padded_launch_counts[name] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the NDDWT CUDA kernels are "
            "built from source at first use"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: keyed by a hash
    of the source, the shared headers it may include, and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{key}.so"


def build(names=SOURCES) -> list:
    """Compile the named sources that have not been built yet, one ``nvcc``
    each, all started together; return the libraries' paths."""
    tmps, jobs = [], []
    try:
        for name in names:
            so = library_path(name)
            if so.exists():
                continue
            BUILD_DIR.mkdir(exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            tmps.append(tmp)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((name, so, tmp, proc))
        failed = []
        for name, so, tmp, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"nvcc failed ({proc.returncode}) on {name}.cu:\n{out}")
            else:  # atomic: two processes building at once both succeed
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in tmps:
            if os.path.exists(tmp):
                os.remove(tmp)
    return [library_path(name) for name in names]


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at the first call and
    loaded once."""
    return ctypes.CDLL(str(build((name,))[0]))


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The per-level kernel library with its signatures declared."""
    lib = library("nddwt_level")
    ip = ctypes.POINTER(ctypes.c_int)
    vp = ctypes.c_void_p
    geom = [ctypes.c_int, ip, ip, ip, ip, ip, vp]  # dtype, n, k, t, left, bit, taps
    lib.nddwt_dec_level.argtypes = [vp, vp, vp] + geom + [
        ctypes.c_longlong, ctypes.c_double, ctypes.c_int, ip, ctypes.c_int, vp]  # ..., body, stream
    lib.nddwt_dec_level.restype = ctypes.c_int
    lib.nddwt_rec_level.argtypes = [vp, vp, vp] + geom + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_double, ip, ctypes.c_int, vp]  # ..., body, stream
    lib.nddwt_rec_level.restype = ctypes.c_int
    return _check_level_library(lib)


def _check_level_library(lib) -> ctypes.CDLL:
    """Declare the error and tap-count queries both level libraries
    export, and check the tap count against the wrapper's."""
    lib.nddwt_error_string.argtypes = [ctypes.c_int]
    lib.nddwt_error_string.restype = ctypes.c_char_p
    lib.nddwt_max_taps.restype = ctypes.c_int
    if lib.nddwt_max_taps() != _MAX_TAPS:
        raise RuntimeError("kernel library and wrapper disagree on kMaxTaps")
    return lib


@functools.lru_cache(maxsize=None)
def load4() -> ctypes.CDLL:
    """The 4D stage kernel library with its signatures declared."""
    lib = library("nddwt_4d")
    ip = ctypes.POINTER(ctypes.c_int)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    geom = [i, ip, ip, ip, ip, vp]  # dtype, n, k, t, left, taps
    lib.nddwt_lane_dec.argtypes = [vp, vp] + geom + [i, vp]  # ..., body, stream
    lib.nddwt_lead_dec.argtypes = [vp, vp, vp] + geom + [
        i, ctypes.c_longlong, f, i, ip, vp]  # ..., gw, pad, stream
    lib.nddwt_lead_adj.argtypes = [vp, vp, vp] + geom + [
        ctypes.POINTER(ctypes.c_longlong), i, ip, vp]
    lib.nddwt_lane_adj.argtypes = [vp, vp] + geom + [f, i, vp]  # ..., scale, body, stream
    for name in ("lane_dec", "lead_dec", "lead_adj", "lane_adj"):
        getattr(lib, f"nddwt_{name}").restype = ctypes.c_int
    return _check_level_library(lib)


@functools.lru_cache(maxsize=None)
def load1() -> ctypes.CDLL:
    """The 1D level kernel library with its signatures declared."""
    lib = library("nddwt_1d")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("nddwt_dec1_level", "nddwt_rec1_level"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, i, ll, i, i, vp, ctypes.c_double, vp]
        fn.restype = ctypes.c_int
    return _check_level_library(lib)


def _compute_dtype(dtype: torch.dtype):
    """The NumPy compute type of a storage dtype: float64 for float64,
    float32 for float32 and bfloat16."""
    return np.float64 if dtype == torch.float64 else np.float32


def _word(dtype: torch.dtype) -> int:
    """Bytes of one shared-memory word of a launch on ``dtype`` arrays."""
    return np.dtype(_compute_dtype(dtype)).itemsize


def halo_widths(taps, rec: bool) -> tuple:
    """The ``(left, right)`` halo of each axis of a level's window: the
    analysis reads ``K//2 - 1`` rows in front of an output and ``K//2``
    behind it, the synthesis (its adjoint) the mirror, ``K//2`` and
    ``K//2 - 1``. A halo-padded input carries exactly these rows; the
    sharded bodies exchange them (``parallel/sharded.py``)."""
    widths = []
    for t in taps:
        K = int(np.shape(t)[1])
        widths.append((K // 2, K // 2 - 1) if rec else (K // 2 - 1, K // 2))
    return tuple(widths)


def _ints(v):
    return (ctypes.c_int * 3)(*v)


def _padded_flags(padded, ndim: int) -> tuple:
    """``padded`` (None, or one flag per axis of an ``ndim``-D array) as a
    tuple of bools of length ``ndim``."""
    if padded is None:
        return (False,) * ndim
    padded = tuple(bool(p) for p in padded)
    if len(padded) != ndim:
        raise ValueError(f"padded needs one flag per axis ({ndim}), got {padded}")
    return padded


def _padded_shape(shape, taps, padded) -> tuple:
    """The extents of a halo-padded input whose output has ``shape``."""
    return tuple(int(n) + (int(np.shape(t)[1]) - 1 if p else 0)
                 for n, t, p in zip(shape, taps, padded))


def _unpadded_shape(shape, taps, padded, name) -> tuple:
    """The output extents of a halo-padded input of extents ``shape``."""
    out = tuple(int(n) - (int(np.shape(t)[1]) - 1 if p else 0)
                for n, t, p in zip(shape, taps, padded))
    if min(out) < 1:
        raise ValueError(f"{name} {tuple(shape)} is too short for its halo padding")
    return out


def _tap_array(slot_taps, rec: bool, dtype=np.float32) -> np.ndarray:
    """The (slots, 2, kMaxTaps) taps of a launch in the compute type
    ``dtype``: one (2, K) array per slot, reversed for a synthesis, whose
    adjoint reads the mirrored halo; ``None`` marks a pass-through slot,
    one tap of 1.0."""
    arr = np.zeros((len(slot_taps), 2, _MAX_TAPS), dtype)
    for a, t in enumerate(slot_taps):
        if t is None:
            arr[a, :, 0] = 1.0
        else:
            t = np.asarray(t, np.float64)
            arr[a, :, : t.shape[1]] = t[:, ::-1] if rec else t
    return arr


def _taps_ptr(arr):
    """A ``float *`` or ``double *`` to a tap array of that type."""
    ctype = ctypes.c_double if arr.dtype == np.float64 else ctypes.c_float
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def check_array(name, t, ref=None):
    if t.dtype not in DTYPE_CODE:
        raise NotImplementedError(
            f"{name}: the CUDA kernels take float32, bfloat16 and float64, "
            f"got {t.dtype}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ref is not None and (t.dtype != ref.dtype or t.device != ref.device):
        raise ValueError(
            f"{name} is {t.dtype} on {t.device}, expected {ref.dtype} on "
            f"{ref.device}"
        )


def _output(out, shape, like):
    """A synthesis launch's output: ``out`` when given, checked to be a
    contiguous ``shape`` array of ``like``'s dtype and device that the
    launch writes in place (it must not overlap the launch's inputs), else
    a new one."""
    if out is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    check_array("out", out, like)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"out is {tuple(out.shape)}, expected {tuple(shape)}")
    return out


def _into(out, t):
    """A plain version's result ``t``, copied into ``out`` when given
    (checked by ``_output``)."""
    return t if out is None else _output(out, t.shape, t).copy_(t)


def raise_on(lib, err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``lib`` names it)."""
    if err:
        msg = lib.nddwt_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")


def dec_level(approx, big, band_off, taps, lam=0.0, final=False, padded=None):
    """One analysis level (contract of ``level_ref.dec_level_ref``):
    details into ``big[band_off : band_off + 2^d - 1]``, shrunk by ``lam``;
    the approximation into ``big[0]`` when ``final``, else returned.

    On the card it streams slot 0 (``dec_stream_args``: axis 0 of a 2D or
    3D array) on the body ``_dec_body`` names, with that body's plan, and
    counts the body in the counter ``nddwt.dec_level.body.plane`` or
    ``.window`` (``tracing``; not in ``launch_counts``).

    ``padded`` (one flag per axis): the halo-padded mode, which replaces
    the concat and slab "valid" modes of ``_fused_dec_level``
    (``non_decimated_wavelets_tpu/ops/pallas_kernels.py:776``, with
    ``_edge_copies`` :389; TPU kernel table row 23): on a flagged axis
    ``approx`` carries ``K//2 - 1`` rows of its left ring neighbour in
    front and ``K//2`` of its right one behind (``halo_widths``), and the
    bands have the extent of ``big``."""
    if not approx.is_cuda:
        return dec_level_ref(approx, big, band_off, taps, lam, final, padded)
    if approx.ndim not in (2, 3) or len(taps) != approx.ndim:
        raise NotImplementedError(
            f"the per-level CUDA kernels take 2D and 3D arrays, got "
            f"{approx.ndim}D (1D: dec1_level; 4D: the stage kernels)"
        )
    with tracing.span("nddwt.launch.nddwt_dec_level"):
        check_array("approx", approx)
        check_array("big", big, approx)
        pad = _padded_flags(padded, approx.ndim)
        shape = tuple(big.shape[1:])
        nb = 2**approx.ndim
        if (len(shape) != approx.ndim
                or _padded_shape(shape, taps, pad) != tuple(approx.shape)
                or not 1 <= band_off <= big.shape[0] - nb + 1):
            raise ValueError(
                f"band array {tuple(big.shape)} cannot take the {nb - 1} detail "
                f"bands of {tuple(approx.shape)} (halo-padded on {pad}) at offset "
                f"{band_off}"
            )
        out = big[0] if final else torch.empty(shape, dtype=approx.dtype,
                                               device=approx.device)
        (n, k, t, left, bit, vpad, arr), body = dec_stream_args(approx, shape, taps, pad)
        lib = load()
        with torch.cuda.device(approx.device):
            err = lib.nddwt_dec_level(
                approx.data_ptr(), big.data_ptr(), out.data_ptr(),
                DTYPE_CODE[approx.dtype], _ints(n), _ints(k), _ints(t), _ints(left),
                _ints(bit), _taps_ptr(arr), int(band_off), float(lam),
                _walk_bands(k, t, approx.dtype) if body == "window" else 0, _ints(vpad),
                int(body == "plane"), torch.cuda.current_stream().cuda_stream,
            )
        raise_on(lib, err, "nddwt_dec_level")
        _count("nddwt_dec_level", pad)
        tracing.count(f"nddwt.dec_level.body.{body}", 1)
    return None if final else out


def _band_indices(band_src, n_bands: int, y, approx, shape) -> list:
    """The kernels' band-source table: ``y`` index per band, -1 for
    ``("a", 0)`` (then ``approx`` must be an array of the band shape)."""
    idx = []
    for kind, i in band_src:
        if kind == "a":
            idx.append(-1)
        elif kind == "y" and 0 <= i < y.shape[0]:
            idx.append(int(i))
        else:
            raise ValueError(f"bad band source {(kind, i)!r}")
    if len(idx) != n_bands:
        raise ValueError(f"expected {n_bands} band sources, got {len(idx)}")
    if -1 in idx and (approx is None or tuple(approx.shape) != shape):
        raise ValueError("band source ('a', 0) needs an approx of the band shape")
    return idx


def _pow2_at_least(m: int) -> int:
    """The least power of two >= m (1 for m <= 1)."""
    return 1 << max(0, int(m) - 1).bit_length()


def _stream_items(k) -> int:
    """Plane elements per thread of a streamed synthesis with taps ``k``
    per slot (``stream_items`` in the source): ``_STREAM_ITEMS`` where the
    taps are unrolled (one length of ``_STREAM_UNROLLED`` on every slot with
    a halo), else 1."""
    K = k[0]
    unrolled = K in _STREAM_UNROLLED and all(x in (1, K) for x in k[1:])
    return _STREAM_ITEMS if unrolled else 1


def _ana_bands(k) -> int:
    """In-plane bands of a streamed analysis with taps ``k`` per slot (the
    template parameter G of ``stream_ana``): 2 per halo among slots 1 and
    2, so 4 in 3D and 2 in 2D and the lead stage."""
    return (2 if k[1] > 1 else 1) * (2 if k[2] > 1 else 1)


def _ana_items(k, dtype=torch.float32) -> int:
    """Plane elements per thread of a streamed analysis (``ana_items`` in
    the source): where the taps are unrolled, the most of 4, 2, 1 whose
    register ring of ``k[0] x G x items`` compute words fits
    ``_ANA_RING_REGS`` 32-bit registers; else 1."""
    if _stream_items(k) == 1:
        return 1
    regs = k[0] * _ana_bands(k) * _word(dtype) // 4
    return next(i for i in (4, 2, 1) if i * regs <= _ANA_RING_REGS or i == 1)


def _stream_smem(k, t, dtype, stages=None, bands=1) -> int:
    """Dynamic shared memory of a streamed launch (``stream_layout`` in the
    source), bytes: the window rows' input offsets (8 bytes a row);
    ``stages`` window buffers of ``t[1] + k[1] - 1`` rows in the storage
    type, each row padded to whole 16-byte pieces; the slot-2 intermediate
    when slots 1 and 2 both have a halo, ``(bands + 1) // 2`` slices of it;
    the ring of ``k[0]`` planes of ``bands`` bands where the taps are not
    unrolled. ``bands``: the in-plane bands one walk of an analysis keeps
    (``_walk_bands``), 1 for a synthesis. ``stages`` None: as many as the
    launch takes (``stream_stages``: the most, up to ``_STREAM_MAX_STAGES``,
    that fit the budget, at least 2)."""
    if stages is None:
        stages = _STREAM_MAX_STAGES
        while stages > 2 and _stream_smem(k, t, dtype, stages, bands) > _STREAM_SMEM_BUDGET:
            stages -= 1
    store, word = torch.empty((), dtype=dtype).element_size(), _word(dtype)
    vec = 16 // store

    def round16(b):
        return -(-b // 16) * 16

    rows = t[1] + k[1] - 1
    ws = -(-(t[2] + k[2] - 1 + vec - 1) // vec) * vec
    win = round16(rows * ws * store)
    q = round16((bands + 1) // 2 * rows * t[2] * word) if k[1] > 1 and k[2] > 1 else 0
    ring = k[0] * bands * t[1] * t[2] * word if _stream_items(k) == 1 else 0
    return round16(rows * 8) + stages * win + q + ring


def _walk_bands(k, t, dtype=torch.float32):
    """The in-plane bands one walk of a streamed analysis keeps (``gw``):
    all ``G`` where the taps are unrolled (the ring is in registers); else
    the most of ``G``, ``G/2``, ``G/4`` whose shared-memory ring fits the
    budget beside two window buffers, the chunk walked ``G / gw`` times;
    None if not even one band fits."""
    G = _ana_bands(k)
    if _stream_items(k) > 1:
        return G
    for gw in (G, G // 2, G // 4):
        if gw >= 1 and _stream_smem(k, t, dtype, 2, gw) <= _STREAM_SMEM_BUDGET:
            return gw
    return None


def _stream_plan(n, k, dtype=torch.float32, kind="rec", items=1) -> tuple:
    """``(C, T1, T2)`` of a streamed launch over the 3-slot view ``n``
    with taps ``k``: the synthesis (``kind`` "rec", "lead") or the analysis
    ("dec", "lead_dec"). A plane tile of ``T1 x T2 = 256 * items`` outputs
    on slots 1 and 2 (``items`` the synthesis's ``_stream_items`` or the
    analysis's ``_ana_items``; ``T2`` a power of two, ``_STREAM_T2[kind]``
    for the synthesis and ``256 * items / _ANA_T1`` for the analysis where
    the plane is that wide, wider where slot 1 is short; one row when slot 1
    passes through; where slot 1 is a pass-through of extent > 1, the
    multilevel kernels' folded batch, the plane's whole width where the
    tile's rows cover the items, for its rows carry no halo), whose shared
    memory fits ``_STREAM_SMEM_BUDGET``
    (the analysis's with one band a walk at least, ``_walk_bands``; its
    other widths are tried from ``T2`` down, which shrinks the window's
    halo rows), and a chunk of ``C`` outputs along slot 0 that keeps the
    launch of ``items`` such views (the multilevel kernels' 3D batch) within
    one wave of ``_STREAM_CTAS`` CTAs where the columns leave room (a
    second, part-filled wave cost more than the larger chunk's fewer halo
    planes), but at least ``K0`` (a chunk reads ``C + K0 - 1`` planes)."""
    ana = kind in _ANALYSIS
    tt = _THREADS * (_ana_items(k, dtype) if ana else _stream_items(k))
    if n[1] == 1:
        cands = [tt]
    else:
        wide = _pow2_at_least(n[2])
        if k[1] > 1:  # rows with a halo: the kind's preferred width
            wide = min(tt // _ANA_T1 if ana else _STREAM_T2[kind], wide)
        t2 = min(max(min(wide, tt), tt // _pow2_at_least(n[1])), tt)
        others = [1 << i for i in range(tt.bit_length()) if 1 << i != t2]
        if ana:
            others = sorted(others, key=lambda c: (c > t2, -c if c < t2 else c))
        cands = [t2] + others
    fits = [t2 for t2 in cands
            if (_walk_bands(k, (1, tt // t2, t2), dtype) is not None if ana
                else _stream_smem(k, (1, tt // t2, t2), dtype) <= _STREAM_SMEM_BUDGET)]
    if not fits:
        raise NotImplementedError(
            f"filters of lengths {list(k)} do not fit the streamed "
            f"{'analysis' if ana else 'synthesis'}'s shared memory")
    t2 = fits[0]
    t1 = tt // t2
    cols = -(-n[1] // t1) * -(-n[2] // t2) * items
    chunks = max(1, _STREAM_CTAS // cols)
    return (max(-(-n[0] // chunks), min(n[0], k[0])), t1, t2)


def _plane_whole(n, t, pad) -> bool:
    """Whether a plane-body plan's tile spans slot 2 (``plane_whole``): a
    window is then whole input rows, copied in runs of rows."""
    return not pad[2] and t[2] >= n[2]


def _plane_smem(n, k, t, dtype, stages, pad=(False,) * 3, windows=4) -> int:
    """Dynamic shared memory of a plane-body launch (``plane_layout`` in
    the source; ``plane_ana_layout`` with ``windows`` 1), bytes: ``stages``
    stage buffers of ``windows`` windows (the synthesis's four band
    windows, the analysis's one) of ``t[1] + k[1] - 1`` rows in the storage
    type (whole input rows where the tile spans slot 2, else the tile's
    columns and halo, shifted, in whole 128 bytes); then Q, two stage
    parities x two halves x ``t[1]`` rows in the compute type, each row long
    enough for the vector reads of its last thread; and 128 bytes to align
    the buffers."""
    store, word = torch.empty((), dtype=dtype).element_size(), _word(dtype)
    vec, vq, ni = 16 // store, 16 // word, _PLANE_ITEMS[word]
    if _plane_whole(n, t, pad):
        ws = n[2]
    else:
        row = _PLANE_ALIGN // store
        ws = -(-(t[2] + k[2] - 1 + vec - 1) // row) * row
    qs = t[2] - ni + -(-(ni + k[2] - 1) // vq) * vq
    return (_PLANE_ALIGN + stages * windows * (t[1] + k[1] - 1) * ws * store
            + 4 * t[1] * qs * word)


def _plane_stages(n, k, t, dtype, pad=(False,) * 3, windows=4) -> int:
    """The stage buffers of a plane-body plan (``plane_stages``,
    ``plane_ana_stages`` with ``windows`` 1): the most, up to
    ``_PLANE_MAX_STAGES``, that fit ``_PLANE_SMEM``; 0 where two do not."""
    for stages in range(_PLANE_MAX_STAGES, 1, -1):
        if _plane_smem(n, k, t, dtype, stages, pad, windows) <= _PLANE_SMEM:
            return stages
    return 0


def _plane_plan(n, k, dtype=torch.float32, pad=(False,) * 3):
    """``(C, T1, T2)`` of a plane-body launch over the 3D view ``n`` with
    taps ``k`` and halo-padded flags ``pad`` (``csrc/nddwt_plane.cuh``), or
    None where no plane tile's stages fit: a tile of ``T1 x T2 =
    _PLANE_THREADS * NI`` outputs (``T2`` a power of two, ``T1`` a multiple
    of ``_PLANE_ROWS`` up to ``_PLANE_T1_MAX``, at most ``_PLANE_ROUNDS``
    slot-1 items a thread): the tile of the most rows that spans slot 2
    where one does (whole rows: a few large copies a window instead of one
    or more a row), else ``_PLANE_T1`` rows, other tiles tried from there;
    and the chunk ``C`` along slot 0 that ``_plane_chunk`` gives."""
    return _plane_tile(tuple(n), tuple(k), dtype, tuple(bool(p) for p in pad))


def _plane_ana_plan(n, k, dtype=torch.float32, pad=(False,) * 3):
    """``(C, T1, T2)`` of an analysis plane-body launch
    (``plane_ana_kernel``), or None where no plane tile's stages fit: as
    ``_plane_plan``'s, with a tile of ``T1 x T2 = _PLANE_THREADS / 2 * NI``
    outputs (each half of the CTA one slot-1 band), ``T1`` any multiple of
    ``_PLANE_ANA_ROWS`` (every tile ``plane_ana_takes`` accepts) and one
    window a stage."""
    return _plane_tile(tuple(n), tuple(k), dtype, tuple(bool(p) for p in pad), True)


@functools.lru_cache(maxsize=None)
def _plane_tile(n, k, dtype, pad, ana=False):
    """``_plane_plan`` (``_plane_ana_plan`` where ``ana``) of tuples,
    computed once per view."""
    word = _word(dtype)
    ni = _PLANE_ITEMS[word]
    rw, tt = (_PLANE_ANA_ROWS, _PLANE_THREADS // 2 * ni) if ana else (_PLANE_ROWS,
                                                                      _PLANE_THREADS * ni)
    halves = 1 if ana else 2  # slot-1 items a row group and column

    def cols(t):  # the slot-1 pass's columns
        return n[2] if _plane_whole(n, t, pad) else t[2] + k[2] - 1

    tiles = [(1, t1, tt // t1) for t1 in range(rw, (tt // ni if ana else _PLANE_T1_MAX) + 1, rw)
             if tt % t1 == 0 and (tt // t1) & (tt // t1 - 1) == 0 and tt // t1 >= ni]
    tiles = [t for t in tiles
             if halves * (t[1] // rw) * cols(t) <= _PLANE_ROUNDS * _PLANE_THREADS]
    whole = [t[1] for t in tiles if _plane_whole(n, t, pad)]
    want = max(whole) if whole else _PLANE_T1
    tiles.sort(key=lambda t: (t[1] > want, abs(t[1] - want)))
    for t in tiles:
        if _plane_stages(n, k, t, dtype, pad, 1 if ana else 4):
            units = -(-n[1] // t[1]) * -(-n[2] // t[2])
            return (_plane_chunk(n[0], k[0], units), t[1], t[2])
    return None


def _plane_chunk(n0, K, units) -> int:
    """The chunk ``C`` along slot 0 (of extent ``n0``, ``K`` taps) of a
    plane launch of ``units`` tiles a chunk: the one, of at least ``K``
    outputs (or ``n0``), that minimises the waves of one CTA an SM
    (``_STREAM_CTAS // 2``) times the planes a CTA reads, ``C + K - 1``."""
    wave = _STREAM_CTAS // 2

    def cost(C):
        return -(-units * -(-n0 // C) // wave) * (C + K - 1)

    return min(range(min(n0, K), n0 + 1), key=lambda C: (cost(C), -C))


def _plane_class(n, k, pad, dtype, ptrs) -> bool:
    """Whether a level launch over the view ``n`` with taps ``k`` and
    halo-padded flags ``pad``, reading arrays at the device addresses
    ``ptrs``, is of the plane bodies' class: a 3D view with one length of
    ``_STREAM_UNROLLED`` on every slot and input rows that start on 16 bytes
    (the slot-2 input extent a multiple of 16 bytes and every array 16-byte
    aligned)."""
    K = k[0]
    m2 = n[2] + (k[2] - 1 if pad[2] else 0)
    return (K in _STREAM_UNROLLED and k[1] == K and k[2] == K
            and not m2 % (16 // dtype.itemsize) and not any(p % 16 for p in ptrs))


def _rec_body(n, k, pad, dtype, ptrs) -> str:
    """The body of an ``nddwt_rec_level`` launch (``plane_takes`` in the
    source): "plane" for a view of the plane bodies' class
    (``_plane_class``) with a plane plan that fits; "window"
    otherwise."""
    if not _plane_class(n, k, pad, dtype, ptrs):
        return "window"
    return "plane" if _plane_plan(n, k, dtype, pad) is not None else "window"


def _dec_body(n, k, pad, dtype, ptrs) -> str:
    """The body of an ``nddwt_dec_level`` launch reading its input at the
    device address ``ptrs[0]`` (``plane_ana_takes`` in the source): "plane"
    for a view of the plane bodies' class (``_plane_class``) with an
    analysis plane plan that fits; "window" otherwise."""
    if not _plane_class(n, k, pad, dtype, ptrs):
        return "window"
    return "plane" if _plane_ana_plan(n, k, dtype, pad) is not None else "window"


def _stream_view(shape, taps, pad):
    """The 3-slot view ``nddwt_rec_level`` and ``nddwt_dec_level`` stream
    over, slot 0 streamed: ``(n0, n1, n2)`` for a 3D level, ``(n0, 1,
    n1)`` for a 2D one (the middle slot passes through); per slot the
    extent, the taps (None: pass-through), the band bit and the halo-padded
    flag."""
    if len(shape) == 3:
        return list(shape), list(taps), [0, 1, 2], list(pad)
    return [shape[0], 1, shape[1]], [taps[0], None, taps[1]], [0, 0, 1], \
        [pad[0], False, pad[1]]


def _level_stream_view(shape, taps, dtype, pad, rec: bool):
    """The view geometry ``(n, k, left, bit, pad, tap_array)`` of one
    streamed level launch whose output has ``shape`` (``pad``: its
    halo-padded axes), without the plan: ``_stream_view``, the halos
    (``halo_widths``) and the taps in the compute type, reversed for the
    synthesis."""
    pad = _padded_flags(pad, len(shape))
    n, slot_taps, bit, vpad = _stream_view(shape, taps, pad)
    k = [1 if t is None else int(np.shape(t)[1]) for t in slot_taps]
    if max(k) > _MAX_TAPS:
        raise NotImplementedError(f"filters longer than {_MAX_TAPS} taps")
    if any(K > m and not p for K, m, p in zip(k, n, vpad)):
        raise ValueError(f"filters of lengths {k} are longer than the axes {n}")
    left = [0 if t is None else halo_widths([t], rec)[0][0] for t in slot_taps]
    return n, k, left, bit, vpad, _tap_array(slot_taps, rec, _compute_dtype(dtype))


def dec_stream_args(approx, shape, taps, padded=None):
    """The view geometry of one ``nddwt_dec_level`` launch reading
    ``approx`` into bands of ``shape`` (``_level_stream_view``'s: the
    analysis halos, the taps as given) with the plan of the body the launch
    takes (``_dec_body``: "plane", ``_plane_ana_plan``; "window",
    ``_stream_plan``, whose walk takes ``_walk_bands`` bands), and that
    body, built the same on any device. ``ops/stream_ref.py`` replays a
    launch from these."""
    dtype = approx.dtype
    n, k, left, bit, vpad, arr = _level_stream_view(shape, taps, dtype, padded, rec=False)
    body = _dec_body(n, k, vpad, dtype, [approx.data_ptr()])
    t = (_plane_ana_plan(n, k, dtype, vpad) if body == "plane"
         else _stream_plan(n, k, dtype, "dec"))
    return (n, k, t, left, bit, vpad, arr), body


def rec_stream_args(y, approx, band_src, taps, padded=None):
    """Everything one ``nddwt_rec_level`` launch is given, built the same
    on any device: the output shape, the band-source table (``2^d``
    entries, ``_band_indices``), the view geometry (``_level_stream_view``'s:
    the synthesis halos, the taps reversed) with the plan of the body the
    launch takes (``_rec_body``: "plane", ``_plane_plan``; "window",
    ``_stream_plan``), and that body. ``ops/stream_ref.py`` replays a launch
    from these."""
    in_shape = tuple(y.shape[1:])
    if len(in_shape) not in (2, 3) or len(taps) != len(in_shape):
        raise NotImplementedError(
            f"the per-level CUDA kernels take 2D and 3D arrays, got "
            f"{len(in_shape)}D (1D: rec1_level; 4D: the stage kernels)"
        )
    pad = _padded_flags(padded, len(in_shape))
    shape = _unpadded_shape(in_shape, taps, pad, "band array")
    idx = _band_indices(band_src, 2 ** len(shape), y, approx, in_shape)
    n, k, left, bit, vpad, arr = _level_stream_view(shape, taps, y.dtype, pad, rec=True)
    ptrs = [y.data_ptr()] + ([approx.data_ptr()] if -1 in idx else [])
    body = _rec_body(n, k, vpad, y.dtype, ptrs)
    t = (_plane_plan(n, k, y.dtype, vpad) if body == "plane"
         else _stream_plan(n, k, y.dtype, "rec"))
    return shape, idx, (n, k, t, left, bit, vpad, arr), body


def rec_level(y, approx, band_src, taps, scale, padded=None, out=None):
    """One synthesis level (contract of ``level_ref.rec_level_ref``): band
    ``b`` is ``y[i]`` for ``band_src[b] == ("y", i)`` or ``approx`` for
    ``("a", 0)``; returns ``scale *`` the adjoint, shaped ``y.shape[1:]``,
    written into ``out`` when given (``_output``).
    On the card it streams slot 0 (``rec_stream_args``: axis 0 of a 2D or
    3D array) on the body ``_rec_body`` names, with that body's plan, and
    counts the body in the counter ``nddwt.rec_level.body.plane`` or
    ``.window`` (``tracing``; not in ``launch_counts``).

    ``padded`` (one flag per axis): the halo-padded mode, which replaces
    the concat and slab "valid" modes of ``_fused_rec_level``
    (``non_decimated_wavelets_tpu/ops/pallas_kernels.py:1468``; TPU kernel
    table row 23): on a flagged axis ``y`` and ``approx`` carry ``K//2``
    rows of the left ring neighbour in front and ``K//2 - 1`` of the right
    one behind (``halo_widths``), and the output drops them."""
    if not y.is_cuda:
        return _into(out, rec_level_ref(y, approx, band_src, taps, scale, padded))
    with tracing.span("nddwt.launch.nddwt_rec_level"):
        check_array("y", y)
        shape, idx, (n, k, t, left, bit, pad, arr), body = rec_stream_args(
            y, approx, band_src, taps, padded)
        if -1 in idx:
            check_array("approx", approx, y)
        else:
            approx = y
        out = _output(out, shape, y)
        lib = load()
        with torch.cuda.device(y.device):
            err = lib.nddwt_rec_level(
                y.data_ptr(), approx.data_ptr(), out.data_ptr(),
                DTYPE_CODE[y.dtype], _ints(n), _ints(k), _ints(t), _ints(left),
                _ints(bit), _taps_ptr(arr),
                (ctypes.c_longlong * 8)(*(idx + [-1] * (8 - len(idx)))),
                float(scale), _ints(pad), int(body == "plane"),
                torch.cuda.current_stream().cuda_stream,
            )
        raise_on(lib, err, "nddwt_rec_level")
        _count("nddwt_rec_level", pad)
        tracing.count(f"nddwt.rec_level.body.{body}", 1)
    return out


# --------------------------------------------------------------- 4D stages
#
# A stage is one launch over a 3-slot view of a 3D or 4D array with a halo
# on two slots: the lane stage sees (n0*n1, n2, n3) — (n0*n1, n2, 1) for a
# 3D array — with halos on slots 1 and 2; the lead stage sees
# (n0, n1, n2*n3) with halos on slots 0 and 1. The remaining slot passes
# through (one tap of 1.0).


def _stage_slots(shape, taps, lane: bool):
    """The stage's view extents and taps per slot (None: pass-through)."""
    shape = tuple(int(s) for s in shape)
    if lane:
        n = [shape[0] * shape[1], shape[2], shape[3] if len(shape) == 4 else 1]
        return n, [None, taps[2], taps[3] if len(shape) == 4 else None]
    return [shape[0], shape[1], int(np.prod(shape[2:]))], [taps[0], taps[1], None]


def _stage_words(t, k, adj: bool) -> int:
    """Shared-memory words of a lane stage launch: the halo'd window, the
    intermediate after the slot-1 pass, and an adjoint's output tile."""
    e = [t[a] + k[a] - 1 for a in range(3)]
    w = e[0] * e[1] * e[2] + e[0] * t[1] * e[2]
    return w + (t[0] * t[1] * t[2] if adj else 0)


@functools.lru_cache(maxsize=None)
def _stage_tiles(n: tuple, k: tuple, adj: bool, word: int = 4):
    """The tile body's lane-stage output tile: over power-of-two tiles
    (capped by the extents) of at most 8192 outputs whose shared memory
    (``word`` bytes a word) fits ``_LANE_SMEM_BUDGET``, the fewest 32-byte
    sectors of window loaded per output (rows run along the last slot of
    extent > 1); at equal cost the smaller tile of at least one output per
    thread. None if no tile fits (db38 in float64)."""
    sizes = [sorted({min(2**i, m) for i in range(14)}) for m in n]
    best = None
    for t in itertools.product(*sizes):
        out = t[0] * t[1] * t[2]
        if out > 8192 or word * _stage_words(t, k, adj) > _LANE_SMEM_BUDGET:
            continue
        e = [t[a] + k[a] - 1 for a in range(3)]
        rows, run = (e[0], e[1]) if n[2] == 1 else (e[0] * e[1], e[2])
        key = (rows * -(-run // 8) * 8 / out, out < _THREADS, out)
        if best is None or key < best[0]:
            best = (key, t)
    return None if best is None else best[1]


def _lane_smem(n, k, plan, dtype=torch.float32, adj=False) -> int:
    """Dynamic shared memory of a lane body launch (``lane_smem`` in
    ``csrc/nddwt_lane.cuh``), bytes: ``stages`` unit buffers, each holding
    one window per input array (1, or the 4 lane bands of an adjoint, 2 in
    3D) of the unit's ``R x Ew x T`` elements in the storage type, rounded
    to 16 bytes, plus 3 x 16 bytes of slack for the pieces' offsets; then
    the two halves of Q in the compute type (the analysis's T pass of every
    window row, the adjoint's Z adjoints of every output row; none in 3D).
    ``plan = (R, Zc, stages)``; ``Zc >= Z``: units of ``R`` whole slabs,
    else chunks of ``Zc`` outputs with ``Zc + K1 - 1`` window rows (and one
    slab a unit)."""
    Z, T = n[1], n[2]
    R, Zc, stages = plan
    whole = Zc >= Z
    R = R if whole else 1
    ew = Z if whole else Zc + k[1] - 1
    store = torch.empty((), dtype=dtype).element_size()
    vec = 16 // store
    wb = -(-R * ew * T // vec) * vec + 3 * vec
    nin = (4 if k[2] > 1 else 2) if adj else 1
    q = 0 if k[2] == 1 else R * (min(Zc, Z) if adj else ew) * T
    return stages * nin * wb * store + 2 * q * _word(dtype)


@functools.lru_cache(maxsize=None)
def _lane_plan(n: tuple, k: tuple, dtype=torch.float32, adj: bool = False):
    """The lane body's plan ``(R, Zc, stages)`` over the lane view ``n =
    (X*Y, Z, T)`` with taps ``k``, or None where none fits: where even one
    Z row chunk (K1 rows of the whole T row of every input array, 4 lane
    bands in an adjoint, one buffer) overflows ``_STREAM_SMEM_BUDGET`` (for
    the adjoint a T row beyond 1504 at db4 in float32, or 83 at db38 in
    float64). That class runs on the tile body (``_stage_geometry``). In
    order of preference, the first that fits:

    1. units of ``R`` whole slabs (``R`` of at most ``_LANE_UNIT``
       elements an array), with 4, 3, 2 or 1 unit buffers, two CTAs an SM
       (``_LANE_TWO_PER_SM``; with one buffer the other CTA's passes hide
       a CTA's copy: at (128, 128, 128, 32) db4 f32 on an H100 the
       adjoint's whole slabs with one buffer were faster than with two at
       one CTA an SM, and than chunks of Z): the fewest slabs on the
       busiest CTA of the wave of ``_STREAM_CTAS``, then the most buffers,
       then the largest ``R`` (at 128^3 db20, units of 15 slabs left 37 of
       264 CTAs a fifth unit and took 16 % longer than units of 32);
    2. chunks of ``Zc`` outputs along Z (Z cut into the fewest equal
       chunks whose windows fit; a window of ``Zc + K1 - 1`` rows, fewer
       than Z and at most ``2 Zc``), 4 to 1 buffers, two CTAs an SM (the
       larger chunk before more buffers: the float64 adjoint at (128, 128,
       128, 32) db4 took 1.56 ms in chunks of 64 with one buffer, 1.90 in
       chunks of 32 with two);
    3. one whole slab a unit, 4 to 2 buffers, in ``_STREAM_SMEM_BUDGET``;
    4. chunks (a window of fewer than Z rows) with 4 to 2 buffers, then one
       whole slab with one buffer (no copy in flight), then chunks (a
       window of at most Z rows) with one buffer, in that budget."""
    n0, Z, T = n
    K1 = k[1]

    def first(plans, budget):
        return next((t for t in plans if _lane_smem(n, k, t, dtype, adj) <= budget), None)

    def chunks(stage_counts, rows_at_most):
        for nch in range(2, Z + 1):
            zc = -(-Z // nch)
            if zc + K1 - 1 <= rows_at_most(zc):
                yield from ((1, zc, st) for st in stage_counts)

    def busiest_first(t):  # the busiest CTA's slabs, then buffers, then R
        units = -(-n0 // t[0])
        return (-(-units // _STREAM_CTAS) * t[0], -t[2], -t[0])

    deep = (4, 3, 2)
    whole = sorted(((r, Z, st) for r in range(1, max(1, _LANE_UNIT // (Z * T)) + 1)
                    for st in deep + (1,)), key=busiest_first)
    return (first(whole, _LANE_TWO_PER_SM)
            or first(chunks(deep + (1,), lambda zc: min(2 * zc, Z - 1)), _LANE_TWO_PER_SM)
            or first(((1, Z, st) for st in deep), _STREAM_SMEM_BUDGET)
            or first(chunks(deep, lambda zc: Z - 1), _STREAM_SMEM_BUDGET)
            or first([(1, Z, 1)], _STREAM_SMEM_BUDGET)
            or first(chunks((1,), lambda zc: Z), _STREAM_SMEM_BUDGET))


def _stage_geometry(shape, taps, lane: bool, adj: bool, dtype=torch.float32,
                    padded=(False, False)):
    """ctypes arguments of one stage launch on ``dtype`` arrays: view
    extents, taps, plan and left halo per slot (``halo_widths``), and the
    taps in the compute type (reversed for an adjoint, whose halo is
    mirrored: K//2 left instead of K//2 - 1); and the body the launch runs.
    The lane stages run the lane body ("lane") on its plan ``(R, Zc,
    stages)`` (``_lane_plan``), or, for the class no plan fits, the tile
    body ("tile") on its tile (``_stage_tiles``; NotImplementedError where
    none fits that body's budget either); the lead stages the streamed
    body ("window") on its plan ``(C, T1, T2)`` (``_stream_plan``; the
    analysis takes ``_walk_bands`` bands a walk). ``padded``: the lead
    stage's halo-padded slots 0 and 1, which may be shorter than their
    filters."""
    n, slot_taps = _stage_slots(shape, taps, lane)
    k = [1 if t is None else int(np.shape(t)[1]) for t in slot_taps]
    if max(k) > _MAX_TAPS:
        raise NotImplementedError(f"filters longer than {_MAX_TAPS} taps")
    pad = tuple(padded) + (False,) * (3 - len(padded))
    if any(K > m and not p for K, m, p in zip(k, n, pad)):
        raise ValueError(f"filters of lengths {k} are longer than the axes {n}")
    left = [0 if t is None else halo_widths([t], adj)[0][0] for t in slot_taps]
    if not lane:  # the lead stages stream X (csrc/nddwt_stream.cuh)
        t, body = _stream_plan(n, k, dtype, "lead" if adj else "lead_dec"), "window"
    else:
        t, body = _lane_plan(tuple(n), tuple(k), dtype, adj), "lane"
        if t is None:
            t, body = _stage_tiles(tuple(n), tuple(k), adj, _word(dtype)), "tile"
            if t is None:
                raise NotImplementedError(
                    f"a lane stage of {k[1]}-tap filters on the view {tuple(n)} "
                    f"in {dtype} fits neither the lane body nor the tile body")
    return (_ints(n), _ints(k), _ints(t), _ints(left),
            _tap_array(slot_taps, adj, _compute_dtype(dtype))), body


def stage_route(shape, taps, dtype=torch.float32) -> bool:
    """Whether a level of this shape runs on the stage kernels: every 4D
    level, and a 3D level whose filters overflow the tile the per-level
    kernels had before they streamed: where even its one-output synthesis
    tile (the window of ``K0 K1 K2`` words, the intermediates of ``K1 K2``
    and ``K2``, and the output) at the word size of ``dtype`` takes more
    than 100 KiB, two CTAs' share of an SM, whatever the shape (db15 and up
    in float32 and bfloat16, db12 and up in float64). ``NDDWT.route`` asks
    it; the rule is kept so that no route moved when that tile went."""
    if len(shape) != 3:
        return len(shape) == 4
    k0, k1, k2 = (int(np.shape(t)[1]) for t in taps)
    return _word(dtype) * (k0 * k1 * k2 + k1 * k2 + k2 + 1) > 100 * 1024


def _check_stage_array(name, t, taps, lead: int = 0):
    """A stage operand: ``lead`` leading band axes, then a 3D or 4D array
    with one (2, K) tap array per axis."""
    if t.ndim - lead not in (3, 4) or len(taps) != t.ndim - lead:
        raise NotImplementedError(
            f"the stage kernels take 3D and 4D arrays with one filter per "
            f"axis, got {name} of shape {tuple(t.shape)} with {len(taps)} filters"
        )


def lane_dec(x, taps):
    """Lane stage analysis (contract of ``level4_ref.lane_dec_ref``):
    ``(*s)`` -> the ``2^(d-2)`` lane bands ``(nl, *s)``."""
    _check_stage_array("x", x, taps)
    if not x.is_cuda:
        return lane_dec_ref(x, taps)
    with tracing.span("nddwt.launch.nddwt_lane_dec"):
        check_array("x", x)
        temp = torch.empty((2 ** (x.ndim - 2),) + tuple(x.shape), dtype=x.dtype,
                           device=x.device)
        (n, k, t, left, arr), body = _stage_geometry(x.shape, taps, True, False, x.dtype)
        lib = load4()
        with torch.cuda.device(x.device):
            err = lib.nddwt_lane_dec(
                x.data_ptr(), temp.data_ptr(), DTYPE_CODE[x.dtype], n, k, t, left,
                _taps_ptr(arr), int(body == "tile"),
                torch.cuda.current_stream().cuda_stream,
            )
        raise_on(lib, err, "nddwt_lane_dec")
        launch_counts["nddwt_lane_dec"] += 1
    return temp


def lead_dec(temp, big, band_off, taps, lam=0.0, final=False, padded=None):
    """Lead stage analysis (contract of ``level4_ref.lead_dec_ref``): the
    ``4 nl - 1`` details into ``big[band_off:]``, shrunk by ``lam``; the
    approximation into ``big[0]`` when ``final``, else returned.

    ``padded`` (flags for the lead axes 0 and 1): the halo-padded mode,
    which replaces the concat and slab "valid" modes of ``_lead_dec_call``
    (``non_decimated_wavelets_tpu/ops/pallas_4d.py:592``, with
    ``_lane_edge_copies`` :432; TPU kernel table row 23): on a flagged
    axis ``temp`` carries ``K//2 - 1`` rows of the left ring neighbour in
    front and ``K//2`` of the right one behind (``halo_widths``), and the
    bands have the extent of ``big``."""
    _check_stage_array("temp", temp, taps, lead=1)
    pad = _padded_flags(padded, 2)
    shape, nb = tuple(big.shape[1:]), 4 * temp.shape[0]
    if (temp.shape[0] != 2 ** (len(shape) - 2)
            or _padded_shape(shape, taps, pad + (False,) * (len(shape) - 2))
            != tuple(temp.shape[1:])
            or not 1 <= band_off <= big.shape[0] - nb + 1):
        raise ValueError(
            f"band array {tuple(big.shape)} cannot take the {nb - 1} detail "
            f"bands of lane bands {tuple(temp.shape)} (halo-padded on {pad}) "
            f"at offset {band_off}"
        )
    if not temp.is_cuda:
        return lead_dec_ref(temp, big, band_off, taps, lam, final, pad)
    with tracing.span("nddwt.launch.nddwt_lead_dec"):
        check_array("temp", temp)
        check_array("big", big, temp)
        out = big[0] if final else torch.empty(shape, dtype=temp.dtype,
                                               device=temp.device)
        (n, k, t, left, arr), _ = _stage_geometry(shape, taps, False, False, temp.dtype, pad)
        lib = load4()
        with torch.cuda.device(temp.device):
            err = lib.nddwt_lead_dec(
                temp.data_ptr(), big.data_ptr(), out.data_ptr(),
                DTYPE_CODE[temp.dtype], n, k, t, left, _taps_ptr(arr),
                int(temp.shape[0]), int(band_off), float(lam),
                _walk_bands(list(k), list(t), temp.dtype), _ints(pad + (False,)),
                torch.cuda.current_stream().cuda_stream,
            )
        raise_on(lib, err, "nddwt_lead_dec")
        _count("nddwt_lead_dec", pad)
    return None if final else out


def lead_adj(y, approx, band_src, taps, padded=None):
    """Lead stage synthesis (contract of ``level4_ref.lead_adj_ref``): the
    ``2^d`` bands named by ``band_src`` -> the partial lane bands
    ``(nl, *s)``.

    ``padded`` (flags for the lead axes 0 and 1): the halo-padded mode,
    which replaces the concat and slab "valid" modes of ``_lead_adj_call``
    (``non_decimated_wavelets_tpu/ops/pallas_4d.py:882``; TPU kernel table
    row 23): on a flagged axis ``y`` and ``approx`` carry ``K//2`` rows of
    the left ring neighbour in front and ``K//2 - 1`` of the right one
    behind (``halo_widths``), and the partial bands drop them."""
    _check_stage_array("y", y, taps, lead=1)
    pad = _padded_flags(padded, 2)
    in_shape = tuple(y.shape[1:])
    shape = _unpadded_shape(in_shape, taps, pad + (False,) * (len(in_shape) - 2),
                            "band array")
    idx = _band_indices(band_src, 2 ** len(shape), y, approx, in_shape)
    if not y.is_cuda:
        return lead_adj_ref(y, approx, band_src, taps, pad)
    with tracing.span("nddwt.launch.nddwt_lead_adj"):
        check_array("y", y)
        if -1 in idx:
            check_array("approx", approx, y)
        else:
            approx = y
        nl = 2 ** (len(shape) - 2)
        partial = torch.empty((nl,) + shape, dtype=y.dtype, device=y.device)
        (n, k, t, left, arr), _ = _stage_geometry(shape, taps, False, True, y.dtype, pad)
        lib = load4()
        with torch.cuda.device(y.device):
            err = lib.nddwt_lead_adj(
                y.data_ptr(), approx.data_ptr(), partial.data_ptr(),
                DTYPE_CODE[y.dtype], n, k, t, left, _taps_ptr(arr),
                (ctypes.c_longlong * 16)(*(idx + [-1] * (16 - len(idx)))), nl,
                _ints(pad + (False,)), torch.cuda.current_stream().cuda_stream,
            )
        raise_on(lib, err, "nddwt_lead_adj")
        _count("nddwt_lead_adj", pad)
    return partial


def lane_adj(partial, taps, scale, out=None):
    """Lane stage synthesis (contract of ``level4_ref.lane_adj_ref``):
    ``scale *`` the adjoint of the lane bands ``(nl, *s)`` -> ``(*s)``,
    written into ``out`` when given (``_output``)."""
    _check_stage_array("partial", partial, taps, lead=1)
    shape = tuple(partial.shape[1:])
    if partial.shape[0] != 2 ** (len(shape) - 2):
        raise ValueError(f"expected {2 ** (len(shape) - 2)} lane bands, got "
                         f"{partial.shape[0]}")
    if not partial.is_cuda:
        return _into(out, lane_adj_ref(partial, taps, scale))
    with tracing.span("nddwt.launch.nddwt_lane_adj"):
        check_array("partial", partial)
        out = _output(out, shape, partial)
        (n, k, t, left, arr), body = _stage_geometry(shape, taps, True, True, partial.dtype)
        lib = load4()
        with torch.cuda.device(partial.device):
            err = lib.nddwt_lane_adj(
                partial.data_ptr(), out.data_ptr(), DTYPE_CODE[partial.dtype],
                n, k, t, left, _taps_ptr(arr), float(scale), int(body == "tile"),
                torch.cuda.current_stream().cuda_stream,
            )
        raise_on(lib, err, "nddwt_lane_adj")
        launch_counts["nddwt_lane_adj"] += 1
    return out


# ---------------------------------------------------------------------- 1D


def _check_1d(name, t, taps, lead: int):
    if t.ndim != 1 + lead or len(taps) != 1:
        raise NotImplementedError(
            f"the 1D level kernels take 1D arrays with one filter, got {name} "
            f"of shape {tuple(t.shape)} with {len(taps)} filters"
        )


def _geometry1(taps, rec: bool, dtype):
    """The tap count and the (1, 2, kMaxTaps) taps of a 1D launch on
    ``dtype`` arrays (reversed for a synthesis)."""
    K = int(np.shape(taps[0])[1])
    if K > _MAX_TAPS:
        raise NotImplementedError(f"filters longer than {_MAX_TAPS} taps")
    return K, _tap_array(taps, rec, _compute_dtype(dtype))


def dec1_level(approx, big, band_off, taps, lam=0.0, final=False):
    """One 1D analysis level (contract of ``level_ref.dec_level_ref``):
    the detail into ``big[band_off]``, shrunk by ``lam``; the approximation
    into ``big[0]`` when ``final``, else returned."""
    _check_1d("approx", approx, taps, 0)
    if not approx.is_cuda:
        return dec_level_ref(approx, big, band_off, taps, lam, final)
    with tracing.span("nddwt.launch.nddwt_dec1_level"):
        check_array("approx", approx)
        check_array("big", big, approx)
        n = approx.shape[0]
        if tuple(big.shape[1:]) != (n,) or not 1 <= band_off < big.shape[0]:
            raise ValueError(
                f"band array {tuple(big.shape)} cannot take the detail band of "
                f"{(n,)} at offset {band_off}"
            )
        out = big[0] if final else torch.empty_like(approx)
        K, arr = _geometry1(taps, False, approx.dtype)
        lib = load1()
        with torch.cuda.device(approx.device):
            err = lib.nddwt_dec1_level(
                approx.data_ptr(), big[band_off].data_ptr(), out.data_ptr(),
                DTYPE_CODE[approx.dtype], n, K, K // 2 - 1, _taps_ptr(arr),
                float(lam), torch.cuda.current_stream().cuda_stream,
            )
        raise_on(lib, err, "nddwt_dec1_level")
        launch_counts["nddwt_dec1_level"] += 1
    return None if final else out


def rec1_level(y, approx, band_src, taps, scale, out=None):
    """One 1D synthesis level (contract of ``level_ref.rec_level_ref``):
    the two bands named by ``band_src`` (``("y", i)`` is ``y[i]``,
    ``("a", 0)`` is ``approx``); returns ``scale *`` the adjoint, ``(N,)``,
    written into ``out`` when given (``_output``)."""
    _check_1d("y", y, taps, 1)
    shape = tuple(y.shape[1:])
    idx = _band_indices(band_src, 2, y, approx, shape)
    if not y.is_cuda:
        return _into(out, rec_level_ref(y, approx, band_src, taps, scale))
    with tracing.span("nddwt.launch.nddwt_rec1_level"):
        check_array("y", y)
        if -1 in idx:
            check_array("approx", approx, y)
        a, d = (approx if i < 0 else y[i] for i in idx)
        out = _output(out, shape, y)
        K, arr = _geometry1(taps, True, y.dtype)
        lib = load1()
        with torch.cuda.device(y.device):
            err = lib.nddwt_rec1_level(
                a.data_ptr(), d.data_ptr(), out.data_ptr(), DTYPE_CODE[y.dtype],
                shape[0], K, K // 2, _taps_ptr(arr), float(scale),
                torch.cuda.current_stream().cuda_stream,
            )
        raise_on(lib, err, "nddwt_rec1_level")
        launch_counts["nddwt_rec1_level"] += 1
    return out


# ------------------------------------------------------------------ levels


def dec_levels(x, taps, level: int, lam: float = 0.0, out=None, *, stages: bool):
    """Multilevel analysis, ``(B, *s)``, written into ``out`` when given,
    on the per-level kernels: per level one ``dec1_level`` launch in 1D
    (``pallas_padded.dec_padded1``), one ``dec_level`` launch in 2D and 3D,
    or, on the stage route (``stages``, which ``NDDWT.route`` decides), a
    lane and a lead stage launch (``pallas_4d.dec4``). Level ``l`` writes
    its details at ``B - (2^d - 1)(l + 1)`` (the tail of
    ``pallas_kernels._dec_dispatch``), the last one its approximation into
    band 0."""
    nb = 2**x.ndim
    B = num_bands(x.ndim, level)
    big = out if out is not None else torch.empty(
        (B,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    one_level = dec1_level if x.ndim == 1 else dec_level
    approx = x
    for lvl in range(level):
        off, final = B - (nb - 1) * (lvl + 1), lvl == level - 1
        if stages:
            approx = lead_dec(lane_dec(approx, taps), big, off, taps, lam, final)
        else:
            approx = one_level(approx, big, off, taps, lam, final)
    return big


def rec_levels(y, taps, level: int, preserve_l2: bool, out=None, *, stages: bool):
    """Multilevel synthesis, ``(*s)``, written into ``out`` when given, on
    the per-level kernels: per level one ``rec1_level`` launch in 1D
    (``pallas_padded.rec_padded1``), one ``rec_level`` launch in 2D and 3D,
    or, on the stage route (``stages``), a lead and a lane stage adjoint
    (``pallas_4d.rec4``): band 0 comes from the previous level's output, the
    details from ``y[pos + b - 1]`` (the tail of
    ``pallas_kernels._rec_dispatch``). The last level's launch writes
    ``out``."""
    nb = 2 ** (y.ndim - 1)
    scale = 1.0 if preserve_l2 else 1.0 / nb
    level_kernel = rec1_level if y.ndim == 2 else rec_level

    def one_level(acc, src, lvl):
        dst = out if lvl == level - 1 else None
        if stages:
            return lane_adj(lead_adj(y, acc, src, taps), taps, scale, out=dst)
        return level_kernel(y, acc, src, taps, scale, out=dst)

    acc = one_level(None, [("y", b) for b in range(nb)], 0)
    pos = nb
    for lvl in range(1, level):
        acc = one_level(acc, [("a", 0)] + [("y", pos + b - 1) for b in range(1, nb)], lvl)
        pos += nb - 1
    return acc
