"""The one-launch CUDA kernels: bind and launch, under the JAX names.

``csrc/nddwt_flat.cu`` holds the two hand-written Hopper kernels that
replace ``non_decimated_wavelets_tpu/ops/pallas_flat.py`` (and
``pallas_resident.py``, whose three kernels compute a subset of the first):

* ``nddwt_flat_pair``: the whole multilevel analysis (``dec_flat``),
  synthesis (``rec_flat``), or analysis -> shrink details -> synthesis
  (``pair_flat``) of an array of any ndim up to ``MAX_DIM`` and any
  extents, in one launch; with a leading split re/im pair
  (``dec_split_flat``, ``rec_split_flat``, ``pair_split_flat``) whose
  shrink is the joint magnitude;
* ``nddwt_flat_iter``: N such sweeps in one launch (``chain_flat``), or a
  whole FISTA inpainting solve (``fista_flat``, ``fista_split_flat``) with
  the (lam, momentum) schedule on the device.

Both take float32, bfloat16 (float32 compute) and float64 arrays. Their
size limits are the port's own, measured on an H100 by
``chip_flat_crossover.py`` (``PERF.md``), counting a pair's two components.
``FLAT_MAX_NUMEL`` holds, for each route that the flat kernel stands in
for, the largest count at which a ``dec_rec`` on the flat kernel was no
slower than on that route, in float32 and float64 alike: the 1D kernels;
the stage kernels, which serve 4D and the 3D filters too long for the
level kernels' tile (db20); and, for 2D and 3D at db4 to db20 and two to
five levels, the multilevel kernels, which take those arrays up to
``multi.MULTI_MAX_NUMEL`` (2^22) wherever the flat kernel does not: the
largest count measured, which also bounds 5D and up (no other route).
``ITER_MAX_NUMEL`` is the largest count at which a whole FISTA solve in
one launch was no slower than the stepped route on the flat kernel (a pair
and a ``fista_step`` per iteration), and covers a 256^2 split solve; it is
within every ``FLAT_MAX_NUMEL`` entry.

A launch runs one pass per axis group, level and direction: each CTA
copies a tile's window (the tile and its halo on the group's axes) into
shared memory, in 16-byte pieces where the last extent allows, and runs
the level's band tree there. ``_flat_plan`` lays out the groups and the
tile and passes them to the kernel, which checks them;
``ops/stream_ref.flat_replay`` replays the same schedule on the CPU for
the tests.

Each wrapper launches its kernel for a CUDA tensor and raises if the
launch fails; for a CPU tensor it runs the plain version
(``ops/flat_ref.py``). Launches are counted in
``cuda_kernels.launch_counts``; while tracing is on, a launch's grid
barriers and window bytes in the counters ``flat_passes`` and
``flat_window_bytes`` (``_count_passes``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from ..oracle import num_bands
from . import cuda_kernels
from .flat_ref import flat_iter_ref, flat_pair_ref

MAX_DIM = 8  # kMaxDim in the source
# By the route the flat kernel stands in for; None: the level loops (the
# multilevel kernels), and 5D and up.
FLAT_MAX_NUMEL = {"1d": 2**20, "stage": 2**18, None: 2**22}
ITER_MAX_NUMEL = 2**18
_PAIR_MODES = {"dec": 0, "rec": 1, "pair": 2}
_ITER_MODES = {"chain": 3, "fista": 4}
PLAN_INTS = 1 + 2 * MAX_DIM + 2  # kPlanInts in the source
# The plan (csrc/nddwt_flat.cu): the most consecutive axes one pass takes
# (two, not three: a 64^3 db4 L3 pair took 0.209 ms at best in groups of
# two, 0.445 in one group of three, chip_ab_flat.py on an H100, PERF.md);
# the dynamic shared memory a CTA may take (227 KB less the static tap
# table, as the streamed bodies); the fewest elements a tile is cut to (one
# a thread), unless the array has fewer; and the cost model that picks the
# group size and the tile, fitted to chip_ab_flat.py's forced plans on an
# H100 (the 256^2 solve, the 64^3 pair and the families of --families):
# per pass a grid barrier and the pass's fill, a window copy's latency per
# wave of CTAs (two an SM where they fit), the copied bytes at an SM's
# share of the L2 rate, and the multiply-adds at an SM's rate, twice as
# slow where one CTA holds the SM; on the 132 SMs of an H100.
_FLAT_GROUP = 2
_FLAT_SMEM_BUDGET = 200 * 1024
_FLAT_TILE_MIN = 256
_FLAT_SMS = 132
_FLAT_BARRIER_US = 3.0
_FLAT_LATENCY_US = 1.5
_FLAT_SM_BYTES_PER_US = 30_000
_FLAT_SM_FMA_PER_US = {4: 25_000, 8: 12_500}


class FlatPlan(NamedTuple):
    """A launch's plan: the end axis of each axis group, the tile extent of
    each axis, the dynamic shared memory (bytes) and the units of the
    largest pass (the most CTAs a launch can use)."""
    ends: tuple
    tile: tuple
    smem: int
    units: int

    def ints(self):
        """The plan as the kernel takes it (``kPlanInts`` host ints)."""
        pad = (0,) * MAX_DIM
        return ((len(self.ends),) + (self.ends + pad)[:MAX_DIM]
                + (self.tile + pad)[:MAX_DIM] + (self.smem, self.units))


def _items(shape, batch: int) -> int:
    """The largest pass of a launch: 2^(d-1) partial bands of the pair."""
    return 2 ** max(len(shape) - 1, 0) * max(batch, 1) * int(np.prod(shape))


def _count(shape, dtype, batch: int):
    """The elements of a launch (a pair's two components counted), or None
    where no launch takes the array."""
    if (dtype not in cuda_kernels.DTYPE_CODE or not 1 <= len(shape) <= MAX_DIM
            or _items(shape, batch) >= 2**31):
        return None
    return max(batch, 1) * int(np.prod(shape))


def flat_limit(replaces=None) -> int:
    """The most elements (a pair's two components counted) of an array that
    take ``nddwt_flat_pair`` in place of the per-level route ``replaces``
    (``'1d'``, ``'stage'``, or None for the others and 5D and up): its
    entry of ``FLAT_MAX_NUMEL``. ``NDDWT.route`` names the route."""
    return FLAT_MAX_NUMEL.get(replaces, FLAT_MAX_NUMEL[None])


def flat_supported(shape, dtype, batch: int = 0, *, replaces=None) -> bool:
    """Whether ``nddwt_flat_pair`` takes ``dec``/``rec``/``dec_rec`` of
    ``shape`` (with a leading pair when ``batch`` is 2) in ``dtype`` in
    place of the per-level route ``replaces`` (``flat_limit``)."""
    n = _count(tuple(int(s) for s in shape), dtype, batch)
    return n is not None and n <= flat_limit(replaces)


def iter_supported(shape, dtype, batch: int = 0) -> bool:
    """Whether a chain or a FISTA solve of ``shape`` takes
    ``nddwt_flat_iter``."""
    n = _count(tuple(int(s) for s in shape), dtype, batch)
    return n is not None and n <= ITER_MAX_NUMEL


def _group_ends(ndim: int, size: int) -> tuple:
    """Consecutive groups of at most ``size`` axes: their end axes."""
    return tuple(min(ndim, e) for e in range(size, ndim + size, size))


def window_pitch(shape, k, tile, a0: int, a1: int, word: int):
    """The rows of axis group ``[a0, a1)``'s window in shared memory
    (``flat_layout`` in the source): ``(cols, pitch, shift)``, the columns
    (last-axis elements) of a row, the words between rows, and whether each
    unit's rows start ``colt[0] mod V`` words in (``V = 16 / word``, the
    words of a 16-byte piece). A group with the last axis's halo on an
    extent that is a multiple of ``V`` shifts, so that its pieces are
    16-byte aligned in both the source and shared memory, and pads its
    rows to hold the shift."""
    d, v = len(shape), 16 // word
    cols = tile[-1] + (k[-1] - 1 if a1 == d else 0)
    shift = a1 == d and shape[-1] % v == 0
    return cols, (-(-(cols + v - 1) // v) * v if shift else cols), shift


def flat_layout(shape, k, tile, ends, batch: int, word: int) -> dict:
    """What the kernel derives from a plan (``flat_layout`` in the source):
    the words of the two stage buffers ``X`` and ``Y`` (compute type; a
    window's rows ``window_pitch`` apart), the dynamic shared memory in
    bytes (the two buffers and the table ints: two areas a group, the
    window rows, columns and tile rows of its analysis and synthesis
    units), the units of the largest pass and, per pass, its units, window
    elements copied per unit and multiply-adds per unit. ``batch`` is 1
    or 2."""
    d = len(shape)
    nt = [-(-n // t) for n, t in zip(shape, tile)]
    tiles = math.prod(nt)
    xw = yw = iw = 0
    passes = []
    a0 = 0
    for a1 in ends:
        m = a1 - a0
        e = [t + (kk - 1 if a0 <= ax < a1 else 0)
             for ax, (t, kk) in enumerate(zip(tile, k))]
        win = math.prod(e)
        iw += 2 * (math.prod(e[:-1]) + e[-1] + math.prod(tile[:-1]))
        for adj in (False, True):
            cur = e[:-1] + [window_pitch(shape, k, tile, a0, a1, word)[1]]
            fma = 0
            for s in range(m):
                ax = a0 + s
                words = (2 ** (m - s) if adj else batch * 2 ** s) * math.prod(cur)
                if s % 2 == 0:
                    xw = max(xw, words)
                else:
                    yw = max(yw, words)
                cur[ax] = tile[ax]
                # the outputs of this axis: lo and hi of each input (analysis),
                # one of each pair (adjoint), K multiply-adds each
                outs = (batch * 2 ** (s + 1) if not adj else 2 ** (m - s - 1)) * math.prod(cur)
                fma += outs * k[ax] * (1 if not adj else 2)
            units = tiles * (2 ** a0 if not adj else batch * 2 ** (d - a1))
            passes.append({"units": units, "fma": fma,
                           "window": win * (batch if not adj else 2 ** m)})
        a0 = a1
    return {"xw": xw, "yw": yw, "passes": passes, "smem": (xw + yw) * word + 4 * iw,
            "units": max(p["units"] for p in passes)}


def _plan_cost(lay, word: int) -> float:
    """The cost model's estimate of one level's passes, microseconds."""
    static = 2 * MAX_DIM * cuda_kernels._MAX_TAPS * word
    per_sm = max(1, min(2, (228 * 1024 - static) // (lay["smem"] + 1024)))
    cost = len(lay["passes"]) * _FLAT_BARRIER_US
    for p in lay["passes"]:
        waves = -(-p["units"] // _FLAT_SMS)
        cost += (-(-p["units"] // (_FLAT_SMS * per_sm)) * _FLAT_LATENCY_US
                 + waves * p["window"] * word / _FLAT_SM_BYTES_PER_US
                 + waves * p["fma"] / _FLAT_SM_FMA_PER_US[word] * 2 / min(per_sm, waves))
    return cost


@functools.lru_cache(maxsize=None)
def _flat_plan(shape: tuple, k: tuple, dtype: torch.dtype, batch: int = 0) -> FlatPlan:
    """The plan of a launch over ``shape`` with ``k`` taps per axis on
    ``dtype`` arrays (with a leading pair when ``batch`` is 2): groups of
    one to ``_FLAT_GROUP`` consecutive axes a pass, and the tile, among the
    whole array and its halvings (the largest extent halved, the first of
    equal ones) down to ``_FLAT_TILE_MIN`` elements, whose passes fit
    ``_FLAT_SMEM_BUDGET``: the least estimated cost (``_plan_cost``), then
    the most units, then the larger groups. Where none fits, smaller tiles;
    a shape no plan fits raises."""
    d = len(shape)
    word = cuda_kernels._word(dtype)
    b = max(batch, 1)
    size = min(_FLAT_GROUP, d)
    floor = min(_FLAT_TILE_MIN, math.prod(shape))
    for least in (floor, 1):
        best = None
        for g in range(size, 0, -1):
            ends, tile = _group_ends(d, g), list(shape)
            while math.prod(tile) >= least:
                lay = flat_layout(shape, k, tile, ends, b, word)
                if lay["smem"] <= _FLAT_SMEM_BUDGET:
                    key = (_plan_cost(lay, word), -lay["units"])
                    if best is None or key < best[0]:
                        best = (key, FlatPlan(ends, tuple(tile), lay["smem"], lay["units"]))
                if max(tile) == 1:
                    break
                ax = tile.index(max(tile))
                tile[ax] = -(-tile[ax] // 2)
        if best is not None:
            return best[1]
    raise NotImplementedError(
        f"no plan of the flat kernel fits {_FLAT_SMEM_BUDGET} bytes of shared "
        f"memory for {shape} with filters of {k} taps in {dtype}")


@functools.lru_cache(maxsize=256)
def _level_work(shape, k, dtype, batch):
    """What one level of a launch does in each direction, from its plan:
    ``(groups, analysis bytes, synthesis bytes)``, its passes (one an axis
    group) and the bytes those passes copy into shared-memory windows,
    halos included (a pass's window words times its units)."""
    plan = _flat_plan(shape, k, dtype, batch)
    word = cuda_kernels._word(dtype)
    lay = flat_layout(shape, k, plan.tile, plan.ends, max(batch, 1), word)
    nbytes = [p["window"] * p["units"] * word for p in lay["passes"]]
    return len(plan.ends), sum(nbytes[0::2]), sum(nbytes[1::2])


def _count_passes(mode, shape, taps, dtype, batch, level, sweeps=1):
    """Add a launch's grid barriers to the counter ``flat_passes`` and its
    window copies' bytes to ``flat_window_bytes`` (``tracing.py``). The
    kernel's barriers (``csrc/nddwt_flat.cu``): one after the analysis
    input, one after each pass but a synthesis's last, and one between
    sweeps; so ``2 L G`` a sweep (chain, fista, pair), ``1 + L G`` for dec
    and ``L G - 1`` for rec, with ``G`` axis groups a level."""
    k = tuple(int(np.shape(t)[1]) for t in taps)
    groups, ana, syn = _level_work(tuple(shape), k, dtype, batch)
    lg = int(level) * groups
    barriers = {"dec": 1 + lg, "rec": lg - 1}.get(mode, 2 * lg * sweeps)
    window = ((0 if mode == "rec" else ana) + (0 if mode == "dec" else syn))
    tracing.count("flat_passes", barriers)
    tracing.count("flat_window_bytes", int(level) * sweeps * window)


def _plan_arg(shape, taps, dtype, batch):
    """The plan of a launch as its last argument (built once per shape,
    filters, dtype and batch)."""
    return _plan_ints(tuple(shape), tuple(int(np.shape(t)[1]) for t in taps), dtype, batch)


@functools.lru_cache(maxsize=256)
def _plan_ints(shape, k, dtype, batch):
    return (ctypes.c_int * PLAN_INTS)(*_flat_plan(shape, k, dtype, batch).ints())


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The one-launch kernel library with its signatures declared."""
    lib = cuda_kernels.library("nddwt_flat")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    ip = ctypes.POINTER(ctypes.c_int)
    lib.nddwt_flat_pair.argtypes = [i, vp, vp, vp, vp, vp, i, i, i, i, ip, ip,
                                    f, f, vp, ip]
    lib.nddwt_flat_iter.argtypes = [i] + [vp] * 8 + [i, i, i, i, i, ip, ip,
                                                     f, f, vp, ip]
    for name in ("nddwt_flat_pair", "nddwt_flat_iter", "nddwt_flat_max_dim",
                 "nddwt_flat_max_taps", "nddwt_flat_plan_ints"):
        getattr(lib, name).restype = ctypes.c_int
    lib.nddwt_flat_work_words.argtypes = [i, ctypes.c_longlong]
    lib.nddwt_flat_work_words.restype = ctypes.c_longlong
    lib.nddwt_error_string.argtypes = [i]
    lib.nddwt_error_string.restype = ctypes.c_char_p
    if (lib.nddwt_flat_max_dim() != MAX_DIM
            or lib.nddwt_flat_max_taps() != cuda_kernels._MAX_TAPS
            or lib.nddwt_flat_plan_ints() != PLAN_INTS):
        raise RuntimeError("flat kernel library and wrapper disagree on "
                           "kMaxDim, kMaxTaps or kPlanInts")
    return lib


@functools.lru_cache(maxsize=64)
def _device_taps(raw: bytes, ndim: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.frombuffer(bytearray(raw), dtype=dtype).view(
        ndim, 2, cuda_kernels._MAX_TAPS).to(device)


@functools.lru_cache(maxsize=64)
def _device_sched(lams: tuple, moms: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """A (lam, mom) schedule on the device, copied from pinned memory
    without blocking the host (built once per schedule, type and device:
    a call finds it by the schedule's values, with no array built)."""
    host = torch.tensor(list(zip(lams, moms)), dtype=dtype).view(-1, 2)
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def _taps_on(taps, dtype, device) -> torch.Tensor:
    """The (ndim, 2, kMaxTaps) taps of a launch in the compute type, on the
    device (built once per filter bank, type and device)."""
    arr = cuda_kernels._tap_array(list(taps), False,
                                  cuda_kernels._compute_dtype(dtype))
    cdt = torch.float64 if arr.dtype == np.float64 else torch.float32
    return _device_taps(arr.tobytes(), len(taps), cdt, device)


def _check(shape, taps, level):
    if len(taps) != len(shape) or not 1 <= len(shape) <= MAX_DIM:
        raise NotImplementedError(
            f"the flat kernels take 1 to {MAX_DIM} axes with one filter each, "
            f"got spatial shape {shape} with {len(taps)} filters"
        )
    if int(level) < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    if any(int(np.shape(tp)[1]) > m for tp, m in zip(taps, shape)):
        raise ValueError(f"filters longer than the axes of {shape}")


def _geometry(shape, taps):
    n = (ctypes.c_int * len(shape))(*shape)
    k = (ctypes.c_int * len(shape))(*(int(np.shape(t)[1]) for t in taps))
    return n, k


def _scratch(lib, arr, ndim, batch_numel):
    """The launch's compute-type scratch, sized by the library."""
    cdt = torch.float64 if arr.dtype == torch.float64 else torch.float32
    return torch.empty(lib.nddwt_flat_work_words(ndim, batch_numel), dtype=cdt,
                       device=arr.device)


def _call(mode, arr, taps, level, preserve_l2, lam, shape, batch=0):
    """One ``nddwt_flat_pair`` launch. ``arr`` is ``(*shape)`` for dec and
    pair, ``(B, *shape)`` for rec, each with a leading 2 when ``batch`` is
    2 (bands ``(2, B, *shape)``)."""
    shape = tuple(int(s) for s in shape)
    _check(shape, taps, level)
    lead = (2,) if batch else ()
    B = num_bands(len(shape), level)
    want = lead + ((B,) if mode == "rec" else ()) + shape
    if tuple(arr.shape) != want:
        raise ValueError(f"{mode}: expected {want}, got {tuple(arr.shape)}")
    if not arr.is_cuda:
        return flat_pair_ref(mode, arr, taps, level, preserve_l2, lam, batch)
    with tracing.span("nddwt.launch.nddwt_flat_pair") as on:
        cuda_kernels.check_array("arr", arr)
        bands = arr if mode == "rec" else torch.empty(
            lead + (B,) + shape, dtype=arr.dtype, device=arr.device)
        out = None if mode == "dec" else torch.empty(
            lead + shape, dtype=arr.dtype, device=arr.device)
        lib = load()
        work = _scratch(lib, arr, len(shape), max(batch, 1) * int(np.prod(shape)))
        tp = _taps_on(taps, arr.dtype, arr.device)
        n, k = _geometry(shape, taps)
        plan = _plan_arg(shape, taps, arr.dtype, batch)
        with torch.cuda.device(arr.device):
            err = lib.nddwt_flat_pair(
                _PAIR_MODES[mode], arr.data_ptr(), bands.data_ptr(),
                None if out is None else out.data_ptr(), work.data_ptr(),
                tp.data_ptr(), cuda_kernels.DTYPE_CODE[arr.dtype], len(shape),
                max(batch, 1), int(level), n, k, float(lam),
                1.0 if preserve_l2 else 1.0 / 2 ** len(shape),
                torch.cuda.current_stream().cuda_stream, plan,
            )
        cuda_kernels.raise_on(lib, err, "nddwt_flat_pair")
        cuda_kernels.launch_counts["nddwt_flat_pair"] += 1
        if on:
            _count_passes(mode, shape, taps, arr.dtype, batch, level)
    return {"dec": bands, "rec": out, "pair": (bands, out)}[mode]


def _call_iter(mode, arr, mask, taps, level, preserve_l2, lams, moms, step,
               shape, batch=0):
    """One ``nddwt_flat_iter`` launch; returns the last iterate, shaped as
    ``arr`` (``(*shape)``, or ``(2, *shape)`` when ``batch`` is 2)."""
    shape = tuple(int(s) for s in shape)
    _check(shape, taps, level)
    lams = [float(v) for v in lams]
    moms = [0.0] * len(lams) if moms is None else [float(v) for v in moms]
    if not lams or len(moms) != len(lams):
        raise ValueError("the schedule needs at least one sweep, and one "
                         "momentum per threshold")
    lead = (2,) if batch else ()
    if tuple(arr.shape) != lead + shape or (
            mask is not None and tuple(mask.shape) != shape):
        raise ValueError(
            f"{mode}: expected {lead + shape} and a mask of {shape}, got "
            f"{tuple(arr.shape)} and "
            f"{None if mask is None else tuple(mask.shape)}"
        )
    if not arr.is_cuda:
        return flat_iter_ref(mode, arr, mask, taps, level, preserve_l2, lams,
                             moms, step, batch)
    with tracing.span("nddwt.launch.nddwt_flat_iter") as on:
        cuda_kernels.check_array("arr", arr)
        if mask is not None:
            cuda_kernels.check_array("mask", mask, arr)
        B = num_bands(len(shape), level)
        bands = torch.empty(lead + (B,) + shape, dtype=arr.dtype, device=arr.device)
        out = torch.empty_like(arr)
        z = torch.empty_like(arr) if mode == "fista" else None
        lib = load()
        work = _scratch(lib, arr, len(shape), max(batch, 1) * int(np.prod(shape)))
        sched = _device_sched(tuple(lams), tuple(moms), work.dtype, arr.device)
        tp = _taps_on(taps, arr.dtype, arr.device)
        n, k = _geometry(shape, taps)
        plan = _plan_arg(shape, taps, arr.dtype, batch)
        with torch.cuda.device(arr.device):
            err = lib.nddwt_flat_iter(
                _ITER_MODES[mode], arr.data_ptr(),
                None if mask is None else mask.data_ptr(), bands.data_ptr(),
                out.data_ptr(), None if z is None else z.data_ptr(),
                work.data_ptr(), tp.data_ptr(), sched.data_ptr(),
                cuda_kernels.DTYPE_CODE[arr.dtype], len(shape), max(batch, 1),
                int(level), len(lams), n, k, float(step),
                1.0 if preserve_l2 else 1.0 / 2 ** len(shape),
                torch.cuda.current_stream().cuda_stream, plan,
            )
        cuda_kernels.raise_on(lib, err, "nddwt_flat_iter")
        cuda_kernels.launch_counts["nddwt_flat_iter"] += 1
        if on:
            _count_passes(mode, shape, taps, arr.dtype, batch, level, len(lams))
    return out


def dec_flat(x, taps, level: int):
    """``(*s)`` -> ``(B, *s)``, one launch."""
    return _call("dec", x, taps, level, False, 0.0, x.shape)


def rec_flat(y, taps, level: int, preserve_l2: bool):
    """``(B, *s)`` -> ``(*s)``, one launch."""
    return _call("rec", y, taps, level, preserve_l2, 0.0, y.shape[1:])


def pair_flat(x, taps, level: int, preserve_l2: bool, lam: float = 0.0):
    """dec -> soft-threshold the details -> rec in one launch; returns
    ``(bands, reconstruction)``."""
    return _call("pair", x, taps, level, preserve_l2, lam, x.shape)


def dec_split_flat(x_pair, taps, level: int):
    """``(2, *s)`` -> ``(2, B, *s)``, both components in one launch."""
    return _call("dec", x_pair, taps, level, False, 0.0, x_pair.shape[1:], 2)


def rec_split_flat(y_pair, taps, level: int, preserve_l2: bool):
    """``(2, B, *s)`` -> ``(2, *s)``, one launch."""
    return _call("rec", y_pair, taps, level, preserve_l2, 0.0,
                 y_pair.shape[2:], 2)


def pair_split_flat(x_pair, taps, level: int, preserve_l2: bool,
                    lam: float = 0.0):
    """Split-complex dec -> joint-magnitude soft-threshold -> rec in one
    launch; returns ``((2, B, *s) bands, (2, *s) reconstruction)``."""
    return _call("pair", x_pair, taps, level, preserve_l2, lam,
                 x_pair.shape[1:], 2)


def chain_flat(x, taps, level: int, preserve_l2: bool, lams):
    """``len(lams)`` dec -> shrink -> rec sweeps in one launch; returns the
    reconstruction after the last."""
    return _call_iter("chain", x, None, taps, level, preserve_l2, lams, None,
                      0.0, x.shape)


def fista_flat(b, mask, taps, level: int, preserve_l2: bool, lams, moms,
               step: float):
    """A whole FISTA inpainting solve in one launch: ``b`` the masked
    observation and ``mask`` the 0/1 sampling mask, both ``(*s)``."""
    return _call_iter("fista", b, mask, taps, level, preserve_l2, lams, moms,
                      step, b.shape)


def fista_split_flat(b_pair, mask, taps, level: int, preserve_l2: bool, lams,
                     moms, step: float):
    """The split-complex solve: ``b_pair`` ``(2, *s)``, ``mask`` ``(*s)``
    shared by both components, the shrink the joint magnitude."""
    return _call_iter("fista", b_pair, mask, taps, level, preserve_l2, lams,
                      moms, step, b_pair.shape[1:], 2)
