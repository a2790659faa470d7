"""The one-launch multilevel CUDA kernels: bind and launch, gate the route.

``csrc/nddwt_multi.cu`` holds the two hand-written Hopper kernels that
replace ``non_decimated_wavelets_tpu/ops/pallas_kernels.py``'s one-launch
multilevel cascade over a batch of 2D or 3D arrays:

* ``nddwt_dec_multi`` for ``_fused_dec_multi`` / ``_make_dec_multi_kernel``
  (``dec_multi``);
* ``nddwt_rec_multi`` for ``_fused_rec_multi`` / ``_make_rec_multi_kernel``
  (``rec_multi``).

Each runs every level of a whole batch in one cooperative launch, a grid
barrier between levels: a persistent grid claims the units of each level
from a per-level counter, a unit being one CTA tile of the per-level
kernels' streamed launch of one item (``csrc/nddwt_stream.cuh``: the same
view, halos, taps and plan; ``_multi_geometry``). A 2D batch whose rows are
narrower than a plane tile is one view ``(n0, N, n1)``, its items in the
pass-through slot, so that a plane tile covers several items' rows.
``ops/stream_ref.multi_replay`` replays the schedule on the CPU. They take
float32, bfloat16 (float32 compute) and float64 arrays.
``multi_supported`` is the counterpart of ``multi_feasible``: whether these
kernels take an item. ``NDDWT.route`` decides where they run (route
``multi``: one array, a complex array's or split pair's two components, or
a ``dec_batched``/``rec_batched`` batch, one launch per direction; never a
level of the stage route). ``MULTI_MAX_NUMEL`` is the largest item, in elements,
up to which a batch of 2 (a complex array's or split pair's parts) and of
8 items on these kernels was no slower than the same batch item by item on
the per-level route, in 2D and 3D db4 L3 float32 on an H100
(``chip_flat_crossover.py``, ``PERF.md``): those are the calls they take,
since the flat kernel takes every single 2D or 3D array of that size. It is
the largest count measured, 2^22 (the JAX package's limit is 4,000,000).

Each wrapper launches its kernel for a CUDA tensor and raises if the launch
fails; for a CPU tensor it runs the plain version (``ops/multi_ref.py``).
Launches are counted in ``cuda_kernels.launch_counts``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import tracing
from ..oracle import num_bands
from . import cuda_kernels as ck
from .multi_ref import dec_multi_ref, rec_multi_ref

MULTI_MAX_NUMEL = 2**22


@functools.lru_cache(maxsize=None)
def _plan(shape: tuple, k: tuple, dtype, rec: bool, items: int, fold: bool = True):
    """The view, taps per slot, plan ``(C, T1, T2)`` and the analysis's
    in-plane bands a walk of a multilevel launch over ``items`` items of
    ``shape`` with ``k`` taps per axis; None where the streamed bodies take
    no such level (a filter longer than its axis or than 76 taps, or no plan
    that fits shared memory). The view is the per-level kernels'
    (``cuda_kernels._stream_view``: ``(n0, 1, n1)`` in 2D), a 2D batch
    folded into its pass-through slot 1, ``(n0, N, n1)``, where that plan's
    plane tile covers more than one item's row (rows narrower than the
    tile) and ``fold`` allows it. The plan is theirs
    (``cuda_kernels._stream_plan``), its chunk sized so that the whole
    batch's units fill one wave."""
    kind = "rec" if rec else "dec"
    n = [shape[0], 1, shape[1]] if len(shape) == 2 else list(shape)
    kv = [k[0], 1, k[1]] if len(shape) == 2 else list(k)
    if max(kv) > ck._MAX_TAPS or any(K > m for K, m in zip(kv, n)):
        return None
    try:
        t = ck._stream_plan(n, kv, dtype, kind, items)
        if fold and len(shape) == 2 and items > 1:
            folded = [shape[0], items, shape[1]]
            tf = ck._stream_plan(folded, kv, dtype, kind)
            if tf[1] > 1:
                n, t = folded, tf
    except NotImplementedError:
        return None
    return n, kv, t, 1 if rec else ck._walk_bands(kv, t, dtype)


def _lengths(taps) -> tuple:
    """The filter length of each axis."""
    return tuple(int(np.shape(t)[1]) for t in taps)


def multi_supported(shape, taps, dtype, level) -> bool:
    """Whether the multilevel kernels take a ``level``-level transform of
    ``dtype`` items of ``shape``, one filter of ``taps`` per axis: 2 or 3
    axes, at least two levels, at most ``MULTI_MAX_NUMEL`` elements an
    item, and a streamed plan for both directions (``_plan``)."""
    shape = tuple(int(s) for s in shape)
    if (len(shape) not in (2, 3) or len(taps) != len(shape) or int(level) < 2
            or dtype not in ck.DTYPE_CODE
            or int(np.prod(shape)) > MULTI_MAX_NUMEL):
        return False
    return all(_plan(shape, _lengths(taps), dtype, rec, 1) is not None
               for rec in (False, True))


def _multi_geometry(shape, taps, rec: bool, dtype, items: int):
    """ctypes-ready arguments of one multilevel launch over ``items`` items
    of ``shape`` on ``dtype`` arrays: the view ``n``, taps ``k``, plan ``t``
    and left halo per slot (``cuda_kernels.halo_widths``), the band bits,
    the taps in the compute type (reversed for the synthesis) and the
    analysis's in-plane bands a walk (``_plan``). Raises where the streamed
    bodies take no such level."""
    shape = tuple(int(s) for s in shape)
    plan = _plan(shape, _lengths(taps), dtype, rec, int(items))
    if plan is None:
        raise NotImplementedError(
            f"the multilevel kernels take no level of filters of lengths "
            f"{list(_lengths(taps))} on items of shape {shape} in {dtype}")
    n, k, t, gw = plan
    slot_taps = [taps[0], None, taps[1]] if len(shape) == 2 else list(taps)
    left = [0 if tp is None else ck.halo_widths([tp], rec)[0][0] for tp in slot_taps]
    bit = [0, 0, 1] if len(shape) == 2 else [0, 1, 2]
    return (n, k, t, left, bit,
            ck._tap_array(slot_taps, rec, ck._compute_dtype(dtype)), gw)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The multilevel kernel library with its signatures declared."""
    lib = ck.library("nddwt_multi")
    ip = ctypes.POINTER(ctypes.c_int)
    vp, i = ctypes.c_void_p, ctypes.c_int
    geom = [vp, vp, vp, vp, i, i, i, i, ip, ip, ip, ip, ip, vp]  # ..., bit, taps
    lib.nddwt_dec_multi.argtypes = geom + [i, ctypes.c_double, vp]  # gw, lam
    lib.nddwt_rec_multi.argtypes = geom + [ctypes.c_double, vp]  # scale
    for name in ("nddwt_dec_multi", "nddwt_rec_multi"):
        getattr(lib, name).restype = ctypes.c_int
    return ck._check_level_library(lib)


def _check(shape, taps, level, items):
    if len(shape) not in (2, 3) or len(taps) != len(shape):
        raise NotImplementedError(
            f"the multilevel CUDA kernels take 2D and 3D items with one filter "
            f"per axis, got items of shape {shape} with {len(taps)} filters"
        )
    if int(level) < 1:
        raise ValueError(f"level must be >= 1, got {level}")
    if items < 1:
        raise ValueError("a batch needs at least one item")


def _launch(name, src, dst, shape, taps, level, rec, coef):
    """One launch of ``name`` over ``src`` -> ``dst``, with the ping slots
    and the per-level unit counters it needs; raises if the launch fails."""
    items = src.shape[0]
    n, k, t, left, bit, arr, gw = _multi_geometry(shape, taps, rec, src.dtype, items)
    ping = torch.empty((min(level - 1, 2) * items,) + shape, dtype=src.dtype,
                       device=src.device)
    counters = torch.zeros(level, dtype=torch.int64, device=src.device)
    lib = load()
    walk = () if rec else (gw,)
    with torch.cuda.device(src.device):
        err = getattr(lib, name)(
            src.data_ptr(), dst.data_ptr(), ping.data_ptr() if ping.numel() else None,
            counters.data_ptr(), ck.DTYPE_CODE[src.dtype], len(shape), items, int(level),
            *(ck._ints(v) for v in (n, k, t, left, bit)), ck._taps_ptr(arr), *walk,
            float(coef), torch.cuda.current_stream().cuda_stream,
        )
    ck.raise_on(lib, err, name)
    ck.launch_counts[name] += 1


def dec_multi(x, taps, level: int, lam: float = 0.0, out=None):
    """``x`` ``(N, *s)`` -> bands ``(N, B, *s)`` (into ``out`` when given),
    the details soft-thresholded by ``lam``: one ``nddwt_dec_multi``
    launch for the whole batch (contract of ``multi_ref.dec_multi_ref``)."""
    shape = tuple(x.shape[1:])
    _check(shape, taps, level, x.shape[0])
    want = (x.shape[0], num_bands(len(shape), level)) + shape
    if out is not None and tuple(out.shape) != want:
        raise ValueError(f"out must be {want}, got {tuple(out.shape)}")
    if not x.is_cuda:
        return dec_multi_ref(x, taps, level, lam, out)
    with tracing.span("nddwt.launch.nddwt_dec_multi"):
        ck.check_array("x", x)
        big = out if out is not None else torch.empty(want, dtype=x.dtype,
                                                      device=x.device)
        ck.check_array("out", big, x)
        _launch("nddwt_dec_multi", x, big, shape, taps, level, False, lam)
    return big


def rec_multi(y, taps, level: int, preserve_l2: bool):
    """Bands ``y`` ``(N, B, *s)`` -> ``(N, *s)``: one ``nddwt_rec_multi``
    launch for the whole batch (contract of ``multi_ref.rec_multi_ref``,
    scale 1 with ``preserve_l2``, else ``1/2^d`` per level)."""
    shape = tuple(y.shape[2:])
    _check(shape, taps, level, y.shape[0])
    if y.shape[1] != num_bands(len(shape), level):
        raise ValueError(f"{y.shape[1]} bands are not {level} levels of a "
                         f"{len(shape)}D transform")
    scale = 1.0 if preserve_l2 else 1.0 / 2 ** len(shape)
    if not y.is_cuda:
        return rec_multi_ref(y, taps, level, scale)
    with tracing.span("nddwt.launch.nddwt_rec_multi"):
        ck.check_array("y", y)
        out = torch.empty((y.shape[0],) + shape, dtype=y.dtype, device=y.device)
        _launch("nddwt_rec_multi", y, out, shape, taps, level, True, scale)
    return out
