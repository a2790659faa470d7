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
``FLAT_MAX_NUMEL`` holds, for each per-level route that the flat kernel
stands in for, the largest count at which a ``dec_rec`` on the flat kernel
was no slower than on that route, in float32 and float64 alike: the 1D
kernels; the stage kernels, which serve 4D and the 3D filters too long for
the level kernels' tile (db20); and the level kernels of 2D and 3D, at
db4 to db20 and three to five levels, whose limit, the largest count
measured, also bounds 5D and up, which have no other route.
``ITER_MAX_NUMEL`` is the largest count at which a whole FISTA solve in
one launch was no slower than the stepped route on the flat kernel (a pair
and a ``fista_step`` per iteration), and covers a 256^2 split solve; it is
within every ``FLAT_MAX_NUMEL`` entry.

Each wrapper launches its kernel for a CUDA tensor and raises if the
launch fails; for a CPU tensor it runs the plain version
(``ops/flat_ref.py``). Launches are counted in
``cuda_kernels.launch_counts``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..oracle import num_bands
from . import cuda_kernels
from .flat_ref import flat_iter_ref, flat_pair_ref

MAX_DIM = 8  # kMaxDim in the source
# By the per-level route the flat kernel stands in for; None: the level
# kernels, and 5D and up.
FLAT_MAX_NUMEL = {"1d": 2**20, "stage": 2**18, None: 2**22}
ITER_MAX_NUMEL = 2**18
_PAIR_MODES = {"dec": 0, "rec": 1, "pair": 2}
_ITER_MODES = {"chain": 3, "fista": 4}


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


def flat_limit(shape, taps, dtype) -> int:
    """The most elements (a pair's two components counted) of a ``dtype``
    array of ``shape``, one filter of ``taps`` per axis, that take
    ``nddwt_flat_pair``: the entry of the per-level route it stands in
    for."""
    if len(shape) == 1:
        route = "1d"
    elif len(shape) in (3, 4) and cuda_kernels.stage_route(shape, taps, dtype):
        route = "stage"
    else:
        route = None
    return FLAT_MAX_NUMEL.get(route, FLAT_MAX_NUMEL[None])


def flat_supported(shape, dtype, batch: int = 0, *, taps) -> bool:
    """Whether ``dec``/``rec``/``dec_rec`` of ``shape`` (with a leading pair
    when ``batch`` is 2) in ``dtype``, one filter of ``taps`` per axis, take
    ``nddwt_flat_pair``."""
    shape = tuple(int(s) for s in shape)
    n = _count(shape, dtype, batch)
    return n is not None and n <= flat_limit(shape, taps, dtype)


def iter_supported(shape, dtype, batch: int = 0) -> bool:
    """Whether a chain or a FISTA solve of ``shape`` takes
    ``nddwt_flat_iter``."""
    n = _count(tuple(int(s) for s in shape), dtype, batch)
    return n is not None and n <= ITER_MAX_NUMEL


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The one-launch kernel library with its signatures declared."""
    lib = cuda_kernels.library("nddwt_flat")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    ip = ctypes.POINTER(ctypes.c_int)
    lib.nddwt_flat_pair.argtypes = [i, vp, vp, vp, vp, vp, i, i, i, i, ip, ip,
                                    f, f, vp]
    lib.nddwt_flat_iter.argtypes = [i] + [vp] * 8 + [i, i, i, i, i, ip, ip,
                                                     f, f, vp]
    for name in ("nddwt_flat_pair", "nddwt_flat_iter", "nddwt_flat_max_dim",
                 "nddwt_flat_max_taps"):
        getattr(lib, name).restype = ctypes.c_int
    lib.nddwt_flat_work_words.argtypes = [i, ctypes.c_longlong]
    lib.nddwt_flat_work_words.restype = ctypes.c_longlong
    lib.nddwt_error_string.argtypes = [i]
    lib.nddwt_error_string.restype = ctypes.c_char_p
    if (lib.nddwt_flat_max_dim() != MAX_DIM
            or lib.nddwt_flat_max_taps() != cuda_kernels._MAX_TAPS):
        raise RuntimeError("flat kernel library and wrapper disagree on "
                           "kMaxDim or kMaxTaps")
    return lib


@functools.lru_cache(maxsize=64)
def _device_taps(raw: bytes, ndim: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.frombuffer(bytearray(raw), dtype=dtype).view(
        ndim, 2, cuda_kernels._MAX_TAPS).to(device)


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
    cuda_kernels.check_array("arr", arr)
    bands = arr if mode == "rec" else torch.empty(
        lead + (B,) + shape, dtype=arr.dtype, device=arr.device)
    out = None if mode == "dec" else torch.empty(
        lead + shape, dtype=arr.dtype, device=arr.device)
    lib = load()
    work = _scratch(lib, arr, len(shape), max(batch, 1) * int(np.prod(shape)))
    tp = _taps_on(taps, arr.dtype, arr.device)
    n, k = _geometry(shape, taps)
    with torch.cuda.device(arr.device):
        err = lib.nddwt_flat_pair(
            _PAIR_MODES[mode], arr.data_ptr(), bands.data_ptr(),
            None if out is None else out.data_ptr(), work.data_ptr(),
            tp.data_ptr(), cuda_kernels.DTYPE_CODE[arr.dtype], len(shape),
            max(batch, 1), int(level), n, k, float(lam),
            1.0 if preserve_l2 else 1.0 / 2 ** len(shape),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_kernels.raise_on(lib, err, "nddwt_flat_pair")
    cuda_kernels.launch_counts["nddwt_flat_pair"] += 1
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
    cuda_kernels.check_array("arr", arr)
    if mask is not None:
        cuda_kernels.check_array("mask", mask, arr)
    B = num_bands(len(shape), level)
    bands = torch.empty(lead + (B,) + shape, dtype=arr.dtype, device=arr.device)
    out = torch.empty_like(arr)
    z = torch.empty_like(arr) if mode == "fista" else None
    lib = load()
    work = _scratch(lib, arr, len(shape), max(batch, 1) * int(np.prod(shape)))
    sched = torch.tensor(list(zip(lams, moms)), dtype=work.dtype).to(arr.device)
    tp = _taps_on(taps, arr.dtype, arr.device)
    n, k = _geometry(shape, taps)
    with torch.cuda.device(arr.device):
        err = lib.nddwt_flat_iter(
            _ITER_MODES[mode], arr.data_ptr(),
            None if mask is None else mask.data_ptr(), bands.data_ptr(),
            out.data_ptr(), None if z is None else z.data_ptr(),
            work.data_ptr(), tp.data_ptr(), sched.data_ptr(),
            cuda_kernels.DTYPE_CODE[arr.dtype], len(shape), max(batch, 1),
            int(level), len(lams), n, k, float(step),
            1.0 if preserve_l2 else 1.0 / 2 ** len(shape),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_kernels.raise_on(lib, err, "nddwt_flat_iter")
    cuda_kernels.launch_counts["nddwt_flat_iter"] += 1
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
