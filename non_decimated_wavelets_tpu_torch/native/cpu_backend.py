"""ctypes bridge to the C++ CPU backend (``native/nddwt_cpu.cpp``).

The port's own copy of ``non_decimated_wavelets_tpu/native/cpu_backend.py``
(which imports no JAX, but the port imports nothing of the JAX package): the
replacement for the reference's MEX layer (``mex/nd_dwt_mex.c``,
``mex/nddwt.c``), a dimension-generic C++/OpenMP engine computing the
direct-path NDDWT in float64 on the host, reached through a small C ABI.

Until the shared library is built (``make -C native``), :func:`available`
returns False and the class API (``api.py``) falls back to the plan with a
warning, as the reference degrades when its MEX binary is absent.
:func:`use_library` points the bridge at a library built elsewhere.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..filters import correlation_taps
from ..oracle import _normalize_wavelets, level_from_bands, num_bands

_REPO = Path(__file__).resolve().parents[2]
_CANDIDATES = [
    Path(__file__).resolve().parent / "libnddwt_cpu.so",
    _REPO / "native" / "libnddwt_cpu.so",
]
_state = {"lib": None, "tried": False}


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    lp = ctypes.POINTER(ctypes.c_long)
    # x or y in, y or x out (float64, C order), shape, ndim, the taps (2K
    # per axis, concatenated), per-axis K, level, [preserve_l2,] is_complex
    lib.nddwt_dec.argtypes = [vp, vp, lp, ctypes.c_int, vp, ip, ctypes.c_int,
                              ctypes.c_int]
    lib.nddwt_dec.restype = ctypes.c_int
    lib.nddwt_rec.argtypes = [vp, vp, lp, ctypes.c_int, vp, ip, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int]
    lib.nddwt_rec.restype = ctypes.c_int
    lib.nddwt_set_num_threads.argtypes = [ctypes.c_int]
    lib.nddwt_set_num_threads.restype = ctypes.c_int
    return lib


def use_library(path) -> None:
    """Load the backend from ``path`` (raises ``OSError`` if it cannot)."""
    _state["lib"] = _declare(ctypes.CDLL(str(path)))
    _state["tried"] = True


def _load():
    if not _state["tried"]:
        _state["tried"] = True
        for path in _CANDIDATES:
            if path.exists():
                try:
                    use_library(path)
                    break
                except OSError:
                    continue
    return _state["lib"]


def available() -> bool:
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("native CPU backend not built (make -C native)")
    return lib


def set_num_threads(n: int) -> int:
    """Set the OpenMP thread count; returns the resulting maximum."""
    return int(_lib().nddwt_set_num_threads(int(n)))


def _pack_taps(wavelets, ndim, preserve_l2):
    names = _normalize_wavelets(wavelets, ndim)
    scale = 1.0 / np.sqrt(2.0) if preserve_l2 else 1.0
    taps, ks = [], []
    for w in names:
        lo, hi = correlation_taps(w)
        ks.append(len(lo))
        taps.append(scale * np.stack([lo, hi]).ravel())
    return np.concatenate(taps), np.array(ks, dtype=np.int32)


def _as_f64(a: np.ndarray):
    is_complex = np.iscomplexobj(a)
    return np.ascontiguousarray(a, np.complex128 if is_complex else np.float64), is_complex


def _single(a: np.ndarray, is_complex: bool, precision) -> np.ndarray:
    if precision in ("single", "float32"):
        return a.astype(np.complex64 if is_complex else np.float32)
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def dec(x: np.ndarray, wavelets, level: int, preserve_l2: bool,
        precision="double") -> np.ndarray:
    """Multilevel analysis, ``[n1..nd, B]`` (the reference layout)."""
    lib = _lib()
    xd, is_complex = _as_f64(x)
    ndim = xd.ndim
    y = np.empty((num_bands(ndim, level),) + xd.shape, dtype=xd.dtype)
    taps, ks = _pack_taps(wavelets, ndim, preserve_l2)
    rc = lib.nddwt_dec(
        _ptr(xd), _ptr(y), (ctypes.c_long * ndim)(*xd.shape), ndim, _ptr(taps),
        (ctypes.c_int * ndim)(*ks), int(level), int(is_complex),
    )
    if rc != 0:
        raise RuntimeError(f"native nddwt_dec failed with code {rc}")
    return _single(np.moveaxis(y, 0, -1), is_complex, precision)


def rec(y: np.ndarray, wavelets, preserve_l2: bool, precision="double") -> np.ndarray:
    """Multilevel synthesis from ``[n1..nd, B]`` bands; the level from B."""
    lib = _lib()
    ndim = y.ndim - 1
    level = level_from_bands(ndim, y.shape[-1])
    yb, is_complex = _as_f64(np.moveaxis(y, -1, 0))
    x = np.empty(yb.shape[1:], dtype=yb.dtype)
    taps, ks = _pack_taps(wavelets, ndim, preserve_l2)
    rc = lib.nddwt_rec(
        _ptr(yb), _ptr(x), (ctypes.c_long * ndim)(*x.shape), ndim, _ptr(taps),
        (ctypes.c_int * ndim)(*ks), int(level), int(preserve_l2), int(is_complex),
    )
    if rc != 0:
        raise RuntimeError(f"native nddwt_rec failed with code {rc}")
    return _single(x, is_complex, precision)
