"""The CUDA kernels' build and the per-level kernels: bind, launch, loops.

Every source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` at first
use into its own shared library in ``non_decimated_wavelets_tpu_torch/_build/``,
under a name keyed by a hash of the source and flags, and loaded with
``ctypes`` (a plain C interface: no PyTorch headers, so a build takes
seconds). ``build()`` starts one ``nvcc`` per source, all at once. Importing
this module builds nothing.

``csrc/nddwt_level.cu`` holds the two hand-written Hopper kernels that
replace the TPU kernels on the main path
(``non_decimated_wavelets_tpu/ops/pallas_kernels.py``):

* ``nddwt_dec_level`` for ``_fused_dec_level`` / ``_make_dec_kernel``;
* ``nddwt_rec_level`` for ``_fused_rec_level`` / ``_make_rec_kernel``.

``csrc/nddwt_elemwise.cu`` holds the solvers' elementwise kernels, bound in
``ops/elemwise.py``.

Each wrapper launches its kernel for a CUDA tensor and raises if the
launch fails; for a CPU tensor it runs the kernel's plain version
(``ops/level_ref.py``, ``ops/elemwise_ref.py``). Nothing falls back from
CUDA to the plain version. ``launch_counts`` counts the launches of every
kernel, so a run can show which kernels a path went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..oracle import num_bands
from .level_ref import dec_level_ref, rec_level_ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("nddwt_level", "nddwt_elemwise")  # csrc/<name>.cu, one library each
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
)
_MAX_TAPS = 76  # kMaxTaps in the source
# Dynamic shared memory a CTA may take: two CTAs fit one SM's 227 KB.
_SMEM_BUDGET = 100 * 1024
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launch_counts = {
    "nddwt_dec_level": 0,
    "nddwt_rec_level": 0,
    "nddwt_mag_shrink_pair": 0,
    "nddwt_fista_step": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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
    of the source and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
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
    fp = ctypes.POINTER(ctypes.c_float)
    vp = ctypes.c_void_p
    geom = [ctypes.c_int, ip, ip, ip, ip, ip, fp]
    lib.nddwt_dec_level.argtypes = [vp, vp, vp] + geom + [
        ctypes.c_longlong, ctypes.c_float, vp]
    lib.nddwt_dec_level.restype = ctypes.c_int
    lib.nddwt_rec_level.argtypes = [vp, vp, vp] + geom + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, vp]
    lib.nddwt_rec_level.restype = ctypes.c_int
    lib.nddwt_error_string.argtypes = [ctypes.c_int]
    lib.nddwt_error_string.restype = ctypes.c_char_p
    lib.nddwt_max_taps.restype = ctypes.c_int
    if lib.nddwt_max_taps() != _MAX_TAPS:
        raise RuntimeError("kernel library and wrapper disagree on kMaxTaps")
    return lib


def _tiles(n, k, rec: bool) -> list:
    """Output tile per slot: (8, 8, 32) for 3D, (1, 32, 128) for 2D, capped
    by the extents and halved on the largest axis until the shared-memory
    tile plan fits the budget."""
    base = (8, 8, 32) if k[0] > 1 else (1, 32, 128)
    t = [min(b, m) for b, m in zip(base, n)]

    def words(t):
        e = [t[a] + k[a] - 1 for a in range(3)]
        w = e[0] * e[1] * e[2] + t[0] * e[1] * e[2] + t[0] * t[1] * e[2]
        return w + (t[0] * t[1] * t[2] if rec else 0)

    while 4 * words(t) > _SMEM_BUDGET:
        a = max(range(3), key=lambda i: t[i])
        if t[a] == 1:
            raise NotImplementedError(
                f"filters of lengths {k} are too long for the "
                "shared-memory tile of the per-level CUDA kernels "
                "(ROADMAP.md queue 3, port gap)"
            )
        t[a] = (t[a] + 1) // 2
    return t


def _geometry(shape, taps, rec: bool):
    """ctypes arguments describing one level: extents, tap counts, tile,
    left halo and band bit per slot (a 2D array is (1, n0, n1)), and the
    taps as float32 — reversed for the synthesis, whose adjoint reads the
    mirrored halo (K//2 left instead of K//2 - 1)."""
    pad = 3 - len(shape)
    n = [1] * pad + [int(s) for s in shape]
    k = [1] * pad + [int(np.shape(t)[1]) for t in taps]
    if max(k) > _MAX_TAPS:
        raise NotImplementedError(f"filters longer than {_MAX_TAPS} taps")
    left = [0] * pad + [K // 2 if rec else K // 2 - 1 for K in k[pad:]]
    bit = [0] * pad + list(range(len(shape)))
    arr = np.zeros((3, 2, _MAX_TAPS), np.float32)
    arr[:pad, :, 0] = 1.0
    for a, t in enumerate(taps):
        t = np.asarray(t, np.float64)
        arr[pad + a, :, : t.shape[1]] = t[:, ::-1] if rec else t
    ints = lambda v: (ctypes.c_int * 3)(*v)  # noqa: E731
    return (ints(n), ints(k), ints(_tiles(n, k, rec)), ints(left), ints(bit),
            arr)


def check_array(name, t, ref=None):
    if t.dtype not in DTYPE_CODE:
        raise NotImplementedError(
            f"{name}: the CUDA kernels take float32 and bfloat16, got "
            f"{t.dtype} (float64 kernels: ROADMAP.md queue 2 items 19-20)"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ref is not None and (t.dtype != ref.dtype or t.device != ref.device):
        raise ValueError(
            f"{name} is {t.dtype} on {t.device}, expected {ref.dtype} on "
            f"{ref.device}"
        )


def raise_on(lib, err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``lib`` names it)."""
    if err:
        msg = lib.nddwt_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")


def dec_level(approx, big, band_off, taps, lam=0.0, final=False):
    """One analysis level (contract of ``level_ref.dec_level_ref``):
    details into ``big[band_off : band_off + 2^d - 1]``, shrunk by ``lam``;
    the approximation into ``big[0]`` when ``final``, else returned."""
    if not approx.is_cuda:
        return dec_level_ref(approx, big, band_off, taps, lam, final)
    if approx.ndim not in (2, 3) or len(taps) != approx.ndim:
        raise NotImplementedError(
            f"the per-level CUDA kernels take 2D and 3D arrays, got "
            f"{approx.ndim}D (ROADMAP.md queue 2)"
        )
    check_array("approx", approx)
    check_array("big", big, approx)
    nb = 2**approx.ndim
    if big.shape[1:] != approx.shape or not 1 <= band_off <= big.shape[0] - nb + 1:
        raise ValueError(
            f"band array {tuple(big.shape)} cannot take the {nb - 1} detail "
            f"bands of {tuple(approx.shape)} at offset {band_off}"
        )
    out = big[0] if final else torch.empty_like(approx)
    n, k, t, left, bit, arr = _geometry(approx.shape, taps, rec=False)
    lib = load()
    with torch.cuda.device(approx.device):
        err = lib.nddwt_dec_level(
            approx.data_ptr(), big.data_ptr(), out.data_ptr(),
            DTYPE_CODE[approx.dtype], n, k, t, left, bit,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(band_off), float(lam), torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, err, "nddwt_dec_level")
    launch_counts["nddwt_dec_level"] += 1
    return None if final else out


def rec_level(y, approx, band_src, taps, scale):
    """One synthesis level (contract of ``level_ref.rec_level_ref``): band
    ``b`` is ``y[i]`` for ``band_src[b] == ("y", i)`` or ``approx`` for
    ``("a", 0)``; returns ``scale *`` the adjoint, shaped ``y.shape[1:]``."""
    if not y.is_cuda:
        return rec_level_ref(y, approx, band_src, taps, scale)
    shape = tuple(y.shape[1:])
    if len(shape) not in (2, 3) or len(taps) != len(shape):
        raise NotImplementedError(
            f"the per-level CUDA kernels take 2D and 3D arrays, got "
            f"{len(shape)}D (ROADMAP.md queue 2)"
        )
    check_array("y", y)
    nb = 2 ** len(shape)
    idx = []
    for kind, i in band_src:
        if kind == "a":
            idx.append(-1)
        elif kind == "y" and 0 <= i < y.shape[0]:
            idx.append(int(i))
        else:
            raise ValueError(f"bad band source {(kind, i)!r}")
    if len(idx) != nb:
        raise ValueError(f"expected {nb} band sources, got {len(idx)}")
    if -1 in idx:
        if approx is None or tuple(approx.shape) != shape:
            raise ValueError("band source ('a', 0) needs an approx of the band shape")
        check_array("approx", approx, y)
    else:
        approx = y
    out = torch.empty(shape, dtype=y.dtype, device=y.device)
    n, k, t, left, bit, arr = _geometry(shape, taps, rec=True)
    lib = load()
    with torch.cuda.device(y.device):
        err = lib.nddwt_rec_level(
            y.data_ptr(), approx.data_ptr(), out.data_ptr(),
            DTYPE_CODE[y.dtype], n, k, t, left, bit,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            (ctypes.c_longlong * 8)(*(idx + [-1] * (8 - nb))),
            float(scale), torch.cuda.current_stream().cuda_stream,
        )
    raise_on(lib, err, "nddwt_rec_level")
    launch_counts["nddwt_rec_level"] += 1
    return out


def dec_levels(x, taps, level: int, lam: float = 0.0, out=None):
    """Multilevel analysis as one ``dec_level`` per level; ``(B, *s)``,
    written into ``out`` when given. Level ``l`` writes its details at
    ``B - (2^d - 1)(l + 1)`` (the tail of ``pallas_kernels._dec_dispatch``),
    the last one its approximation into band 0."""
    nb = 2**x.ndim
    B = num_bands(x.ndim, level)
    big = out if out is not None else torch.empty(
        (B,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    approx = x
    for lvl in range(level):
        approx = dec_level(approx, big, B - (nb - 1) * (lvl + 1), taps, lam,
                           final=lvl == level - 1)
    return big


def rec_levels(y, taps, level: int, preserve_l2: bool):
    """Multilevel synthesis as one ``rec_level`` per level (the tail of
    ``pallas_kernels._rec_dispatch``): band 0 comes from the previous
    level's output, the details from ``y[pos + b - 1]``."""
    nb = 2 ** (y.ndim - 1)
    scale = 1.0 if preserve_l2 else 1.0 / nb
    acc = rec_level(y, None, [("y", b) for b in range(nb)], taps, scale)
    pos = nb
    for _ in range(1, level):
        src = [("a", 0)] + [("y", pos + b - 1) for b in range(1, nb)]
        acc = rec_level(y, acc, src, taps, scale)
        pos += nb - 1
    return acc
