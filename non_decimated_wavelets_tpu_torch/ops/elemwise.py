"""The solvers' fused elementwise CUDA kernels: bind and launch.

``csrc/nddwt_elemwise.cu`` holds the two hand-written Hopper kernels that
replace ``non_decimated_wavelets_tpu/ops/pallas_elemwise.py``, under that
module's names:

* ``mag_shrink_pair`` (``nddwt_mag_shrink_pair``): the complex-l1 prox of
  the split-complex solvers, one pass over both components;
* ``fista_step`` (``nddwt_fista_step``): the momentum and data-term glue of
  a FISTA iterate, one pass.

They take any element count (the TPU versions only multiples of 1024), and
float32, bfloat16 and float64 arrays (float64 computes in float64).
Each wrapper launches its kernel for a CUDA tensor and raises if the launch
fails; for a CPU tensor it runs the plain version (``ops/elemwise_ref.py``).
Launches are counted in ``cuda_kernels.launch_counts``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from . import cuda_kernels
from .elemwise_ref import fista_step_ref, mag_shrink_pair_ref


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The elementwise kernel library with its signatures declared."""
    lib = cuda_kernels.library("nddwt_elemwise")
    vp, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double
    lib.nddwt_mag_shrink_pair.argtypes = [vp, vp, ctypes.c_int, ll, ll, f, vp]
    lib.nddwt_mag_shrink_pair.restype = ctypes.c_int
    lib.nddwt_fista_step.argtypes = [vp] * 5 + [
        ctypes.c_int, ll, ctypes.c_int, f, f, vp]
    lib.nddwt_fista_step.restype = ctypes.c_int
    lib.nddwt_error_string.argtypes = [ctypes.c_int]
    lib.nddwt_error_string.restype = ctypes.c_char_p
    return lib


def mag_shrink_pair(y_pair, lam):
    """Joint re/im magnitude soft-threshold of the detail bands of a
    split-complex band-first ``(2, B, *s)`` array; band 0 passes through.
    Returns a new array."""
    if not y_pair.is_cuda:
        return mag_shrink_pair_ref(y_pair, lam)
    if y_pair.ndim < 3 or y_pair.shape[0] != 2:
        raise ValueError(
            f"expected a (2, B, *spatial) split band array, got {tuple(y_pair.shape)}"
        )
    cuda_kernels.check_array("y_pair", y_pair)
    n = y_pair[0].numel()
    if n == 0:
        return torch.empty_like(y_pair)
    with tracing.span("nddwt.launch.nddwt_mag_shrink_pair"):
        out = torch.empty_like(y_pair)
        lib = load()
        with torch.cuda.device(y_pair.device):
            err = lib.nddwt_mag_shrink_pair(
                y_pair.data_ptr(), out.data_ptr(),
                cuda_kernels.DTYPE_CODE[y_pair.dtype], n, y_pair[0, 0].numel(),
                float(lam), torch.cuda.current_stream().cuda_stream,
            )
        cuda_kernels.raise_on(lib, err, "nddwt_mag_shrink_pair")
        cuda_kernels.launch_counts["nddwt_mag_shrink_pair"] += 1
    return out


def fista_step(x_new, x_prev, mask, b, mom: float, step: float):
    """One fused FISTA glue pass: ``v = z - step * M(M z - b)`` with
    ``z = x_new + mom * (x_new - x_prev)``. ``x_prev`` and ``b`` have
    ``x_new``'s shape; ``mask`` too, or that shape without a leading pair
    axis of 2 (split-complex data: one mask for both components). ``mom``
    and ``step`` are host floats. Returns a new array."""
    if not x_new.is_cuda:
        return fista_step_ref(x_new, x_prev, mask, b, mom, step)
    shape = tuple(x_new.shape)
    for name, t in (("x_prev", x_prev), ("b", b)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {shape}")
    if tuple(mask.shape) == shape:
        reps = 1
    elif shape[:1] == (2,) and tuple(mask.shape) == shape[1:]:
        reps = 2
    else:
        raise ValueError(
            f"mask {tuple(mask.shape)} fits neither {shape} nor its pair axis"
        )
    cuda_kernels.check_array("x_new", x_new)
    for name, t in (("x_prev", x_prev), ("mask", mask), ("b", b)):
        cuda_kernels.check_array(name, t, x_new)
    n = mask.numel()
    if n == 0:
        return torch.empty_like(x_new)
    with tracing.span("nddwt.launch.nddwt_fista_step"):
        out = torch.empty_like(x_new)
        lib = load()
        with torch.cuda.device(x_new.device):
            err = lib.nddwt_fista_step(
                x_new.data_ptr(), x_prev.data_ptr(), mask.data_ptr(), b.data_ptr(),
                out.data_ptr(), cuda_kernels.DTYPE_CODE[x_new.dtype], n, reps,
                float(mom), float(step), torch.cuda.current_stream().cuda_stream,
            )
        cuda_kernels.raise_on(lib, err, "nddwt_fista_step")
        cuda_kernels.launch_counts["nddwt_fista_step"] += 1
    return out
