"""Plain torch versions of the solvers' two elementwise CUDA kernels.

Each function has exactly its kernel's contract (``csrc/nddwt_elemwise.cu``),
which is the contract of the TPU kernel it replaces
(``non_decimated_wavelets_tpu/ops/pallas_elemwise.py`` ``mag_shrink_pair``
and ``fista_step``): storage in the array dtype, compute in float32
(float64 for float64 arrays). The CPU tests and ``chip_smoke.py`` hold the
kernels against these; the kernel wrappers (``ops/elemwise.py``) use them
only for tensors on the CPU.
"""

from __future__ import annotations

from ..models.denoise import soft_threshold_mag_pair
from .level_ref import _compute_dtype


def mag_shrink_pair_ref(y_pair, lam):
    """Joint re/im magnitude soft-threshold of the detail bands of a
    split-complex band-first ``(2, B, *s)`` array; band 0 passes through."""
    cdt = _compute_dtype(y_pair.dtype)
    return soft_threshold_mag_pair(y_pair.to(cdt), lam).to(y_pair.dtype)


def fista_step_ref(x_new, x_prev, mask, b, mom, step):
    """``v = z - step * m * (m * z - b)`` with ``z = x_new + mom * (x_new -
    x_prev)``. ``mask`` has ``x_new``'s shape, or its shape without the
    leading pair axis (then it applies to both components)."""
    cdt = _compute_dtype(x_new.dtype)
    xn = x_new.to(cdt)
    z = xn + mom * (xn - x_prev.to(cdt))
    m = mask.to(cdt)
    return (z - step * (m * (m * z - b.to(cdt)))).to(x_new.dtype)
