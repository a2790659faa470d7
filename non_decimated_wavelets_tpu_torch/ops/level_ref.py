"""Plain torch versions of the two per-level CUDA kernels.

Each function has exactly its kernel's contract (``csrc/nddwt_level.cu``),
which is the contract of the TPU kernels it replaces
(``non_decimated_wavelets_tpu/ops/pallas_kernels.py`` ``_fused_dec_level``
and ``_fused_rec_level``): storage in the array dtype, compute in float32
(float64 for float64 arrays) with full-precision taps. The CPU tests and
``chip_smoke.py`` hold the kernels against these; nothing on the CUDA path
calls them, and the kernel wrappers use them only for tensors on the CPU.

``padded`` (one flag per axis) is the halo-padded mode of the kernels: on a
flagged axis the input is one rank's block of a sharded axis with its ring
neighbours' rows around it (``cuda_kernels.halo_widths``: ``K//2 - 1`` in
front and ``K//2`` behind for the analysis, ``K//2`` and ``K//2 - 1`` for
the synthesis). Such an axis is sliced, not circularly padded, and the
outputs keep the block's extent: the concat "valid" mode of
``_fused_dec_level``/``_fused_rec_level`` (``shape=``/``padded=``).
"""

from __future__ import annotations

import torch

from ..models.denoise import soft_threshold
from .direct_path import _level1_dec, _level1_rec


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def dec_level_ref(approx, big, band_off, taps, lam=0.0, final=False,
                  padded=None):
    """One analysis level of the ``(B, *s)`` cascade.

    Writes the ``2^d - 1`` detail bands of ``approx`` into
    ``big[band_off : band_off + 2^d - 1]``, soft-thresholded by ``lam``
    when ``lam > 0`` (``v * max(|v| - lam, 0) / max(|v|, 1e-30)``, the
    shrink of ``pallas_kernels.py:509-515``). With ``final`` the
    approximation goes into ``big[0]`` and ``None`` is returned; otherwise
    the next approximation is returned (in the storage dtype). ``taps``:
    one (2, K) float64 array per axis (the plan's ``taps_hp``). ``padded``:
    the halo-padded axes of ``approx`` (module docstring).
    """
    bands = _level1_dec(approx.to(_compute_dtype(approx.dtype)), taps, padded)
    details = bands[1:]
    if lam > 0:
        details = soft_threshold(details, lam)
    big[band_off : band_off + details.shape[0]] = details.to(big.dtype)
    if final:
        big[0] = bands[0].to(big.dtype)
        return None
    return bands[0].to(approx.dtype)


def rec_level_ref(y, approx, band_src, taps, scale, padded=None):
    """One synthesis level: the adjoint of one analysis level applied to
    the ``2^d`` bands named by ``band_src`` — ``("y", i)`` is ``y[i]``,
    ``("a", 0)`` is ``approx`` — times ``scale``; returns ``(*s)``.
    ``padded``: the halo-padded axes of ``y`` and ``approx``, which the
    output drops."""
    cdt = _compute_dtype(y.dtype)
    group = torch.stack(
        [(approx if kind == "a" else y[idx]).to(cdt) for kind, idx in band_src]
    )
    acc = _level1_rec(group, taps, padded)
    if scale != 1.0:
        acc = acc * scale
    return acc.to(y.dtype)
