"""Plain torch versions of the two one-launch CUDA kernels.

Each function has exactly its kernel's contract (``csrc/nddwt_flat.cu``),
which is the contract of the TPU kernels it replaces
(``non_decimated_wavelets_tpu/ops/pallas_flat.py`` ``_call`` and
``_call_iter``): storage in the array dtype, compute in float32 (float64 for
float64 arrays) with full-precision taps. The bands, and in the iterates the
state ``x`` and ``z``, are rounded to the storage dtype where the kernels
store them; the approximation chain and the synthesis sums stay in the
compute type. The CPU tests and ``chip_smoke.py`` hold the kernels against
these; the kernel wrappers (``ops/flat.py``) use them only for tensors on
the CPU.

Layouts: ``batch=0`` is one array ``(*s)`` with bands ``(B, *s)``; ``batch=2``
a split re/im pair ``(2, *s)`` with bands ``(2, B, *s)``, whose shrink is
the joint magnitude of the pair.
"""

from __future__ import annotations

import torch

from ..models.denoise import soft_threshold, soft_threshold_mag_pair
from .direct_path import dec_direct, rec_direct
from .level_ref import _compute_dtype


def _shrink(y, lam, batch):
    """Soft-threshold the details of compute-type bands: ``(B, *s)``, or
    ``(2, B, *s)`` jointly over the pair."""
    if not lam:
        return y
    if batch:
        return soft_threshold_mag_pair(y, lam)
    return torch.cat([y[:1], soft_threshold(y[1:], lam)])


def _dec(v, taps, level, batch):
    """Compute-type analysis of ``v``: ``(B, *s)`` or ``(2, B, *s)``."""
    y = dec_direct(v, taps, level)
    return y.transpose(0, 1) if batch else y


def _rec(y, taps, level, preserve_l2, batch):
    """Compute-type synthesis of compute-type bands."""
    return rec_direct(y.transpose(0, 1) if batch else y, taps, level, preserve_l2)


def _sweep(v, taps, level, preserve_l2, lam, batch, dtype):
    """dec -> shrink -> round the bands to ``dtype`` -> rec, in the compute
    type of ``v``; returns (stored bands, compute-type reconstruction)."""
    bands = _shrink(_dec(v, taps, level, batch), lam, batch).to(dtype)
    return bands, _rec(bands.to(v.dtype), taps, level, preserve_l2, batch)


def flat_pair_ref(mode, arr, taps, level, preserve_l2=False, lam=0.0, batch=0):
    """``nddwt_flat_pair``: mode ``'dec'`` (``arr`` the array -> bands),
    ``'rec'`` (``arr`` the bands -> array) or ``'pair'`` (array -> (bands
    with the details shrunk by ``lam``, reconstruction))."""
    cdt = _compute_dtype(arr.dtype)
    if mode == "rec":
        return _rec(arr.to(cdt), taps, level, preserve_l2, batch).to(arr.dtype)
    v = arr.to(cdt)
    if mode == "dec":
        return _shrink(_dec(v, taps, level, batch), lam, batch).to(arr.dtype)
    if mode != "pair":
        raise ValueError(f"mode must be 'dec', 'rec' or 'pair', got {mode!r}")
    bands, xr = _sweep(v, taps, level, preserve_l2, lam, batch, arr.dtype)
    return bands, xr.to(arr.dtype)


def flat_iter_ref(mode, arr, mask, taps, level, preserve_l2, lams, moms=None,
                  step=0.0, batch=0):
    """``nddwt_flat_iter``: mode ``'chain'`` runs ``x <- W^T shrink_i(W x)``
    for each ``lams[i]`` from ``x = arr``; mode ``'fista'`` runs FISTA on
    the masked data term from ``b = arr`` and ``mask`` (the spatial shape,
    shared by a pair): ``x_0 = z_0 = M b``, ``v = z - step M(M z - b)``,
    ``x+ = W^T shrink_i(W v)``, ``z+ = x+ + moms[i] (x+ - x)``. Returns the
    last ``x``."""
    dt = arr.dtype
    cdt = _compute_dtype(dt)
    if mode == "chain":
        x = arr
        for lam in lams:
            _, xr = _sweep(x.to(cdt), taps, level, preserve_l2, lam, batch, dt)
            x = xr.to(dt)
        return x
    if mode != "fista":
        raise ValueError(f"mode must be 'chain' or 'fista', got {mode!r}")
    m, b = mask.to(cdt), arr.to(cdt)
    x = z = (m * b).to(dt)
    for lam, mom in zip(lams, moms):
        zv = z.to(cdt)
        v = zv - step * (m * (m * zv - b))
        _, xr = _sweep(v, taps, level, preserve_l2, lam, batch, dt)
        z = (xr + mom * (xr - x.to(cdt))).to(dt)
        x = xr.to(dt)
    return x
