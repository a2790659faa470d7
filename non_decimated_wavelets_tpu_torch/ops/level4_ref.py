"""Plain torch versions of the four 4D stage kernels.

Each function has exactly its kernel's contract (``csrc/nddwt_4d.cu``),
which is the contract of the TPU kernel it replaces
(``non_decimated_wavelets_tpu/ops/pallas_4d.py``): storage in the array
dtype, the intermediate bands too; compute in float32 (float64 for float64
arrays) with full-precision taps.

A level of a ``d``-D array (``d`` = 4, or 3 for the long-filter route of
``cuda_kernels.dec_levels``) has *lead* axes 0 and 1 and *lane* axes 2 ..
``d - 1``. The lane stage gives ``nl = 2^(d - 2)`` bands, band bit ``k`` the
high pass on lane axis ``k``; the lead stage turns lane band ``c`` into
bands ``a + 4 c``, ``a = xbit + 2 ybit``: the band order of
``ops/direct_path.py``. ``taps``: one (2, K) float64 array per axis (the
plan's ``taps_hp``). The CPU tests and ``chip_smoke.py`` hold the kernels
against these; nothing on the CUDA path calls them, and the kernel wrappers
use them only for tensors on the CPU.

``padded`` (flags for the lead axes 0 and 1) is the lead stage's
halo-padded mode, as in ``level_ref``: a flagged axis of the input carries
its ring neighbours' rows and is sliced, not circularly padded
(``_lead_dec_call``/``_lead_adj_call`` with ``shape_xy=``/``padded=``).
"""

from __future__ import annotations

import torch

from ..models.denoise import soft_threshold
from .direct_path import _adj_pair, _corr_pair, _level1_dec, _level1_rec
from .level_ref import _compute_dtype


def lane_dec_ref(x, taps):
    """``(*s)`` -> ``(nl, *s)``: the lane axes' lo/hi correlations
    (``pallas_4d._lane_dec_call``)."""
    bands = _level1_dec(x.to(_compute_dtype(x.dtype)), taps[2:])
    return bands.to(x.dtype)


def lead_dec_ref(temp, big, band_off, taps, lam=0.0, final=False, padded=None):
    """``(nl, *s)`` lane bands -> the ``4 nl`` bands of the level
    (``pallas_4d._lead_dec_call``). The details go into
    ``big[band_off : band_off + 4 nl - 1]``, soft-thresholded by ``lam``
    when ``lam > 0``; with ``final`` the approximation goes into ``big[0]``
    and ``None`` is returned, otherwise it is returned. ``padded``: the
    halo-padded lead axes of ``temp``."""
    v = temp.to(_compute_dtype(temp.dtype)).unsqueeze(0)  # (1, nl, *s)
    for ax in (0, 1):
        lo, hi = _corr_pair(v, taps[ax], 2 + ax, bool(padded and padded[ax]))
        v = torch.cat([lo, hi], dim=0)
    bands = v.transpose(0, 1).reshape((-1,) + tuple(v.shape[2:]))
    details = bands[1:]
    if lam > 0:
        details = soft_threshold(details, lam)
    big[band_off : band_off + details.shape[0]] = details.to(big.dtype)
    if final:
        big[0] = bands[0].to(big.dtype)
        return None
    return bands[0].to(temp.dtype)


def lead_adj_ref(y, approx, band_src, taps, padded=None):
    """Adjoint of :func:`lead_dec_ref` on the ``4 nl`` bands named by
    ``band_src`` (``("y", i)`` is ``y[i]``, ``("a", 0)`` is ``approx``):
    ``partial[c] = sum_a adj(band[a + 4 c])``, ``(nl, *s)``
    (``pallas_4d._lead_adj_call``). ``padded``: the halo-padded lead axes
    of ``y`` and ``approx``, which the output drops."""
    cdt = _compute_dtype(y.dtype)
    group = torch.stack(
        [(approx if kind == "a" else y[idx]).to(cdt) for kind, idx in band_src]
    )
    v = group.reshape((-1, 4) + tuple(group.shape[1:])).transpose(0, 1)
    for ax in (1, 0):
        nb = v.shape[0]
        v = _adj_pair(v[: nb // 2], v[nb // 2 :], taps[ax], 2 + ax,
                      bool(padded and padded[ax]))
    return v[0].to(y.dtype)


def lane_adj_ref(partial, taps, scale):
    """Adjoint of :func:`lane_dec_ref` times ``scale``: ``(nl, *s)`` ->
    ``(*s)`` (``pallas_4d._lane_adj_call``)."""
    acc = _level1_rec(partial.to(_compute_dtype(partial.dtype)), taps[2:])
    if scale != 1.0:
        acc = acc * scale
    return acc.to(partial.dtype)
