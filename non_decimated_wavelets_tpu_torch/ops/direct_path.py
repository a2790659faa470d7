"""Direct (spatial-domain stencil) path for the non-decimated DWT, in torch.

Port of ``non_decimated_wavelets_tpu/ops/direct_path.py``. Each axis pass is
a K-tap periodic circular correlation

    ``y_c[n] = sum_j taps_c[j] * x[(n + j - (K//2 - 1)) % N]``

which is numerically identical to the reference's FFT path with its
half-filter-length phase advance (``Functions/nd_dwt_1D.m:274``).

This is the port's CPU path, and the plain reference that the CUDA kernels
(``ops/cuda_kernels.py``) are held against: its semantics are kept exactly —
band-first ``(B, *spatial)`` layout, analysis anchor ``o = K//2 - 1``, the
adjoint with reversed taps at ``K - 1 - o``, undilated taps at every level
(the reference re-filters the full-resolution approximation with the same
filters, ``Functions/nd_dwt_1D.m:181``; not a trous), and a ``/2^d`` per
synthesis level when not ``preserve_l2``.

``taps`` is one ``(2, K)`` array per spatial axis (lo row 0, hi row 1), a
numpy array or a CPU tensor; the values are read as Python floats, so the
arithmetic runs in the data's dtype.
"""

from __future__ import annotations

import torch


def _tap_rows(t):
    """(lo, hi) Python-float lists from one (2, K) tap array."""
    rows = t.tolist()
    return rows[0], rows[1]


def _circ_pad(x: torch.Tensor, axis: int, left: int, right: int) -> torch.Tensor:
    """Circularly pad one axis: [x[-left:], x, x[:right]]."""
    n = x.shape[axis]
    parts = []
    if left:
        parts.append(x.narrow(axis, n - left, left))
    parts.append(x)
    if right:
        parts.append(x.narrow(axis, 0, right))
    return torch.cat(parts, dim=axis) if len(parts) > 1 else x


def _corr_pair(x: torch.Tensor, taps, axis: int, padded: bool = False):
    """One axis pass: (lo, hi) K-tap circular correlations sharing reads.
    ``padded``: ``x`` already carries its halo on ``axis`` (``o`` rows in
    front, ``K - 1 - o`` behind, e.g. a sharded block with its ring
    neighbours' rows), so the pass is a valid correlation and the output is
    ``K - 1`` shorter there."""
    lo_t, hi_t = _tap_rows(taps)
    K = len(lo_t)
    o = K // 2 - 1
    if padded:
        n, xp = x.shape[axis] - (K - 1), x
    else:
        n, xp = x.shape[axis], _circ_pad(x, axis, o, K - 1 - o)
    acc_lo = acc_hi = None
    for j in range(K):
        r = xp.narrow(axis, j, n)
        tl = lo_t[j] * r
        th = hi_t[j] * r
        acc_lo = tl if acc_lo is None else acc_lo + tl
        acc_hi = th if acc_hi is None else acc_hi + th
    return acc_lo, acc_hi


def _adj_pair(lo: torch.Tensor, hi: torch.Tensor, taps, axis: int,
              padded: bool = False):
    """Adjoint of :func:`_corr_pair`: sum of the two transposed correlations.

    The adjoint of ``y[n] = sum_j t[j] x[n+j-o]`` is
    ``x[m] = sum_j t[j] y[m-j+o]``; ``y[m-j+o]`` sits at padded index
    ``m + K-1-j`` after a (K-1-o, o) circular pad. ``padded``: ``lo`` and
    ``hi`` already carry that (K-1-o, o) halo on ``axis``.
    """
    lo_t, hi_t = _tap_rows(taps)
    K = len(lo_t)
    o = K // 2 - 1
    if padded:
        n, lp, hp = lo.shape[axis] - (K - 1), lo, hi
    else:
        n = lo.shape[axis]
        lp = _circ_pad(lo, axis, K - 1 - o, o)
        hp = _circ_pad(hi, axis, K - 1 - o, o)
    acc = None
    for j in range(K):
        start = K - 1 - j
        term = lo_t[j] * lp.narrow(axis, start, n) + hi_t[j] * hp.narrow(
            axis, start, n
        )
        acc = term if acc is None else acc + term
    return acc


def _level1_dec(x: torch.Tensor, taps: tuple, padded=None) -> torch.Tensor:
    """(2^d, *spatial) bands from (*spatial); band bit k = H on axis k.
    ``padded[k]``: spatial axis k of ``x`` already carries the analysis
    halo (:func:`_corr_pair`)."""
    ndim = len(taps)
    T = x.unsqueeze(0)
    for ax in range(ndim):
        sp_axis = T.ndim - ndim + ax
        lo, hi = _corr_pair(T, taps[ax], sp_axis, bool(padded and padded[ax]))
        T = torch.cat([lo, hi], dim=0)
    return T


def _level1_rec(group: torch.Tensor, taps: tuple, padded=None) -> torch.Tensor:
    """Adjoint of :func:`_level1_dec`: (2^d, *spatial) -> (*spatial).
    ``padded[k]``: spatial axis k of ``group`` already carries the
    synthesis halo (:func:`_adj_pair`)."""
    ndim = len(taps)
    T = group
    for ax in reversed(range(ndim)):
        nb = T.shape[0]
        sp_axis = T.ndim - ndim + ax
        T = _adj_pair(T[: nb // 2], T[nb // 2 :], taps[ax], sp_axis,
                      bool(padded and padded[ax]))
    return T[0] if T.ndim > ndim else T


def dec_direct(x: torch.Tensor, taps: tuple, level: int) -> torch.Tensor:
    """Multilevel analysis, direct path. Returns ``(B, *spatial)``: the
    deepest approximation first, then the detail groups deepest first."""
    groups = []
    approx = x
    for _ in range(level):
        bands = _level1_dec(approx, taps)
        approx = bands[0]
        groups.append(bands[1:])
    return torch.cat([approx.unsqueeze(0)] + groups[::-1], dim=0)


def rec_direct(
    y: torch.Tensor, taps: tuple, level: int, preserve_l2: bool
) -> torch.Tensor:
    """Multilevel synthesis, direct path, from ``(B, *spatial)`` bands.

    Extra dims between the band axis and the spatial axes pass through."""
    nb = 2 ** len(taps)

    def synth(group):
        acc = _level1_rec(group, taps)
        return acc if preserve_l2 else acc / nb

    acc = synth(y[:nb])
    pos = nb
    for _ in range(1, level):
        acc = synth(torch.cat([acc.unsqueeze(0), y[pos : pos + nb - 1]], dim=0))
        pos += nb - 1
    return acc
