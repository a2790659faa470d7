"""Plain-torch replays of the streamed kernels' schedules.

``csrc/nddwt_stream.cuh`` holds two bodies over a 3-slot view, in which
each CTA owns a plane tile ``(T1, T2)`` on slots 1 and 2 and a chunk of
``C`` outputs on slot 0, and walks the chunk's ``C + K0 - 1`` input planes:

* the synthesis (``nddwt_rec_level``, ``nddwt_lead_adj``): per plane the
  in-plane adjoint of each band window (slot 2, then slot 1), scattered
  into a ring of ``K0`` partial output planes whose front is written once
  it is complete;
* the analysis (``nddwt_dec_level``, ``nddwt_lead_dec``): per plane the
  in-plane lo/hi passes of the input's window (slot 2, then slot 1) into
  ``G`` in-plane bands, a ring of the last ``K0`` planes of them, and each
  output plane's lo/hi along slot 0 gathered from the ring; ``gw`` bands a
  walk, the chunk walked ``G / gw`` times.

``csrc/nddwt_lane.cuh`` holds the lane body of ``nddwt_lane_dec`` and
``nddwt_lane_adj`` over the lane view ``(X*Y, Z, T)``: persistent CTAs walk
units of whole ``(Z, T)`` slabs (or one slab's chunk of Z with its halo
rows), each copied by bulk copies into a ring of unit buffers, then the
T and Z passes (the analysis) or the Z and T adjoints (the adjoint) run on
the unit in shared memory. ``lane_replay`` replays it.

``stream_replay`` and ``stream_ana_replay`` do the same walks with torch
ops, CTA by CTA: the grid and chunks the plan function lays out, the
windows each CTA loads (the wrapped or halo-padded input rows and columns,
computed as the kernel computes them, with its range assumptions asserted),
the passes, the ring and its emits. The tests hold them against the plain
versions (``level_ref.rec_level_ref``, ``level4_ref.lead_adj_ref``,
``level_ref.dec_level_ref``, ``level4_ref.lead_dec_ref``,
``level4_ref.lane_dec_ref``, ``level4_ref.lane_adj_ref``) for the geometry
that ``cuda_kernels`` builds (``rec_stream_args``, ``_dec_stream_geometry``,
``_stage_geometry``, ``_walk_bands``, ``_lane_plan``), so a plan that drops,
repeats or misplaces a plane, a row or a band fails here. Nothing on the
CUDA path calls them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.denoise import soft_threshold
from .level_ref import _compute_dtype

THREADS = 256  # kThreads in the sources


def _window_index(p, n, left, padded):
    """Input index of window positions ``p`` on one slot: ``p + left`` on a
    halo-padded slot (inside its extent ``n + K - 1``), else ``p`` wrapped
    once, which the kernel's ``wrap2`` assumes lies in ``[-n, 2n)``."""
    if padded:
        return p + left
    assert p.min() >= -n and p.max() < 2 * n, "window beyond wrap2's range"
    return torch.where(p < 0, p + n, torch.where(p >= n, p - n, p))


def _corr(w, tp, axis):
    """out[c] = sum_j tp[j] * w[c + j] along ``axis`` (valid part)."""
    K = tp.shape[0]
    return torch.tensordot(w.unfold(axis, K, 1), tp, dims=([w.ndim], [0]))


def stream_replay(y, approx, idx, n, k, t, left, bit, pad, arr, groups, scale,
                  items):
    """The launch's output ``(groups, *n)``: ``y`` is the band array on the
    view, ``(B, m0, m1, m2)`` (``m`` = ``n`` plus ``k - 1`` on a padded
    slot), ``approx`` one such band or None, ``idx`` the 16-entry band
    table (-1: ``approx``), ``n, k, t, left, bit, pad`` the view geometry
    with ``t = (C, T1, T2)``, ``arr`` the (3, 2, kMaxTaps) tap array,
    ``items`` the plane elements per thread of the instantiation."""
    cdt = _compute_dtype(y.dtype)
    C, T1, T2 = t
    assert C >= 1 and T2 & (T2 - 1) == 0 and T1 * T2 == THREADS * items
    assert k[0] >= 2 and 1 <= groups <= 4
    ins = [n[a] + (k[a] - 1 if pad[a] else 0) for a in range(3)]
    assert tuple(y.shape[1:]) == tuple(ins)
    taps = torch.as_tensor(np.asarray(arr), dtype=cdt)
    ns = [2 if k[a] > 1 else 1 for a in range(3)]
    out = torch.full((groups,) + tuple(n), float("nan"), dtype=cdt)
    written = torch.zeros((groups,) + tuple(n), dtype=torch.int32)
    K0 = k[0]
    for bz in range(-(-n[0] // C)):
        for by in range(-(-n[1] // T1)):
            for bx in range(-(-n[2] // T2)):
                p0, o1, o2 = bz * C, by * T1, bx * T2
                cc = min(C, n[0] - p0)
                w1, w2 = min(T1, n[1] - o1), min(T2, n[2] - o2)
                rows = _window_index(o1 - left[1] + torch.arange(w1 + k[1] - 1),
                                     n[1], left[1], pad[1])
                cols = _window_index(o2 - left[2] + torch.arange(w2 + k[2] - 1),
                                     n[2], left[2], pad[2])
                for gi in range(groups):
                    ring = torch.zeros((K0, w1, w2), dtype=cdt)
                    for r in range(cc + K0 - 1):
                        g0 = _window_index(torch.tensor([p0 - left[0] + r]), n[0],
                                           left[0], pad[0])
                        for s0 in range(2):
                            P = torch.zeros((w1, w2), dtype=cdt)
                            for s1 in range(ns[1]):
                                Q = torch.zeros((w1 + k[1] - 1, w2), dtype=cdt)
                                for s2 in range(ns[2]):
                                    band = (s0 << bit[0] | s1 << bit[1]
                                            | s2 << bit[2]) + 4 * gi
                                    b = approx if idx[band] < 0 else y[idx[band]]
                                    w = b[g0[0]][rows][:, cols].to(cdt)
                                    Q += _corr(w, taps[2, s2, :k[2]], 1)
                                P += _corr(Q, taps[1, s1, :k[1]], 0)
                            # ring[m] += tap0[K0 - 1 - m] * P
                            ring += taps[0, s0, :K0].flip(0)[:, None, None] * P
                        if r >= K0 - 1:
                            q0 = p0 + r - (K0 - 1)
                            out[gi, q0, o1:o1 + w1, o2:o2 + w2] = ring[0] * scale
                            written[gi, q0, o1:o1 + w1, o2:o2 + w2] += 1
                        ring = torch.cat([ring[1:], torch.zeros_like(ring[:1])])
    assert bool((written == 1).all()), "an output written other than once"
    return out.to(y.dtype)


def stream_ana_replay(x, big, approx_out, band_off, n, k, t, gw, left, bit, pad,
                      arr, groups, lam, items):
    """Write the launch's bands as the kernel does: band ``d`` into
    ``big[band_off + d - 1]`` (shrunk by ``lam > 0``), ``d == 0`` into
    ``approx_out``. ``x`` holds the ``groups`` inputs on the view,
    ``(groups, m0, m1, m2)`` (``m`` = ``n`` plus ``k - 1`` on a padded
    slot); ``big`` and ``approx_out`` are views of the outputs,
    ``(B, *n)`` and ``n``; ``n, k, t, left, bit, pad`` the view geometry
    with ``t = (C, T1, T2)``, ``gw`` the in-plane bands a walk keeps,
    ``arr`` the (3, 2, kMaxTaps) tap array, ``items`` the plane elements
    per thread of the instantiation."""
    cdt = _compute_dtype(x.dtype)
    C, T1, T2 = t
    G = (2 if k[1] > 1 else 1) * (2 if k[2] > 1 else 1)
    assert C >= 1 and T2 & (T2 - 1) == 0 and T1 * T2 == THREADS * items
    assert k[0] >= 2 and 1 <= groups <= 4 and G % gw == 0
    ins = [n[a] + (k[a] - 1 if pad[a] else 0) for a in range(3)]
    assert tuple(x.shape) == (groups, *ins)
    taps = torch.as_tensor(np.asarray(arr), dtype=cdt)
    lgs1 = 1 if k[1] > 1 else 0
    K0 = k[0]
    written = torch.zeros((2 * G * groups,) + tuple(n), dtype=torch.int32)
    for bz in range(-(-n[0] // C)):
        for by in range(-(-n[1] // T1)):
            for bx in range(-(-n[2] // T2)):
                p0, o1, o2 = bz * C, by * T1, bx * T2
                cc = min(C, n[0] - p0)
                w1, w2 = min(T1, n[1] - o1), min(T2, n[2] - o2)
                rows = _window_index(o1 - left[1] + torch.arange(w1 + k[1] - 1),
                                     n[1], left[1], pad[1])
                cols = _window_index(o2 - left[2] + torch.arange(w2 + k[2] - 1),
                                     n[2], left[2], pad[2])
                for gi in range(groups):
                    for wk in range(G // gw):
                        bands = range(wk * gw, (wk + 1) * gw)
                        ring = []  # the last K0 planes' in-plane bands
                        for r in range(cc + K0 - 1):
                            g0 = _window_index(torch.tensor([p0 - left[0] + r]), n[0],
                                               left[0], pad[0])
                            w = x[gi, g0[0]][rows][:, cols].to(cdt)
                            if k[1] > 1 and k[2] > 1:  # slot 2 into Q, then slot 1
                                q = {h: _corr(w, taps[2, h, :k[2]], 1)
                                     for h in {b >> 1 for b in bands}}
                                vals = {b: _corr(q[b >> 1], taps[1, b & 1, :k[1]], 0)
                                        for b in bands}
                            elif k[1] == 1:  # 2D: one row, slot 2
                                vals = {b: _corr(w, taps[2, b, :k[2]], 1) for b in bands}
                            else:  # the lead stage: slot 1, slot 2 passes through
                                vals = {b: _corr(w, taps[1, b, :k[1]], 0) for b in bands}
                            ring = (ring + [vals])[-K0:]
                            if r < K0 - 1:
                                continue
                            q0 = p0 + r - (K0 - 1)
                            at = (q0, slice(o1, o1 + w1), slice(o2, o2 + w2))
                            for b in bands:
                                # both s0 of band b, gathered over the ring
                                lohi = torch.tensordot(
                                    taps[0, :, :K0], torch.stack([v[b] for v in ring]),
                                    dims=([1], [0]))
                                s1, s2 = b & lgs1, b >> lgs1
                                for s0 in range(2):
                                    d = (s0 << bit[0] | s1 << bit[1] | s2 << bit[2]) + 4 * gi
                                    v = lohi[s0]
                                    if d == 0:
                                        approx_out[at] = v.to(approx_out.dtype)
                                    else:
                                        if lam > 0:
                                            v = soft_threshold(v, lam)
                                        big[(band_off + d - 1,) + at] = v.to(big.dtype)
                                    written[(d,) + at] += 1
    assert bool((written == 1).all()), "an output written other than once"


def _lane_bulk(a, n, size, tlo, thi):
    """The bytes ``[lo, hi)`` a piece of ``n`` elements at byte address
    ``a`` takes in bulk (``lane_bulk``): rounded out to 16 bytes, in where
    that leaves the tensor ``[tlo, thi)``; and the elements ``[e_lo, e_hi)``
    of the piece that arrive so (the rest by plain loads)."""
    b = a + n * size
    lo = a & ~15
    if lo < tlo:
        lo += 16
    hi = (b + 15) & ~15
    if hi > thi:
        hi -= 16
    if hi <= lo:
        return lo, lo, 0, 0
    return lo, hi, (lo - a) // size if lo > a else 0, (hi - a) // size if hi < b else n


def _lane_runs(K, bounds, start):
    """The runs of taps ``lane_zruns``/``lane_truns`` take: taps ``0 ..
    K - 1`` split at ``bounds`` (the taps where the wrap or a piece's end
    falls), each run ``(j0, j1, first index)`` with ``start(j0)``; as a
    list of indices, tap by tap."""
    cuts = [0] + [min(K, max(0, b)) for b in bounds] + [K]
    cuts = [max(c, cuts[i]) for i, c in enumerate(cuts[1:])]
    out, j0 = [], 0
    for j1 in cuts:
        if j1 > j0:
            out += [start(j0) + (j - j0) for j in range(j0, j1)]
        j0 = max(j0, j1)
    return out


def lane_replay(src, n, k, t, left, arr, adj, scale=1.0, ctas=264, shift=0):
    """One lane body launch (``csrc/nddwt_lane.cuh``), CTA by CTA and unit
    by unit: the analysis's lane bands ``(nl, *n)`` from ``src`` shaped
    ``n``, or the adjoint's ``scale *`` output ``n`` from the lane bands
    ``src`` shaped ``(nl, *n)``. ``n, k, t, left`` the view geometry with
    the plan ``t = (R, Zc, stages)``, ``arr`` the (3, 2, kMaxTaps) tap
    array (reversed for the adjoint), ``ctas`` the grid, ``shift`` the
    input's byte address mod 16 (the kernel's pieces, bulk copies and plain
    loads follow from it).

    Per unit, every input array's pieces are copied as the kernel copies
    them into a window of the plan's size that holds nothing else (NaN):
    the bulk bytes, asserted 16-byte aligned, inside the tensor and the
    window, then the ragged elements; the passes read the window through
    the kernel's row offsets (the Z rows wrapped or clamped as
    ``lane_row``, the T columns wrapped), and every output is written
    once."""
    cdt = _compute_dtype(src.dtype)
    n0, Z, T = n
    K1, K2 = k[1], k[2]
    R, Zc, stages = t
    assert stages >= 1 and Zc >= 1 and K1 >= 2 and Z >= K1 and T >= K2
    whole = Zc >= Z
    R = max(R, 1) if whole else 1
    ew_plan = Z if whole else Zc + K1 - 1
    assert ew_plan <= Z
    nch = 1 if whole else -(-Z // Zc)
    units = -(-n0 // R) if whole else n0 * nch
    nin = (4 if K2 > 1 else 2) if adj else 1
    nl = 2 if K2 == 1 else 4
    vox = n0 * Z * T
    assert tuple(src.shape) == ((nl,) if adj else ()) + tuple(n)
    flat = src.reshape(-1)
    size = src.element_size()
    vec = 16 // size
    tlo = 16 * 4096 + shift
    thi = tlo + nin * vox * size
    wb = -(-R * ew_plan * T // vec) * vec + 3 * vec
    taps = torch.as_tensor(np.asarray(arr), dtype=cdt)
    tcols = torch.tensor([[(c + T) % T for c in range(tt - left[2], tt - left[2] + K2)]
                          for tt in range(T)])  # (T, K2): one wrap, as lane_wrap
    for tt in range(T):  # and as the runs of lane_truns
        c0 = tt - left[2]
        assert _lane_runs(K2, [-c0, T - c0], lambda j0: (c0 + j0) % T) == tcols[tt].tolist()
    out = torch.full(((nl,) if not adj else ()) + tuple(n), float("nan"), dtype=cdt)
    written = torch.zeros(out.shape, dtype=torch.int32)
    grid = min(ctas, units)
    for c in range(grid):
        for u in range(c, units, grid):
            if whole:
                s0, z0, zc, ew = u * R, 0, Z, Z
                ru = min(R, n0 - s0)
            else:
                s0, ch = divmod(u, nch)
                z0 = ch * Zc
                zc, ru = min(Zc, Z - z0), 1
                ew = zc + K1 - 1
            rows = []
            for i in range(nin):
                window = torch.full((wb,), float("nan"), dtype=src.dtype)
                slab = i * vox + s0 * Z * T
                if whole:
                    pieces = [(slab, ru * Z * T, (tlo + slab * size) % 16 // size)]
                    na = ru * Z
                else:
                    zs = z0 - left[1] + (Z if z0 < left[1] else 0)
                    na = min(Z - zs, ew)
                    g = slab + zs * T
                    pieces = [(g, na * T, (tlo + g * size) % 16 // size)]
                    if ew > na:
                        start = -(-(pieces[0][2] + na * T) // vec) * vec
                        pieces.append((slab, (ew - na) * T, start + (tlo + slab * size) % 16 // size))
                for g, m, at in pieces:
                    a = tlo + g * size
                    lo, hi, e_lo, e_hi = _lane_bulk(a, m, size, tlo, thi)
                    if hi > lo:
                        assert lo % 16 == 0 and hi % 16 == 0 and tlo <= lo and hi <= thi
                        dst = at * size - (a - lo)
                        assert dst >= 0 and dst + (hi - lo) <= wb * size and dst % 16 == 0
                        e0 = (lo - tlo) // size
                        window[dst // size:(dst + hi - lo) // size] = flat[e0:e0 + (hi - lo) // size]
                    for e in list(range(e_lo)) + list(range(e_hi, m)):
                        window[at + e] = flat[g + e]
                    assert e_lo < vec and m - e_hi < vec or hi <= lo
                offs = [(pieces[0][2] if L < na else pieces[-1][2] - na * T) + L * T
                        for L in range(ru * ew)]
                rows.append(window[torch.tensor(offs)[:, None] + torch.arange(T)].to(cdt))

            def zrows(r, z):
                """Window rows of output z's K1 taps in slab r: one wrap, as
                lane_row (unrolled taps) does, and the same as the runs of
                lane_zruns (runtime taps), each run inside one slab and
                one piece of the window."""
                if whole:
                    ls = [z + j - left[1] for j in range(K1)]
                    ls = [r * Z + (l + Z if l < 0 else (l - Z if l >= Z else l)) for l in ls]
                    l0 = z - left[1]
                    runs = _lane_runs(K1, [-l0, Z - l0], lambda j0: r * Z + (
                        l0 + j0 + Z if j0 < -l0 else (l0 + j0 - Z if l0 + j0 >= Z else l0 + j0)))
                    assert all(r * Z <= L < r * Z + Z for L in ls)
                else:
                    ls = [z + j for j in range(K1)]
                    runs = _lane_runs(K1, [na - z], lambda j0: z + j0)
                    assert all(L < ew for L in ls)
                assert runs == ls
                return ls

            idx = torch.tensor([zrows(r, z) for r in range(ru) for z in range(zc)])  # (ru * zc, K1)
            at = (slice(s0, s0 + ru), slice(z0, z0 + zc))
            if not adj:
                w = rows[0]
                halves = ([torch.tensordot(w[:, tcols], taps[2, s, :K2], dims=([2], [0]))
                           for s in range(2)] if K2 > 1 else [w])
                for h, q in enumerate(halves):
                    for s in range(2):
                        v = torch.tensordot(q[idx], taps[1, s, :K1], dims=([1], [0]))
                        d = 2 * h + s
                        out[(d,) + at] = v.reshape(ru, zc, T)
                        written[(d,) + at] += 1
            else:
                qs = []
                for s2 in range(nin // 2):
                    acc = torch.zeros(ru * zc, T, dtype=cdt)
                    for s1 in range(2):
                        acc = acc + torch.tensordot(rows[s1 + 2 * s2][idx], taps[1, s1, :K1],
                                                    dims=([1], [0]))
                    qs.append(acc)
                if K2 > 1:
                    v = sum(torch.tensordot(q[:, tcols], taps[2, s2, :K2], dims=([2], [0]))
                            for s2, q in enumerate(qs))
                else:
                    v = qs[0]
                out[at] = (v * scale).reshape(ru, zc, T)
                written[at] += 1
    assert bool((written == 1).all()), "an output written other than once"
    return out.to(src.dtype)
