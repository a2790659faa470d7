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

``csrc/nddwt_plane.cuh`` holds the plane body, which runs
``nddwt_rec_level`` on 3D views with filters of 2 to 8 taps instead of the
streamed synthesis: a stage is one (input plane, s0), whose four band
windows arrive by bulk copies of their rows (split at the periodic wrap),
then the slot-1 pass (both s1 into two halves of Q), the slot-2 pass and
the ring. ``plane_replay`` replays it.

The same header holds the analysis plane body, which runs
``nddwt_dec_level`` on those views instead of the streamed analysis: a
stage is one input plane, whose window arrives the same way, then the
slot-1 lo/hi pass into Q, the slot-2 pass (each half of the CTA one s1)
and a ring of the last K planes' bands, gathered into each output plane's
bands. ``plane_ana_replay`` replays it.

``csrc/nddwt_lane.cuh`` holds the lane body of ``nddwt_lane_dec`` and
``nddwt_lane_adj`` over the lane view ``(X*Y, Z, T)``: persistent CTAs walk
units of whole ``(Z, T)`` slabs (or one slab's chunk of Z with its halo
rows), each copied by bulk copies into a ring of unit buffers, then the
T and Z passes (the analysis) or the Z and T adjoints (the adjoint) run on
the unit in shared memory. ``lane_replay`` replays it.

``csrc/nddwt_multi.cu`` runs the two streamed bodies for every level and
item of a batch in one launch of a persistent grid, a unit being one CTA
tile of the per-level launch of one item (a 2D batch folded into the
view's pass-through slot); ``multi_replay`` replays it, held against
``multi_ref.dec_multi_ref``/``rec_multi_ref``.

``csrc/nddwt_flat.cu`` holds the body of ``nddwt_flat_pair`` and
``nddwt_flat_iter``: one pass per axis group, level and direction, each
CTA copying a tile's window (the tile and its halo on the group's axes)
into shared memory and running the level's band tree there, on the plan
``flat._flat_plan`` lays out. ``flat_replay`` replays it, held against
``flat_ref.flat_pair_ref``/``flat_iter_ref``.

``stream_replay`` and ``stream_ana_replay`` do the same walks with torch
ops, CTA by CTA: the grid and chunks the plan function lays out, the
windows each CTA loads (the wrapped or halo-padded input rows and columns,
computed as the kernel computes them, with its range assumptions asserted),
the passes, the ring and its emits. The tests hold them against the plain
versions (``level_ref.rec_level_ref``, ``level4_ref.lead_adj_ref``,
``level_ref.dec_level_ref``, ``level4_ref.lead_dec_ref``,
``level4_ref.lane_dec_ref``, ``level4_ref.lane_adj_ref``) for the geometry
that ``cuda_kernels`` builds (``rec_stream_args``, ``dec_stream_args``,
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


def _syn_unit(band, dst, count, origin, n, k, t, left, bit, pad, taps, groups, scale):
    """One unit of the streamed synthesis (``stream_syn``), the CTA tile at
    ``origin = (p0, o1, o2)`` with ``t = (C, T1, T2)``: ``band(d)`` is band
    ``d``'s input on the view, ``(m0, m1, m2)`` (``m`` = ``n`` plus ``k - 1``
    on a padded slot), ``dst(gi)`` and ``count(gi)`` output group ``gi``'s
    array and write counts on the view, ``n``; ``taps`` the (3, 2, kMaxTaps)
    taps in the compute type."""
    cdt = taps.dtype
    C, T1, T2 = t
    p0, o1, o2 = origin
    ns = [2 if k[a] > 1 else 1 for a in range(3)]
    K0 = k[0]
    cc = min(C, n[0] - p0)
    w1, w2 = min(T1, n[1] - o1), min(T2, n[2] - o2)
    rows = _window_index(o1 - left[1] + torch.arange(w1 + k[1] - 1), n[1], left[1], pad[1])
    cols = _window_index(o2 - left[2] + torch.arange(w2 + k[2] - 1), n[2], left[2], pad[2])
    for gi in range(groups):
        ring = torch.zeros((K0, w1, w2), dtype=cdt)
        for r in range(cc + K0 - 1):
            g0 = _window_index(torch.tensor([p0 - left[0] + r]), n[0], left[0], pad[0])
            for s0 in range(2):
                P = torch.zeros((w1, w2), dtype=cdt)
                for s1 in range(ns[1]):
                    Q = torch.zeros((w1 + k[1] - 1, w2), dtype=cdt)
                    for s2 in range(ns[2]):
                        d = (s0 << bit[0] | s1 << bit[1] | s2 << bit[2]) + 4 * gi
                        w = band(d)[g0[0]][rows][:, cols].to(cdt)
                        Q += _corr(w, taps[2, s2, :k[2]], 1)
                    P += _corr(Q, taps[1, s1, :k[1]], 0)
                # ring[m] += tap0[K0 - 1 - m] * P
                ring += taps[0, s0, :K0].flip(0)[:, None, None] * P
            if r >= K0 - 1:
                q0 = p0 + r - (K0 - 1)
                at = (q0, slice(o1, o1 + w1), slice(o2, o2 + w2))
                dst(gi)[at] = ring[0] * scale
                count(gi)[at] += 1
            ring = torch.cat([ring[1:], torch.zeros_like(ring[:1])])


def _units(n, t, per):
    """The origins ``(p0, o1, o2)`` of a launch's CTA tiles over the view
    ``n`` with ``t = (C, T1, T2)``, ``per`` of them counted: slot 2
    fastest, as ``blockIdx`` (x, y, z) and the multilevel kernels' units
    number them."""
    C, T1, T2 = t
    t2n, t1n, t0n = -(-n[2] // T2), -(-n[1] // T1), -(-n[0] // C)
    assert per == t2n * t1n * t0n
    return [(z * C, y * T1, x * T2) for z in range(t0n) for y in range(t1n)
            for x in range(t2n)]


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
    out = torch.full((groups,) + tuple(n), float("nan"), dtype=cdt)
    written = torch.zeros((groups,) + tuple(n), dtype=torch.int32)
    units = _units(n, t, -(-n[0] // C) * -(-n[1] // T1) * -(-n[2] // T2))
    for origin in units:
        _syn_unit(lambda d: approx if idx[d] < 0 else y[idx[d]], out.__getitem__,
                  written.__getitem__, origin, n, k, t, left, bit, pad, taps, groups,
                  scale)
    assert bool((written == 1).all()), "an output written other than once"
    return out.to(y.dtype)


def _plane_pieces(o2, E2, n2, m2, left2, padded, vec):
    """The pieces of every window row of a plane-body CTA at column ``o2``
    (``plane_syn_kernel``): columns ``c0 .. c0 + E2 - 1`` split at the
    periodic wrap (none on a padded slot), each ``(lo, pd, m)``: ``m``
    elements from column ``lo`` of the input row (the piece's first column
    rounded down to ``vec``) to element ``pd`` of the buffer row; and the
    shift ``sh`` of window column 0 in the buffer row. Asserted: at most
    three pieces, each inside its row and on whole 16 bytes at both ends,
    each piece after the first starting where the one before it ends."""
    pieces, sh = [], 0
    a, d = (o2 if padded else o2 - left2), 0
    while d < E2:
        if padded:
            col, ln = a, E2
        else:
            assert -n2 <= a < 2 * n2, "window beyond wrap2's range"
            col = a + n2 if a < 0 else (a - n2 if a >= n2 else a)
            ln = min(E2 - d, n2 - col)
        lo, hi = col // vec * vec, -(-(col + ln) // vec) * vec
        if d == 0:
            sh = col - lo
        pd = sh + d - (col - lo)
        assert hi <= m2 and pd % vec == 0, "a piece leaves its row or 16 bytes"
        assert not pieces or pd == pieces[-1][1] + pieces[-1][2], "pieces apart"
        pieces.append((lo, pd, hi - lo))
        a, d = a + ln, d + ln
    assert len(pieces) <= 3
    return pieces, sh


def _plane_runs(q0, E1, n1, left1, padded):
    """The row runs of a whole-row window (``plane_syn_kernel``): window
    rows ``0 .. E1 - 1`` are input rows ``q0 .. q0 + E1 - 1`` (wrapped, or
    shifted by ``left1`` on a padded slot), as ``(input row, window row,
    rows)`` runs of consecutive input rows, at most three."""
    runs, l = [], 0
    while l < E1:
        q = q0 + l
        if padded:
            row, ln = q + left1, E1
        else:
            assert -n1 <= q < 2 * n1, "window beyond wrap2's range"
            row = q + n1 if q < 0 else (q - n1 if q >= n1 else q)
            ln = min(E1 - l, n1 - row)
        runs.append((row, l, ln))
        l += ln
    assert len(runs) <= 3
    return runs


def plane_replay(y, approx, idx, n, k, t, left, bit, pad, arr, scale, stages=2,
                 threads=512):
    """One ``nddwt_rec_level`` launch on the plane body
    (``csrc/nddwt_plane.cuh``), CTA by CTA and stage by stage; returns the
    output ``n``. ``y`` is the band array on the view, ``(B, m0, m1, m2)``
    (``m`` = ``n`` plus ``k - 1`` on a padded slot), its rows starting on
    16 bytes (every array taken as 16-byte aligned), ``approx`` one such
    band or None, ``idx`` the band table (-1: ``approx``), ``n, k, t,
    left, bit, pad`` the view geometry with the plan ``t = (C, T1, T2)``,
    ``arr`` the (3, 2, kMaxTaps) tap array (reversed), ``stages`` the stage
    buffers, ``threads`` the CTA's (kPlaneThreads).

    A stage is one (input plane, s0) of the chunk's walk. Its four (s1, s2)
    band windows are copied, as warp 0 copies them, into a stage buffer
    that holds nothing else (NaN): where the tile spans slot 2 (whole rows)
    in the row runs of ``_plane_runs``, else every row in the pieces of
    ``_plane_pieces``, the rounded bytes around a piece landing in the
    row's slack; a buffer is refilled with stage ``s + stages`` only after
    stage ``s`` read it, and the stage read is asserted to be the one the
    buffer holds. The slot-1 pass runs on the kernel's items (asserted to
    cover Q's ``2 x T1 x`` columns once), over every row of the tile (rows
    past the window read NaN, as the kernel reads stale words there), both
    s1 summed into the two halves of Q (whole rows: the row's columns, read
    wrapped, and the first ``K - 1`` again past its end); the slot-2 pass
    runs on each thread's ``NI`` columns; then the ring, whose front is
    written once per output plane. Every output is asserted written
    once."""
    T = y.dtype
    cdt = _compute_dtype(T)
    store, word = y.element_size(), torch.empty((), dtype=cdt).element_size()
    vec, vq = 16 // store, 16 // word
    ni, rw = (2, 4) if word == 8 else (4, 4)
    C, T1, T2 = t
    K = k[0]
    assert K in (2, 4, 6, 8) and list(k) == [K] * 3 and 2 <= stages <= 4
    assert C >= 1 and T1 % rw == 0 and T2 & (T2 - 1) == 0 and T1 * T2 == threads * ni
    ins = [n[a] + (k[a] - 1 if pad[a] else 0) for a in range(3)]
    assert tuple(y.shape[1:]) == tuple(ins) and ins[2] % vec == 0, "rows not on 16 bytes"
    whole = not pad[2] and T2 >= n[2]
    taps = torch.as_tensor(np.asarray(arr), dtype=cdt)
    row = 128 // store  # a buffer row of the tile's columns in whole 128 bytes
    ws = n[2] if whole else -(-(T2 + K - 1 + vec - 1) // row) * row
    nq = -(-(ni + K - 1) // vq) * vq  # values a slot-2 row read takes
    qs = T2 - ni + nq
    tpr = T2 // ni
    outs = [(tid // tpr, tid % tpr * ni) for tid in range(threads)]
    assert sorted((l1, c + i) for l1, c in outs for i in range(ni)) == [
        (l1, c) for l1 in range(T1) for c in range(T2)]
    out = torch.full(tuple(n), float("nan"), dtype=cdt)
    written = torch.zeros(tuple(n), dtype=torch.int32)

    def band(d):
        return approx if idx[d] < 0 else y[idx[d]]

    for p0, o1, o2 in _units(n, t, -(-n[0] // C) * -(-n[1] // T1) * -(-n[2] // T2)):
        w1, w2, cc = min(T1, n[1] - o1), min(T2, n[2] - o2), min(C, n[0] - p0)
        E1, E2 = w1 + K - 1, w2 + K - 1
        rows = _window_index(o1 - left[1] + torch.arange(E1), n[1], left[1], pad[1])
        if whole:
            assert o2 == 0
            runs = _plane_runs(o1 - left[1], E1, n[1], left[1], pad[1])
            assert [r for row, _, m in runs for r in range(row, row + m)] == rows.tolist()
            stage_bytes = 4 * E1 * ins[2] * store
            cols = n[2]
            colpos = _window_index(torch.arange(n[2]) - left[2], n[2], left[2], False)
        else:
            pieces, sh = _plane_pieces(o2, E2, n[2], ins[2], left[2], pad[2], vec)
            assert sh + E2 <= ws and pieces[-1][1] + pieces[-1][2] <= ws
            stage_bytes = 4 * E1 * sum(m for *_, m in pieces) * store
            cols = E2
            colpos = sh + torch.arange(E2)
        assert stage_bytes < 2 ** 20, "beyond an mbarrier's tx-count"
        # the slot-1 items, as each thread's woff/qoff: (s2, rows g rw.., column)
        ng = T1 // rw
        items = [(f // cols // ng, f // cols % ng, f % cols) for f in range(2 * ng * cols)]
        assert len(items) <= 3 * threads, "more slot-1 items than kPlaneRounds"
        assert sorted((s2, g * rw + i, c) for s2, g, c in items for i in range(rw)) == [
            (s2, l, c) for s2 in range(2) for l in range(T1) for c in range(cols)]

        def fill(s):
            """Stage s's buffer: (4, T1 + K - 1, ws), window w = 2 s1 + s2."""
            r, s0 = s >> 1, s & 1
            g0 = _window_index(torch.tensor([p0 - left[0] + r]), n[0], left[0], pad[0])[0]
            W = torch.full((4, T1 + K - 1, ws), float("nan"), dtype=T)
            for w in range(4):
                d = s0 << bit[0] | (w >> 1) << bit[1] | (w & 1) << bit[2]
                if whole:  # one copy a run of whole rows
                    for row, l, m in runs:
                        W[w, l:l + m] = band(d)[g0, row:row + m]
                    continue
                src = band(d)[g0][rows]  # (E1, m2): whole input rows
                for lo, pd, m in pieces:
                    W[w, :E1, pd:pd + m] = src[:, lo:lo + m]
            return s, W

        ns = 2 * (cc + K - 1)
        bufs = [fill(s) for s in range(min(stages, ns))]
        ring = torch.zeros((K, T1, T2), dtype=cdt)
        for s in range(ns):
            r, s0 = s >> 1, s & 1
            held, W = bufs[s % stages]
            assert held == s, "a stage read from a buffer that holds another"
            Wc = W[:, :, colpos].to(cdt)
            Q = torch.full((2, T1, qs), float("nan"), dtype=cdt)
            for s2 in range(2):
                Q[s2, :, :cols] = sum(_corr(Wc[2 * s1 + s2], taps[1, s1, :K], 0)
                                      for s1 in range(2))
                if whole:  # the first K - 1 columns again past the row's end
                    Q[s2, :, cols:cols + K - 1] = Q[s2, :, :K - 1]
            if s + stages < ns:
                bufs[s % stages] = fill(s + stages)
            P = sum(_corr(Q[s2, :, :T2 + K - 1], taps[2, s2, :K], 1) for s2 in range(2))
            ring += taps[0, s0, :K].flip(0)[:, None, None] * P
            if s0 == 1:
                if r >= K - 1:
                    at = (p0 + r - (K - 1), slice(o1, o1 + w1), slice(o2, o2 + w2))
                    out[at] = ring[0, :w1, :w2] * scale
                    written[at] += 1
                ring = torch.cat([ring[1:], torch.zeros_like(ring[:1])])
    assert bool((written == 1).all()), "an output written other than once"
    return out.to(T)


def plane_ana_replay(x, big, approx_out, band_off, n, k, t, left, bit, pad, arr, lam,
                     stages=2, threads=512):
    """One ``nddwt_dec_level`` launch on the analysis plane body
    (``plane_ana_kernel`` in ``csrc/nddwt_plane.cuh``), CTA by CTA and stage
    by stage: band ``d`` into ``big[band_off + d - 1]`` (shrunk by ``lam >
    0``), ``d == 0`` into ``approx_out``. ``x`` is the input on the view,
    ``(m0, m1, m2)`` (``m`` = ``n`` plus ``k - 1`` on a padded slot), its
    rows starting on 16 bytes; ``big`` and ``approx_out`` views of the
    outputs, ``(B, *n)`` and ``n``; ``n, k, t, left, bit, pad`` the view
    geometry with the plan ``t = (C, T1, T2)``, ``arr`` the (3, 2,
    kMaxTaps) tap array, ``stages`` the stage buffers, ``threads`` the
    CTA's (kPlaneThreads).

    A stage is one input plane of the chunk's walk, its window copied as
    warp 0 copies it (``plane_replay``'s runs of whole rows or row pieces)
    into a stage buffer that holds nothing else (NaN), refilled with stage
    ``s + stages`` only after stage ``s`` read it. The slot-1 pass runs on
    the kernel's items of ``RA = 2`` rows (asserted to cover Q's ``T1 x``
    columns once) over every row of the tile (rows past the window read
    NaN), lo into Q[0] and hi into Q[1] (whole rows: the row's columns,
    read wrapped, and the first ``K - 1`` again past its end); the slot-2
    pass runs on each thread's half (its s1) and ``NI`` columns, both s2;
    the ring keeps the last K planes' bands, and once full each output
    plane's four bands (s0, s2) of each half are gathered over it and
    shrunk as the kernel shrinks, ``sign(v) (|v| - min(|v|, lam))``. Every
    output is asserted written once."""
    T = x.dtype
    cdt = _compute_dtype(T)
    store, word = x.element_size(), torch.empty((), dtype=cdt).element_size()
    vec, vq = 16 // store, 16 // word
    ni, ra = (2 if word == 8 else 4), 2
    half = threads // 2
    C, T1, T2 = t
    K = k[0]
    assert K in (2, 4, 6, 8) and list(k) == [K] * 3 and 2 <= stages <= 4
    assert C >= 1 and T1 % ra == 0 and T2 & (T2 - 1) == 0 and T1 * T2 == half * ni
    ins = [n[a] + (k[a] - 1 if pad[a] else 0) for a in range(3)]
    assert tuple(x.shape) == tuple(ins) and ins[2] % vec == 0, "rows not on 16 bytes"
    whole = not pad[2] and T2 >= n[2]
    taps = torch.as_tensor(np.asarray(arr), dtype=cdt)
    row = 128 // store  # a buffer row of the tile's columns in whole 128 bytes
    ws = n[2] if whole else -(-(T2 + K - 1 + vec - 1) // row) * row
    qs = T2 - ni + -(-(ni + K - 1) // vq) * vq
    tpr = T2 // ni
    outs = [(tid // half, tid % half // tpr, tid % half % tpr * ni) for tid in range(threads)]
    assert sorted((s1, l1, c + i) for s1, l1, c in outs for i in range(ni)) == [
        (s1, l1, c) for s1 in range(2) for l1 in range(T1) for c in range(T2)]
    written = torch.zeros((8,) + tuple(n), dtype=torch.int32)

    def dst(d):
        return approx_out if d == 0 else big[band_off + d - 1]

    for p0, o1, o2 in _units(n, t, -(-n[0] // C) * -(-n[1] // T1) * -(-n[2] // T2)):
        w1, w2, cc = min(T1, n[1] - o1), min(T2, n[2] - o2), min(C, n[0] - p0)
        E1, E2 = w1 + K - 1, w2 + K - 1
        rows = _window_index(o1 - left[1] + torch.arange(E1), n[1], left[1], pad[1])
        if whole:
            assert o2 == 0
            runs = _plane_runs(o1 - left[1], E1, n[1], left[1], pad[1])
            assert [r for r0, _, m in runs for r in range(r0, r0 + m)] == rows.tolist()
            stage_bytes = E1 * ins[2] * store
            cols = n[2]
            colpos = _window_index(torch.arange(n[2]) - left[2], n[2], left[2], False)
        else:
            pieces, sh = _plane_pieces(o2, E2, n[2], ins[2], left[2], pad[2], vec)
            assert sh + E2 <= ws and pieces[-1][1] + pieces[-1][2] <= ws
            stage_bytes = E1 * sum(m for *_, m in pieces) * store
            cols = E2
            colpos = sh + torch.arange(E2)
        assert stage_bytes < 2 ** 20, "beyond an mbarrier's tx-count"
        items = [(f // cols, f % cols) for f in range(T1 // ra * cols)]
        assert len(items) <= 3 * threads, "more slot-1 items than kPlaneRounds"
        assert sorted((g * ra + i, c) for g, c in items for i in range(ra)) == [
            (l, c) for l in range(T1) for c in range(cols)]

        def fill(s):
            """Stage s's buffer: (T1 + K - 1, ws), input plane s of the walk."""
            g0 = _window_index(torch.tensor([p0 - left[0] + s]), n[0], left[0], pad[0])[0]
            W = torch.full((T1 + K - 1, ws), float("nan"), dtype=T)
            if whole:  # one copy a run of whole rows
                for r0, l, m in runs:
                    W[l:l + m] = x[g0, r0:r0 + m]
            else:
                src = x[g0][rows]  # (E1, m2): whole input rows
                for lo, pd, m in pieces:
                    W[:E1, pd:pd + m] = src[:, lo:lo + m]
            return s, W

        ns = cc + K - 1
        bufs = [fill(s) for s in range(min(stages, ns))]
        ring = []  # the last K planes' (2, 2, T1, T2): s1, s2
        for s in range(ns):
            held, W = bufs[s % stages]
            assert held == s, "a stage read from a buffer that holds another"
            Wc = W[:, colpos].to(cdt)
            Q = torch.full((2, T1, qs), float("nan"), dtype=cdt)
            for s1 in range(2):
                Q[s1, :, :cols] = _corr(Wc, taps[1, s1, :K], 0)
                if whole:  # the first K - 1 columns again past the row's end
                    Q[s1, :, cols:cols + K - 1] = Q[s1, :, :K - 1]
            if s + stages < ns:
                bufs[s % stages] = fill(s + stages)
            P = torch.stack([torch.stack([_corr(Q[s1, :, :T2 + K - 1], taps[2, s2, :K], 1)
                                          for s2 in range(2)]) for s1 in range(2)])
            ring = (ring + [P])[-K:]
            if s < K - 1:
                continue
            at = (p0 + s - (K - 1), slice(o1, o1 + w1), slice(o2, o2 + w2))
            lohi = torch.tensordot(taps[0, :, :K], torch.stack(ring), dims=([1], [0]))
            for s0 in range(2):
                for s1 in range(2):
                    for s2 in range(2):
                        d = s0 << bit[0] | s1 << bit[1] | s2 << bit[2]
                        v = lohi[s0, s1, s2, :w1, :w2]
                        if d > 0 and lam > 0:
                            m = v.abs()
                            v = torch.copysign(m - torch.clamp(m, max=lam), v)
                        dst(d)[at] = v.to(T)
                        written[d][at] += 1
    assert bool((written == 1).all()), "an output written other than once"


def _ana_unit(src, dst, count, origin, n, k, t, gw, left, bit, pad, taps, groups, lam):
    """One unit of the streamed analysis (``stream_ana``), the CTA tile at
    ``origin = (p0, o1, o2)`` with ``t = (C, T1, T2)`` and ``gw`` in-plane
    bands a walk: ``src(gi)`` is input group ``gi`` on the view, ``(m0, m1,
    m2)``; band ``d``'s outputs go to ``dst(d)`` (``d == 0``: the
    approximation; shrunk by ``lam > 0`` otherwise) on the view, ``n``, and
    are counted in ``count(d)``; ``taps`` as ``_syn_unit``'s."""
    cdt = taps.dtype
    C, T1, T2 = t
    p0, o1, o2 = origin
    G = (2 if k[1] > 1 else 1) * (2 if k[2] > 1 else 1)
    lgs1 = 1 if k[1] > 1 else 0
    K0 = k[0]
    cc = min(C, n[0] - p0)
    w1, w2 = min(T1, n[1] - o1), min(T2, n[2] - o2)
    rows = _window_index(o1 - left[1] + torch.arange(w1 + k[1] - 1), n[1], left[1], pad[1])
    cols = _window_index(o2 - left[2] + torch.arange(w2 + k[2] - 1), n[2], left[2], pad[2])
    for gi in range(groups):
        x = src(gi)
        for wk in range(G // gw):
            bands = range(wk * gw, (wk + 1) * gw)
            ring = []  # the last K0 planes' in-plane bands
            for r in range(cc + K0 - 1):
                g0 = _window_index(torch.tensor([p0 - left[0] + r]), n[0], left[0], pad[0])
                w = x[g0[0]][rows][:, cols].to(cdt)
                if k[1] > 1 and k[2] > 1:  # slot 2 into Q, then slot 1
                    q = {h: _corr(w, taps[2, h, :k[2]], 1) for h in {b >> 1 for b in bands}}
                    vals = {b: _corr(q[b >> 1], taps[1, b & 1, :k[1]], 0) for b in bands}
                elif k[1] == 1:  # 2D: one row (an item's, folded), slot 2
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
                    lohi = torch.tensordot(taps[0, :, :K0], torch.stack([v[b] for v in ring]),
                                           dims=([1], [0]))
                    s1, s2 = b & lgs1, b >> lgs1
                    for s0 in range(2):
                        d = (s0 << bit[0] | s1 << bit[1] | s2 << bit[2]) + 4 * gi
                        v = lohi[s0]
                        if d > 0 and lam > 0:
                            v = soft_threshold(v, lam)
                        out = dst(d)
                        out[at] = v.to(out.dtype)
                        count(d)[at] += 1


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
    written = torch.zeros((2 * G * groups,) + tuple(n), dtype=torch.int32)
    units = _units(n, t, -(-n[0] // C) * -(-n[1] // T1) * -(-n[2] // T2))
    for origin in units:
        _ana_unit(x.__getitem__,
                  lambda d: approx_out if d == 0 else big[band_off + d - 1],
                  written.__getitem__, origin, n, k, t, gw, left, bit, pad, taps, groups,
                  lam)
    assert bool((written == 1).all()), "an output written other than once"


def multi_replay(mode, src, taps, level, coef, ctas=264):
    """One ``nddwt_dec_multi`` (``mode`` 'dec': ``src`` the items ``(N,
    *s)``, ``coef`` the shrink ``lam``) or ``nddwt_rec_multi`` launch
    ('rec': ``src`` the bands ``(N, B, *s)``, ``coef`` the per-level
    scale) (``csrc/nddwt_multi.cu``), level by level and CTA by CTA; returns
    the bands or the output.

    The launch's geometry is ``multi._multi_geometry``'s: the per-level
    kernels' streamed view of one item, or of a 2D batch folded into the
    pass-through slot 1 ``(n0, N, n1)``, and its plan. Per level, the grid of
    ``min(ctas, units)`` CTAs claims the units from a counter, here in turn
    (CTA ``c`` the ``c``-th, ``c + grid``-th, ...: which CTA runs a unit
    changes nothing but the order), asserted to cover each once, a unit
    being ``(item, chunk, plane tile)``, slot 2 fastest (the item only where
    not folded); each runs ``_ana_unit`` or
    ``_syn_unit`` on views of the flat arrays built with the kernel's
    strides: a folded view steps from item to item by each array's own
    stride (the bands' ``B`` items of ``vox``, the ping slots' and the
    input's and output's ``vox``), within an item ``vox`` a band and ``n1``
    a plane. The analysis reads ``src`` or ping slot ``(l - 1) % 2`` and
    writes its details at ``dec_detail_offset`` and its approximation to
    slot ``l % 2`` or band 0; the synthesis reads level ``l``'s band table
    (band 0 from ``src`` at ``l = 0``, else from slot ``(l - 1) % 2``; the
    details at ``rec_band_index``) and writes slot ``l % 2`` or the output.
    The slots start as NaN and hold the storage type; every output of a
    level is asserted written once, and nothing else."""
    from . import multi

    rec = mode == "rec"
    T = src.dtype
    cdt = _compute_dtype(T)
    N = int(src.shape[0])
    shape = tuple(int(s) for s in src.shape[2 if rec else 1:])
    d = len(shape)
    nb = 2**d
    B = nb + (nb - 1) * (level - 1)
    assert not rec or src.shape[1] == B
    n, k, t, left, bit, arr, gw = multi._multi_geometry(shape, taps, rec, T, N)
    fold = d == 2 and n[1] > 1  # the batch in slot 1
    tp = torch.as_tensor(np.asarray(arr), dtype=cdt)
    C, T1, T2 = t
    vox = int(np.prod(shape))
    bvox = B * vox
    per = -(-n[0] // C) * -(-n[1] // T1) * -(-n[2] // T2)
    origins = _units(n, t, per)
    units = per * (1 if fold else N)
    grid = min(ctas, units)
    order = [u for c in range(grid) for u in range(c, units, grid)]
    assert sorted(order) == list(range(units)), "a unit dropped or repeated"
    pad = [False] * 3
    flat_src = src.reshape(-1)
    out = torch.full((N * (vox if rec else bvox),), float("nan"), dtype=T)
    slots = min(level - 1, 2)
    ping = torch.full((slots * N * vox,), float("nan"), dtype=T)

    def view(flat, at, item):
        """The view of the item at element ``at`` of ``flat`` (3D), or of
        the batch folded, its items ``item`` elements apart (2D)."""
        if fold:
            return torch.as_strided(flat, tuple(n), (n[2], item, 1), at)
        return torch.as_strided(flat, tuple(n), (n[1] * n[2], n[2], 1), at)

    for lvl in range(level):
        final = lvl == level - 1
        seen_out = torch.zeros(out.shape, dtype=torch.int32)
        seen_ping = torch.zeros(ping.shape, dtype=torch.int32)
        want_out = torch.zeros(out.shape, dtype=torch.int32)
        want_ping = torch.zeros(ping.shape, dtype=torch.int32)
        nxt = lvl % 2 * N * vox  # this level's slot, unless final
        prev = (lvl - 1) % 2 * N * vox
        if rec:
            idx = [-1 if (b == 0 and lvl > 0) else
                   (b if lvl == 0 else nb + (nb - 1) * (lvl - 1) + b - 1) for b in range(nb)]
            astep = bvox if lvl == 0 else vox
            a_flat, a_at = (flat_src, 0) if lvl == 0 else (ping, prev)
            o_flat, o_seen, o_want, o_at = ((out, seen_out, want_out, 0) if final
                                            else (ping, seen_ping, want_ping, nxt))
            o_want[o_at:o_at + N * vox] = 1
        else:
            off = B - (nb - 1) * (lvl + 1)
            i_flat, i_at = (flat_src, 0) if lvl == 0 else (ping, prev)
            astep = bvox if final else vox
            a_flat, a_seen, a_at = ((out, seen_out, 0) if final else (ping, seen_ping, nxt))
            for item in range(N):
                want_out[item * bvox + off * vox:item * bvox + (off + nb - 1) * vox] = 1
                if final:
                    want_out[item * bvox:item * bvox + vox] = 1
            if not final:
                want_ping[nxt:nxt + N * vox] = 1
        for u in order:
            item, origin = divmod(u, per)
            origin = origins[origin]
            if rec:
                def band(b, item=item):
                    if idx[b] < 0:
                        return view(a_flat, a_at + item * astep, astep)
                    return view(flat_src, item * bvox + idx[b] * vox, bvox)

                _syn_unit(band, lambda gi, item=item: view(o_flat, o_at + item * vox, vox),
                          lambda gi, item=item: view(o_seen, o_at + item * vox, vox),
                          origin, n, k, t, left, bit, pad, tp, 1, coef)
            else:
                def dst(b, item=item, flats=(out, a_flat)):
                    """Band b's view in the bands, flats[0], or for b == 0
                    the approximation's, flats[1] (or their write counts)."""
                    if b == 0:
                        return view(flats[1], a_at + item * astep, astep)
                    return view(flats[0], item * bvox + (off + b - 1) * vox, bvox)

                _ana_unit(lambda gi, item=item: view(i_flat, i_at + item * vox, vox), dst,
                          lambda b, item=item: dst(b, item, (seen_out, a_seen)),
                          origin, n, k, t, gw, left, bit, pad, tp, 1, coef)
        assert torch.equal(seen_out, want_out) and torch.equal(seen_ping, want_ping), \
            f"level {lvl}: an output written other than once, or a stray write"
    return out.reshape((N,) + ((() if rec else (B,)) + shape))


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


def _flat_steps(tile, k, a0, a1, pitch):
    """The in-tile steps of axis group ``[a0, a1)`` (``flat_layout`` in
    ``csrc/nddwt_flat.cu``): per axis ``(inner, t, outer, w, in_size,
    out_size)``, the arrays shaped ``outer x w x inner`` before the axis
    and ``outer x t x inner`` after it; the window's rows ``pitch`` words
    apart until the last axis is done."""
    cur = [t + (kk - 1 if a0 <= ax < a1 else 0) for ax, (t, kk) in enumerate(zip(tile, k))]
    cur[-1] = pitch
    steps = []
    for ax in range(a0, a1):
        inner = int(np.prod(cur[ax + 1:], dtype=np.int64))
        outer = int(np.prod(cur[:ax], dtype=np.int64))
        steps.append((inner, tile[ax], outer, cur[ax], outer * cur[ax] * inner,
                      outer * tile[ax] * inner))
        cur[ax] = tile[ax]
    return steps


def flat_replay(mode, arr, taps, level, preserve_l2=False, lam=0.0, batch=0, mask=None,
                lams=(), moms=None, step=0.0, plan=None, ctas=264, stats=None):
    """One ``nddwt_flat_pair`` or ``nddwt_flat_iter`` launch
    (``csrc/nddwt_flat.cu``), pass by pass and CTA by CTA, with its
    contract: mode ``'dec'``, ``'rec'``, ``'pair'`` as ``flat_pair_ref``
    (``arr`` the array, or the bands for ``'rec'``; ``lam`` the shrink),
    ``'chain'`` and ``'fista'`` as ``flat_iter_ref`` (``lams``, ``moms``,
    ``step``, ``mask``); ``batch`` 0, or 2 for a leading pair. ``plan``
    (``flat.FlatPlan``) defaults to ``flat._flat_plan``'s; ``ctas`` is the
    grid's bound (one wave of the card).

    The plan is checked as the kernel checks it (its shared memory and units
    recomputed by ``flat.flat_layout``). Per pass, the CTAs walk the units
    ``c, c + grid, ...`` (asserted to cover each unit once); each unit
    builds the kernel's tables (window row offsets and columns, wrapped;
    output rows, -1 past the array), copies its windows into a stage buffer
    of the plan's words that holds nothing else (NaN), rows
    ``flat.window_pitch`` apart and shifted as the kernel shifts them, in
    the kernel's pieces (a whole 16-byte piece reads consecutive source
    elements from its first column's, asserted to be the columns' own;
    ``stats``, a dict, counts the elements copied whole and one by one),
    runs the in-tile
    steps on the kernel's flat indices (every read asserted inside the
    buffer's words, every stage's writes inside the other buffer) and
    writes the pass's outputs, each asserted written exactly once; then
    the shrink, the rounding to the storage type where the kernel stores,
    and the epilogue."""
    from . import flat

    T = arr.dtype
    cdt = _compute_dtype(T)
    B = max(batch, 1)
    lead = 1 if batch else 0
    shape = tuple(int(s) for s in arr.shape[lead + (1 if mode == "rec" else 0):])
    d = len(shape)
    nb = 2 ** d
    k = tuple(int(np.shape(t)[1]) for t in taps)
    tp = [torch.as_tensor(np.asarray(t), dtype=cdt) for t in taps]
    word = torch.empty((), dtype=cdt).element_size()
    vw = 16 // word  # the words of a 16-byte piece
    plan = plan or flat._flat_plan(shape, k, T, batch)
    lay = flat.flat_layout(shape, k, plan.tile, plan.ends, B, word)
    assert lay["smem"] == plan.smem and lay["units"] == plan.units, "plan disagrees"
    assert plan.smem <= 227 * 1024 - 2 * flat.MAX_DIM * 76 * word, "beyond shared memory"
    assert all(1 <= t <= n for t, n in zip(plan.tile, shape)) and plan.ends[-1] == d
    xw, yw, tile = lay["xw"], lay["yw"], plan.tile
    numel = int(np.prod(shape))
    stride = [int(np.prod(shape[ax + 1:], dtype=np.int64)) for ax in range(d)]
    nt = [-(-n // t) for n, t in zip(shape, tile)]
    ntiles = int(np.prod(nt))
    tile_elems = int(np.prod(tile))
    out_rows = int(np.prod(tile[:-1], dtype=np.int64))
    nbands = nb + (nb - 1) * (level - 1)
    grid = min(ctas, plan.units)
    groups = list(zip((0,) + plan.ends[:-1], plan.ends))

    def walk(units):
        """The units of a pass, CTA by CTA."""
        us = [u for c in range(grid) for u in range(c, units, grid)]
        assert sorted(us) == list(range(units)), "a unit dropped or repeated"
        return torch.tensor(us, dtype=torch.int64)

    def origins(tiles):
        o = torch.zeros((len(tiles), d), dtype=torch.int64)
        rest = tiles.clone()
        for ax in range(d - 1, -1, -1):
            o[:, ax] = (rest % nt[ax]) * tile[ax]
            rest = rest // nt[ax]
        return o

    def tables(o, a0, a1, adj):
        """rowt (U, rows), colt (U, cols), outr (U, out_rows), the kernel's."""
        e = [t + (kk - 1 if a0 <= ax < a1 else 0) for ax, (t, kk) in enumerate(zip(tile, k))]
        left = [kk // 2 - (0 if adj else 1) if a0 <= ax < a1 else 0 for ax, kk in enumerate(k)]
        rows = int(np.prod(e[:-1], dtype=np.int64))
        r = torch.arange(rows)
        rowt = torch.zeros((len(o), rows), dtype=torch.int64)
        for ax in range(d - 2, -1, -1):
            ia = r % e[ax]
            r = r // e[ax]
            rowt += ((o[:, ax:ax + 1] + ia - left[ax]) % shape[ax]) * stride[ax]
        colt = (o[:, -1:] + torch.arange(e[-1]) - left[-1]) % shape[-1]
        cols, pitch, shift = flat.window_pitch(shape, k, tile, a0, a1, word)
        assert cols == e[-1]
        j = torch.arange(out_rows)
        outr = o[:, -1:].repeat(1, out_rows)
        inside = torch.ones_like(outr, dtype=torch.bool)
        for ax in range(d - 2, -1, -1):
            c = o[:, ax:ax + 1] + j % tile[ax]
            j = j // tile[ax]
            inside &= c < shape[ax]
            outr = outr + c * stride[ax]
        outr = torch.where(inside, outr, torch.full_like(outr, -1))
        sh = colt[:, 0] % vw if shift else torch.zeros(len(o), dtype=torch.int64)
        assert rowt.min() >= 0 and rowt.max() < numel and colt.max() < shape[-1]
        return rowt, colt, outr, cols, pitch, sh, shift

    def windows(rowt, colt, cols, pitch, sh, shift, nwin, src_of):
        """The stage buffer X (U, xw) after the copy: window kk's column c of
        row r, from rowt[r] + colt[c] of the sources src_of(kk) gives
        [(flat source, (U,) base offsets, (U,) units that read it)], at
        kk win + r pitch + sh + c. The kernel's two loops a row (its
        RowCopy for the unit's sh): nw whole pieces of vw columns from
        column `head` on, each at a vw-aligned word and starting vw-aligned
        in the source, whose vw source elements are read from the first
        one's on (asserted to be the columns' own); then the other columns
        one by one. Every column is asserted copied once."""
        rows = rowt.shape[1]
        win = rows * pitch
        assert nwin * win <= xw, "windows beyond the stage buffer"
        assert int((sh + cols).max()) <= pitch, "a shifted row beyond its pitch"
        vec = shape[-1] % vw == 0 and pitch % vw == 0
        srcc = torch.full_like(colt, -1)
        n_whole = 0
        for s_ in sh.unique().tolist():
            ui = torch.nonzero(sh == s_).flatten()[:, None]
            lead = (vw - s_ % vw) % vw
            nw = ((cols - lead) // vw if vec and s_ < vw and (shift or s_ == 0)
                  and cols >= lead + vw else 0)
            head = lead if nw else cols
            cover = torch.zeros(cols, dtype=torch.int64)
            for q in range(nw):
                c = head + q * vw
                assert (s_ + c) % vw == 0, "a piece off 16-byte alignment in shared memory"
                f = colt[ui, c]
                assert bool((f % vw == 0).all()) and int(f.max()) + vw <= shape[-1], \
                    "a piece off alignment or across the wrap in the source"
                srcc[ui, c + torch.arange(vw)] = f + torch.arange(vw)
                cover[c:c + vw] += 1
            j = torch.arange(cols - nw * vw)
            c = torch.where(j < head, j, j + nw * vw)
            srcc[ui, c] = colt[ui, c]
            cover.index_add_(0, c, torch.ones_like(c))
            assert bool((cover == 1).all()), "a window column copied other than once"
            n_whole += len(ui) * nw * vw
        assert bool((srcc == colt).all()), "a whole piece reads other columns than its own"
        if stats is not None:
            stats["whole"] = stats.get("whole", 0) + nwin * rows * n_whole
            stats["single"] = stats.get("single", 0) + nwin * rows * (colt.numel() - n_whole)
        pos = torch.arange(cols)[None, :] + sh[:, None]  # (U, cols): word in the row
        row = torch.arange(rows).repeat_interleave(cols)
        col = torch.arange(cols).repeat(rows)
        at = rowt[:, row] + srcc[:, col]  # (U, rows * cols)
        dst = row * pitch + pos[:, col]
        X = torch.full((rowt.shape[0], xw), float("nan"), dtype=cdt)
        for w in range(nwin):
            for src, base, units in src_of(w):
                if not bool(units.any()):
                    continue
                ui = torch.nonzero(units).flatten()
                X[ui] = X[ui].scatter(1, w * win + dst[ui], src[base[ui, None] + at[ui]].to(cdt))
        return X

    def gather(buf, idx, words):
        assert int(idx.max()) < words, "a read beyond the stage's words"
        return buf[:, idx]

    def gather_u(buf, idx, words):
        """buf[u, idx[u]] for each unit u: reads at a unit's own shift."""
        assert int(idx.max()) < words, "a read beyond the stage's words"
        return buf.gather(1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)

    def ana_step(cur, st, narr, ax, words_in, words_out):
        inner, t, outer, w, in_size, out_size = st
        items = narr * out_size
        assert 2 * items <= words_out, "a stage beyond its buffer"
        i = torch.arange(items)
        rest, ii = i // inner, i % inner
        r2, c = rest // t, rest % t
        idx = ((r2 * w + c) * inner + ii)[:, None] + torch.arange(k[ax]) * inner
        v = gather(cur, idx, words_in)
        nxt = torch.full((cur.shape[0], words_out), float("nan"), dtype=cdt)
        nxt[:, :items] = v @ tp[ax][0]
        nxt[:, items:2 * items] = v @ tp[ax][1]
        return nxt

    def syn_step(cur, st, nout, ax, words_in, words_out):
        inner, t, outer, w, in_size, out_size = st
        items = nout * out_size
        assert items <= words_out, "a stage beyond its buffer"
        i = torch.arange(items)
        rest, ii = i // inner, i % inner
        r2, c = rest // t, rest % t
        h, oo = r2 // outer, r2 % outer
        base = 2 * h * in_size + (oo * w + c) * inner + ii
        idx = base[:, None] + (k[ax] - 1 - torch.arange(k[ax])) * inner
        lo = gather(cur, idx, words_in) @ tp[ax][0]
        hi = gather(cur, idx + in_size, words_in) @ tp[ax][1]
        nxt = torch.full((cur.shape[0], words_out), float("nan"), dtype=cdt)
        nxt[:, :items] = lo + hi
        return nxt

    def positions(outr, o, items_p):
        """Tile positions p (items,) -> global offsets (U, items) and their
        validity (ragged tiles: rows past the end, columns past lastlim)."""
        row, col = items_p // tile[-1], items_p % tile[-1]
        orow = outr[:, row]
        lastlim = torch.clamp(shape[-1] - o[:, -1:], max=tile[-1])
        valid = (orow >= 0) & (col < lastlim)
        return orow + col, valid

    def last_base(st, p):
        inner, t, outer, w, in_size, out_size = st
        rest, ii = p // inner, p % inner
        r2, c = rest // t, rest % t
        return (r2 * w + c) * inner + ii

    nbe = B * numel
    bands = (arr.reshape(-1).clone() if mode == "rec"
             else torch.full((B * nbands * numel,), float("nan"), dtype=T))
    out = torch.full((nbe,), float("nan"), dtype=T)
    z = torch.full((nbe,), float("nan"), dtype=T)
    V = torch.full((nbe,), float("nan"), dtype=cdt)
    A = [torch.full((nbe,), float("nan"), dtype=cdt) for _ in range(2)]
    half = 2 ** (d - 1) if d > 1 else 0
    P = [torch.full((half * nbe,), float("nan"), dtype=cdt) for _ in range(2)]

    def ana_pass(g, src, pout, nxt_a, final, off, lam_i):
        a0, a1 = groups[g]
        m = a1 - a0
        us = walk(ntiles << a0)
        r0, o = us // ntiles, origins(us % ntiles)
        rowt, colt, outr, cols, pitch, sh, shift = tables(o, a0, a1, False)
        everyone = torch.ones_like(r0, dtype=torch.bool)
        X = windows(rowt, colt, cols, pitch, sh, shift, B,
                    lambda bi: [(src, (r0 * B + bi) * numel, everyone)])
        steps = _flat_steps(tile, k, a0, a1, pitch)
        cur, cw = X, xw
        for s in range(m - 1):  # the stages alternate between X and Y
            ow = yw if s % 2 == 0 else xw
            cur, cw = ana_step(cur, steps[s], B << s, a0 + s, cw, ow), ow
        st, ax = steps[-1], a1 - 1
        par = 2 ** (m - 1)
        i = torch.arange(par * tile_elems)
        q, p = i // tile_elems, i % tile_elems
        gi, valid = positions(outr, o, p)
        base = last_base(st, p)[None, :] + sh[:, None]  # (U, items)
        jj = torch.arange(k[ax]) * st[0]
        v = torch.stack([gather_u(cur, ((q * B + bi) * st[4] + base)[..., None] + jj, cw)
                         for bi in range(B)], dim=-2)  # (U, items, B, K)
        lohi = torch.stack([v @ tp[ax][0], v @ tp[ax][1]], dim=-1)  # (U, items, B, 2)
        parent = r0[:, None] + (q << a0)  # (U, items)
        written = {}
        for s in range(2):
            if a1 < d:
                node = parent + (s << (a1 - 1))
                for bi in range(B):
                    at = ((node * B + bi) * numel + gi)[valid]
                    pout[at] = lohi[..., bi, s][valid]
                    written.setdefault("p", []).append(at)
                continue
            b = parent + (s << (d - 1))
            zero = valid & (b == 0)
            det = valid & (b != 0)
            for bi in range(B):
                at = (bi * numel + gi)[zero]
                if final:
                    bands[bi * nbands * numel + gi[zero]] = lohi[..., bi, s][zero].to(T)
                else:
                    nxt_a[at] = lohi[..., bi, s][zero]
                written.setdefault("a", []).append(at)
            vals = lohi[..., s]  # (U, items, B)
            if lam_i > 0:
                mag = vals.pow(2).sum(-1).sqrt() if B == 2 else vals[..., 0].abs()
                f = torch.clamp(mag - lam_i, min=0) / torch.clamp(mag, min=1e-30)
                vals = vals * f[..., None]
            for bi in range(B):
                at = (bi * nbands + off + b - 1) * numel + gi
                bands[at[det]] = vals[..., bi][det].to(T)
                written.setdefault("b", []).append(at[det])
        want = {"p": (2 ** a1) * B * numel, "a": B * numel, "b": B * (nb - 1) * numel}
        for key, ats in written.items():
            cnt = torch.bincount(torch.cat(ats), minlength=1)
            assert int((cnt > 1).sum()) == 0 and int((cnt == 1).sum()) == want[key], \
                f"an output of the analysis written other than once ({key})"

    def epilogue(at_bi, gi, r, mom_i):
        idx = at_bi * numel + gi
        if mode == "fista":
            xo = out[idx].to(cdt)
            zt = (r + mom_i * (r - xo)).to(T)
            out[idx] = r.to(T)
            z[idx] = zt
            m_ = mask.reshape(-1)[gi].to(cdt)
            zv = zt.to(cdt)
            V[idx] = zv - step * (m_ * (m_ * zv - b_flat[idx].to(cdt)))
            return
        xt = r.to(T)
        out[idx] = xt
        if mode == "chain":
            V[idx] = xt.to(cdt)

    def syn_pass(g, lvl, last, mom_i, scale):
        a0, a1 = groups[g]
        m = a1 - a0
        end = g + 1 == len(groups)
        us = walk((ntiles * B) << (d - a1))
        rest_u = us // ntiles
        bi, gq, o = rest_u % B, rest_u // B, origins(us % ntiles)
        rowt, colt, outr, cols, pitch, sh, shift = tables(o, a0, a1, True)
        acc_in = A[(lvl - 1) % 2] if lvl > 0 else None
        pin = P[(g - 1) % 2] if g > 0 else None

        def src_of(kk):
            """The input node (gq << m) + kk of each unit: the previous
            group's partial sums, or the bands (rec_band_index), or band
            0 from the previous level's output."""
            node = (gq << m) + kk  # (U,)
            if a0 > 0:
                return [(pin, (node * B + bi) * numel, torch.ones_like(node, dtype=torch.bool))]
            assert bool((node < nb).all())
            from_acc = (node == 0) & (lvl > 0)
            ridx = node if lvl == 0 else nb + (nb - 1) * (lvl - 1) + node - 1
            return [(acc_in, bi * numel, from_acc),
                    (bands, (bi * nbands + ridx) * numel, ~from_acc)]

        X = windows(rowt, colt, cols, pitch, sh, shift, 2 ** m, src_of)
        steps = _flat_steps(tile, k, a0, a1, pitch)
        cur, cw = X, xw
        for s in range(m - 1):
            ow = yw if s % 2 == 0 else xw
            cur, cw = syn_step(cur, steps[s], 2 ** (m - s - 1), a0 + s, cw, ow), ow
        st, ax = steps[-1], a1 - 1
        p = torch.arange(tile_elems)
        gi, valid = positions(outr, o, p)
        base = last_base(st, p)[None, :] + sh[:, None]  # (U, items)
        idx = base[..., None] + (k[ax] - 1 - torch.arange(k[ax])) * st[0]
        total = gather_u(cur, idx, cw) @ tp[ax][0] + gather_u(cur, idx + st[4], cw) @ tp[ax][1]
        bi2 = bi[:, None].expand_as(gi)
        if not end:
            at = ((gq[:, None] * B + bi2) * numel + gi)[valid]
            P[g % 2][at] = total[valid]
            want = (2 ** (d - a1)) * B * numel
        elif last:
            at = (bi2 * numel + gi)[valid]
            epilogue(bi2[valid], gi[valid], total[valid] * scale, mom_i)
            want = B * numel
        else:
            at = (bi2 * numel + gi)[valid]
            A[lvl % 2][at] = total[valid] * scale
            want = B * numel
        cnt = torch.bincount(at)
        assert int((cnt > 1).sum()) == 0 and int((cnt == 1).sum()) == want, \
            "an output of the synthesis written other than once"

    def analysis(lam_i):
        for lvl in range(level):
            approx = V if lvl == 0 else A[(lvl - 1) % 2]
            final = lvl == level - 1
            off = nbands - (nb - 1) * (lvl + 1)
            for g in range(len(groups)):
                ana_pass(g, approx if g == 0 else P[(g - 1) % 2], P[g % 2], A[lvl % 2],
                         final, off, lam_i)

    def synthesis(mom_i):
        scale = 1.0 if preserve_l2 else 1.0 / nb
        for lvl in range(level):
            for g in range(len(groups)):
                syn_pass(g, lvl, lvl == level - 1, mom_i, scale)

    b_flat = arr.reshape(-1)
    if mode == "rec":
        synthesis(0.0)
        return out.reshape(arr.shape[:lead] + shape)
    if mode == "fista":
        m_ = mask.reshape(-1).to(cdt).repeat(B)
        bv = b_flat.to(cdt)
        x0 = (m_ * bv).to(T)
        out[:] = x0
        z[:] = x0
        zv = x0.to(cdt)
        V[:] = zv - step * (m_ * (m_ * zv - bv))
    else:
        V[:] = b_flat.to(cdt)
    lead_shape = arr.shape[:lead]
    if mode in ("dec", "pair"):
        analysis(lam)
        y = bands.reshape(lead_shape + (nbands,) + shape)
        if mode == "dec":
            return y
        synthesis(0.0)
        return y, out.reshape(lead_shape + shape)
    moms = [0.0] * len(lams) if moms is None else list(moms)
    for lam_i, mom_i in zip(lams, moms):
        analysis(lam_i)
        synthesis(mom_i)
    return out.reshape(lead_shape + shape)
