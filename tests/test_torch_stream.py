"""The streamed bodies (``csrc/nddwt_stream.cuh``: the synthesis of
``nddwt_rec_level`` and ``nddwt_lead_adj``, the analysis of
``nddwt_dec_level`` and ``nddwt_lead_dec``) on the CPU.

* Their schedules replayed (``ops/stream_ref.py``) on the geometry the
  wrappers build (``cuda_kernels.rec_stream_args``,
  ``cuda_kernels._level_stream_view``, ``cuda_kernels._stage_geometry``,
  ``cuda_kernels._walk_bands``) against the plain versions
  ``level_ref.rec_level_ref``, ``level4_ref.lead_adj_ref``,
  ``level_ref.dec_level_ref`` and ``level4_ref.lead_dec_ref``, which the
  older tests hold against the JAX package's kernels in interpret mode:
  filters of 2 to 76 taps, an axis of exactly K, extents that are no
  multiple of the plane tile or the chunk, a chunk of one plane, the
  halo-padded mode on the streamed axis and on a fast one, 2D, the 3D
  long-filter route of the lead stage, and for the analysis also ``lam >
  0``, ``final``, a band offset past 1 and the split walk (fewer in-plane
  bands a walk than the plane has). Tolerance relative to max|plain|:
  float32 1e-5, float64 1e-12, bfloat16 1e-2.
* The plane body of ``nddwt_rec_level``'s 3D views of 2 to 8 taps
  (``csrc/nddwt_plane.cuh``) replayed (``stream_ref.plane_replay``) against
  ``rec_level_ref``: every such filter length and dtype, whole-row windows
  and row pieces, tiles wider than their axes, ragged tiles and chunks,
  each axis halo-padded; the body ``nddwt_rec_level`` takes
  (``_rec_body``) for its views, the window body kept by the 2D levels,
  ``nddwt_lead_adj``, db5 and up, mixed filters, rows off 16 bytes and the
  multilevel kernels; its plans (``_plane_plan``, ``_plane_chunk``) and
  shared memory (``_plane_smem``).
* The analysis plane body of ``nddwt_dec_level``'s same views
  (``plane_ana_kernel``) replayed (``stream_ref.plane_ana_replay``)
  against ``dec_level_ref`` the same way, lam 0 and > 0, ``final`` both
  ways; the body ``nddwt_dec_level`` takes (``_dec_body``), its plans
  (``_plane_ana_plan``) and shared memory; and on the card (marked
  ``cuda``, skipped elsewhere) against the window body.
* The plans: shared memory within the budget for every filter length and
  dtype, the launch constraints the kernels check, and chunks and plane
  tiles that cover every output once.
* ``stage_route`` and ``NDDWT.route``'s multilevel route pinned to their
  answers on a table of shapes, wavelets and dtypes: the new plan moves no
  route.
"""

import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import flat, level4_ref, level_ref, multi, stream_ref

torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-2}
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16


def _close(got, want, dtype):
    want = want.double()
    err = (got.double() - want).abs().max().item()
    assert err <= TOL[dtype] * want.abs().max().item(), err


def _randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype)


def _padded_in(shape, taps, padded):
    return tuple(n + (t.shape[1] - 1 if p else 0)
                 for n, t, p in zip(shape, taps, padded or (False,) * len(shape)))


# (output shape, wavelet, dtype, halo-padded axes, plan override (C, T1, T2))
REC_CASES = [
    ((8, 12, 16), "db4", F32, None, None),  # streamed axis of extent K
    ((8, 12, 16), "db4", BF16, None, None),
    ((9, 10, 12), "db1", F64, None, None),  # K = 2
    ((11, 21, 37), "db2", F32, None, (4, 16, 64)),  # no multiple of tile or chunk
    ((11, 21, 37), "db2", F32, None, (1, 32, 32)),  # a chunk of one plane
    ((10, 12, 14), ("db2", "db3", "db4"), F64, None, None),  # mixed: runtime taps
    ((30, 30, 31), "db14", F32, None, (15, 4, 64)),  # the longest 3D filter here
    ((12, 9, 10), "db2", F32, (True, False, False), None),  # padded streamed axis
    ((10, 12, 9), "db4", F32, (False, False, True), None),  # padded fast axis
    ((10, 9, 12), "db3", F64, (True, True, False), None),
    ((9, 300), ("db2", "db6"), F32, None, None),  # 2D
    ((9, 40), "db2", F64, (False, True), None),  # 2D, padded
    ((80, 90), "db38", F32, None, (40, 1, 256)),  # 2D, 76 taps
]


@pytest.mark.parametrize("shape,wv,dtype,padded,plan", REC_CASES)
def test_rec_schedule_matches_plain(monkeypatch, shape, wv, dtype, padded, plan):
    """The replay of ``nddwt_rec_level``'s schedule (the plane body's or
    the window body's, as ``rec_stream_args`` chooses) against
    ``rec_level_ref``, band 0 from ``approx`` and from ``y``."""
    if plan is not None:
        monkeypatch.setattr(ck, "_stream_plan", lambda *args: plan)
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    taps = tw.NDDWT(wv, shape, device="cpu").taps_hp
    in_shape = _padded_in(shape, taps, padded)
    nb = 2 ** len(shape)
    y = _randn(rng, (2 * nb - 1,) + in_shape, dtype)
    approx = _randn(rng, in_shape, dtype)
    for src in ([("y", b) for b in range(nb)],
                [("a", 0)] + [("y", nb + b - 1) for b in range(1, nb)]):
        out_shape, idx, (n, k, t, left, bit, pad, arr), body = ck.rec_stream_args(
            y, approx, src, taps, padded)
        assert out_shape == shape
        view = (-1,) + tuple(m + (K - 1 if p else 0) for m, K, p in zip(n, k, pad))
        if body == "plane":
            got = stream_ref.plane_replay(
                y.reshape(view), approx.reshape(view[1:]), idx, n, k, t, left, bit, pad,
                arr, 0.125, ck._plane_stages(n, k, t, dtype, pad), ck._PLANE_THREADS)
        else:
            got = stream_ref.stream_replay(
                y.reshape(view), approx.reshape(view[1:]), idx + [-1] * (16 - nb), n, k, t,
                left, bit, pad, arr,
                1, 0.125, ck._stream_items(k))
        want = level_ref.rec_level_ref(y, approx, src, taps, 0.125, padded)
        _close(got.reshape(shape), want, dtype)


# The plane body (csrc/nddwt_plane.cuh): (output shape, wavelet, dtype,
# halo-padded axes, plan override (C, T1, T2)). Filters of 2 to 8 taps in
# every dtype; whole-row windows (the tile spans slot 2) and row pieces;
# tiles wider than their axes (window rows wrapped at both ends, three
# pieces or runs); rows and columns no multiple of the tile and a last chunk
# short of C; each axis halo-padded.
PLANE_CASES = [
    ((9, 10, 12), "db1", F32, None, None),
    ((10, 16, 24), "db2", BF16, None, None),
    ((12, 14, 16), "db3", F64, None, None),
    ((8, 12, 16), "db4", F32, None, None),  # slot 0 of extent K
    ((9, 12, 16), "db4", F64, None, None),
    ((8, 12, 24), "db4", BF16, None, None),
    ((9, 12, 20), "db4", F32, None, (9, 64, 32)),  # the tile wider than n1 and n2
    ((11, 40, 36), "db2", F32, None, (4, 32, 64)),  # whole rows, ragged rows, chunk
    ((11, 20, 40), "db2", F32, None, (4, 64, 32)),  # row pieces, ragged columns
    ((10, 20, 34), "db4", F64, None, (3, 32, 32)),
    ((12, 24, 72), "db3", BF16, None, (5, 32, 64)),
    ((13, 20, 24), "db2", F32, None, (5, 8, 256)),
    ((10, 22, 12), "db1", F64, None, (4, 32, 32)),
    ((12, 9, 12), "db2", F32, (True, False, False), None),
    ((10, 12, 16), "db4", F64, (False, True, False), None),
    ((10, 9, 13), "db2", F32, (False, False, True), None),  # row pieces, unwrapped
    ((11, 12, 15), "db1", BF16, (True, True, True), None),
    ((9, 11, 19), "db3", F32, (True, False, True), (3, 8, 256)),
]


@pytest.mark.parametrize("shape,wv,dtype,padded,plan", PLANE_CASES)
def test_plane_schedule_matches_plain(monkeypatch, shape, wv, dtype, padded, plan):
    """The replay of the plane body's schedule (``stream_ref.plane_replay``:
    the stage walk per input plane and s0, the bulk copies of the rows in
    pieces split at the periodic wrap with their 16-byte slack, or in runs
    of whole rows, slot 1 before slot 2) on the launch ``rec_stream_args``
    builds, against ``rec_level_ref``, band 0 from ``approx`` and from
    ``y``, with every stage count the layout allows."""
    if plan is not None:
        monkeypatch.setattr(ck, "_plane_plan", lambda *args: plan)
    rng = np.random.default_rng(shape[0] * 13 + shape[2])
    taps = tw.NDDWT(wv, shape, device="cpu").taps_hp
    in_shape = _padded_in(shape, taps, padded)
    y = _randn(rng, (15,) + in_shape, dtype)
    approx = _randn(rng, in_shape, dtype)
    for i, src in enumerate(([("y", b) for b in range(8)],
                             [("a", 0)] + [("y", 7 + b) for b in range(1, 8)])):
        _, idx, (n, k, t, left, bit, pad, arr), body = ck.rec_stream_args(
            y, approx, src, taps, padded)
        assert body == "plane"
        stages = ck._plane_stages(n, k, t, dtype, pad)
        assert stages >= 2
        got = stream_ref.plane_replay(y, approx, idx, n, k, t, left, bit, pad, arr, 0.125,
                                      2 + (stages - 2) * i, ck._PLANE_THREADS)
        want = level_ref.rec_level_ref(y, approx, src, taps, 0.125, padded)
        _close(got, want, dtype)


def _offset(t, shift):
    """``t`` as a view ``shift`` elements into a larger buffer."""
    flat = torch.zeros(t.numel() + shift, dtype=t.dtype)
    return flat[shift:].view(t.shape).copy_(t)


# (view n, taps per slot, halo-padded flags, dtype, an array off 16 bytes):
# the body nddwt_rec_level takes
BODIES = [
    ((320, 320, 256), [8] * 3, [False] * 3, F32, False, "plane"),
    ((256, 256, 256), [8] * 3, [False] * 3, F64, False, "plane"),
    ((256, 256, 256), [8] * 3, [False] * 3, BF16, False, "plane"),
    ((40, 41, 48), [2] * 3, [False] * 3, F32, False, "plane"),
    ((40, 41, 48), [6] * 3, [True, True, False], BF16, False, "plane"),
    ((40, 41, 45), [4] * 3, [False, False, True], F32, False, "plane"),  # m2 = 48
    ((40, 41, 46), [4] * 3, [False] * 3, F64, False, "plane"),
    ((40, 41, 46), [4] * 3, [False] * 3, F32, False, "window"),  # rows off 16 bytes
    ((40, 41, 44), [4] * 3, [False] * 3, BF16, False, "window"),
    ((40, 41, 48), [4] * 3, [False] * 3, F32, True, "window"),  # an array off 16 bytes
    ((320, 1, 256), [8, 1, 8], [False] * 3, F32, False, "window"),  # 2D
    ((64, 64, 512), [8, 8, 1], [False] * 3, F32, False, "window"),  # lead_adj's view
    ((48, 48, 48), [10] * 3, [False] * 3, F32, False, "window"),  # db5
    ((48, 48, 48), [8, 4, 6], [False] * 3, F32, False, "window"),  # mixed
]


@pytest.mark.parametrize("n,k,pad,dtype,off,want", BODIES)
def test_rec_body_choice(n, k, pad, dtype, off, want):
    """``_rec_body`` (``plane_takes``): the plane body for 3D views with one
    length of 2 to 8 taps on every slot whose input rows start on 16 bytes;
    the window body for 2D views, ``nddwt_lead_adj``'s view, db5 and up,
    mixed filters and rows or arrays off 16 bytes."""
    ptrs = [4096, 4096 + (2 if off else 0)]
    assert ck._rec_body(list(n), k, pad, dtype, ptrs) == want
    if want == "plane":
        assert ck._plane_plan(list(n), k, dtype, pad) is not None


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_rec_body_of_arrays(dtype):
    """``rec_stream_args`` on arrays: the plane body for a 3D db4 level of
    every dtype with rows on 16 bytes, its plan ``_plane_plan``'s; the
    window body, with ``_stream_plan``'s plan, where the approximation
    is a view off 16 bytes (and the plane body again where band 0 comes
    from ``y``), for 2D levels and for db5."""
    shape = (10, 12, 16)
    taps = tw.NDDWT("db4", shape, device="cpu").taps_hp
    y = torch.zeros((15,) + shape, dtype=dtype)
    approx = torch.zeros(shape, dtype=dtype)
    ys = [("y", b) for b in range(8)]
    via_a = [("a", 0)] + [("y", 7 + b) for b in range(1, 8)]
    for src, a, want in ((ys, approx, "plane"), (via_a, approx, "plane"),
                         (via_a, _offset(approx, 1), "window"),
                         (ys, _offset(approx, 1), "plane")):
        _, _, (n, k, t, *_), body = ck.rec_stream_args(y, a, src, taps)
        assert body == want
        assert tuple(t) == (ck._plane_plan(n, k, dtype) if want == "plane"
                            else ck._stream_plan(n, k, dtype, "rec"))
    for shape, wv in (((24, 40), "db4"), ((12, 12, 16), "db5")):
        taps = tw.NDDWT(wv, shape, device="cpu").taps_hp
        nb = 2 ** len(shape)
        y = torch.zeros((nb,) + shape, dtype=dtype)
        assert ck.rec_stream_args(y, None, [("y", b) for b in range(nb)], taps)[3] == "window"


def test_multilevel_and_lead_stage_keep_the_window_body():
    """The multilevel kernels' synthesis and analysis and the synthesis
    and analysis of the lead stage (``nddwt_lead_adj``,
    ``nddwt_lead_dec``) are the window bodies: their plans are
    ``_stream_plan``'s, and only ``nddwt_level.cu`` includes the plane
    bodies' header, and only it launches their kernels."""
    taps = tw.NDDWT("db4", (64, 64, 64), device="cpu").taps_hp
    for rec, kind in ((True, "rec"), (False, "dec")):
        n, k, t, *_ = multi._multi_geometry((64, 64, 64), taps, rec, F32, 2)
        assert tuple(t) == ck._stream_plan(n, k, F32, kind, 2)
    taps4 = tw.NDDWT("db4", (16, 16, 8, 8), device="cpu").taps_hp
    for adj, kind in ((True, "lead"), (False, "lead_dec")):
        (n, k, t, *_), _ = ck._stage_geometry((16, 16, 8, 8), taps4, False, adj, F32)
        assert tuple(t) == ck._stream_plan(n, k, F32, kind)
    including = sorted(p.name for p in ck.CSRC.glob("*.c*")
                       if '#include "nddwt_plane.cuh"' in p.read_text())
    assert including == ["nddwt_level.cu"]
    for name in ("launch_plane<", "launch_plane_ana<", "plane_takes<", "plane_ana_takes<"):
        using = sorted(p.name for p in ck.CSRC.glob("*.cu") if name in p.read_text())
        assert using == ["nddwt_level.cu"], name


# shapes of the plane body's plans: the benchmark's, 256^3, and narrow ones
PLANE_SHAPES = [(320, 320, 256), (256, 256, 256), (128, 128, 128), (40, 41, 48),
                (9, 300, 40), (64, 40, 640), (12, 12, 16)]


@pytest.mark.parametrize("dtype", [F32, BF16, F64])
def test_plane_plan_fits_and_covers(dtype):
    """Every plane plan: the form ``plane_takes`` checks, shared memory
    (with the static taps and barriers) within one SM's 227 KB, a chunk of
    at least K0, and chunks and tiles that cover each output once."""
    word = 8 if dtype == F64 else 4
    ni = {4: 4, 8: 2}[word]
    static = 3 * 2 * 76 * word + 32
    threads = ck._PLANE_THREADS
    for n in PLANE_SHAPES:
        for K in (2, 4, 6, 8):
            for pad in ([False] * 3, [True, True, False], [False, False, True]):
                k = [K] * 3
                m2 = n[2] + (K - 1 if pad[2] else 0)
                if m2 % (16 // torch.empty((), dtype=dtype).element_size()):
                    continue
                C, T1, T2 = t = ck._plane_plan(list(n), k, dtype, pad)
                assert T1 % 4 == 0 and T2 & (T2 - 1) == 0 and T1 * T2 == threads * ni
                cols = n[2] if ck._plane_whole(n, t, pad) else T2 + K - 1
                assert 2 * (T1 // 4) * cols <= 3 * threads
                stages = ck._plane_stages(n, k, t, dtype, pad)
                smem = ck._plane_smem(n, k, t, dtype, stages, pad)
                assert 2 <= stages <= 4 and smem <= ck._PLANE_SMEM
                assert smem + static <= 227 * 1024
                assert min(n[0], K) <= C <= n[0]
                for extent, step in ((n[0], C), (n[1], T1), (n[2], T2)):
                    starts = range(0, extent, step)
                    cover = [p for s in starts for p in range(s, min(s + step, extent))]
                    assert cover == list(range(extent))


def test_plane_plans_of_the_benchmark():
    """knee3d's (320, 320, 256) db4 level: the float32 plan's tile spans
    the rows (whole-row windows of 8 rows a tile, three stages), its 120
    CTAs one wave of one CTA an SM; float64 tiles of 4 rows, 240 CTAs in
    two waves; 256^3 and its {"x": 2} block likewise."""
    k = [8] * 3
    for n, dtype, plan, ctas in (((320, 320, 256), F32, (107, 8, 256), 120),
                                 ((320, 320, 256), F64, (107, 4, 256), 240),
                                 ((256, 256, 256), F32, (64, 8, 256), 128),
                                 ((256, 256, 256), F64, (128, 4, 256), 128),
                                 ((128, 256, 256), F32, (32, 8, 256), 128)):
        t = ck._plane_plan(list(n), k, dtype)
        assert t == plan and ck._plane_whole(n, t, [False] * 3)
        assert -(-n[0] // t[0]) * -(-n[1] // t[1]) == ctas
    assert ck._plane_stages((320, 320, 256), k, (107, 8, 256), F32) == 3


# (n0, K, units a chunk): the chunk, worked by hand as the waves of 132 CTAs
# times C + K - 1 planes
CHUNKS = [
    (320, 8, 40, 107),  # 3 chunks, 1 wave x 114 (2 chunks: 1 x 167; 6: 2 x 61)
    (320, 8, 80, 107),  # 2 waves x 114 (1 chunk: 1 x 327; 4: 3 x 87)
    (256, 8, 32, 64),  # 1 x 71 (8 chunks: 2 x 39)
    (256, 8, 64, 128),  # 1 x 135 (4 chunks: 2 x 71)
    (128, 8, 8, 8),  # 16 chunks of K, 1 x 15
    (9, 8, 1, 8),  # at least K
    (5, 8, 1, 5),  # or the whole axis
]


@pytest.mark.parametrize("n0,K,units,want", CHUNKS)
def test_plane_chunk(n0, K, units, want):
    assert ck._plane_chunk(n0, K, units) == want


def test_plane_smem_is_the_sources_layout():
    """``_plane_smem`` at a few plans, worked by hand from
    ``plane_layout``: 128 bytes to align the buffers, stage buffers of four
    windows of T1 + K - 1 rows (whole rows of n2, else T2 + K - 1 columns
    and the shift's slack in whole 128 bytes), and Q, 2 x 2 x T1 rows of
    T2 - NI + NI + K - 1 rounded to a vector."""
    n = (320, 320, 256)
    # whole rows, f32 db4 (8, 256): 15 rows of 256 floats; Q rows of 256 - 4 + 12
    assert ck._plane_smem(n, [8] * 3, (107, 8, 256), F32, 3) == (
        128 + 3 * 4 * 15 * 256 * 4 + 4 * 8 * 264 * 4)
    # row pieces, f32 db4 (16, 128): rows of 135 + 3 -> 160 floats, Q rows 136
    assert ck._plane_smem(n, [8] * 3, (107, 16, 128), F32, 2) == (
        128 + 2 * 4 * 23 * 160 * 4 + 4 * 16 * 136 * 4)
    # whole rows, f64 db4 (4, 256): 11 rows of 256 doubles, Q rows 256 - 2 + 10
    assert ck._plane_smem(n, [8] * 3, (107, 4, 256), F64, 2) == (
        128 + 2 * 4 * 11 * 256 * 8 + 4 * 4 * 264 * 8)
    # bf16 db1 whole rows of 256 halves, Q in float: 256 - 4 + 8
    assert ck._plane_smem(n, [2] * 3, (107, 8, 256), BF16, 4) == (
        128 + 4 * 4 * 9 * 256 * 2 + 4 * 8 * 260 * 4)
    # a padded slot 2 takes row pieces: (40, 41, 45) db2 -> m2 48, rows of
    # 256 + 3 + 3 -> 288 floats; four stages do not fit
    pad = (False, False, True)
    assert not ck._plane_whole((40, 41, 45), (1, 8, 256), pad)
    assert ck._plane_smem((40, 41, 45), [4] * 3, (1, 8, 256), F32, 2, pad) == (
        128 + 2 * 4 * 11 * 288 * 4 + 4 * 8 * 260 * 4)
    assert ck._plane_stages((40, 41, 45), [4] * 3, (1, 8, 256), F32, pad) == 3


# The analysis plane body (plane_ana_kernel in csrc/nddwt_plane.cuh):
# (output shape, wavelet, dtype, halo-padded axes, plan override (C, T1,
# T2)). Filters of 2 to 8 taps in every dtype; whole-row windows (the tile
# spans slot 2) and row pieces; tiles wider than their axes (window rows
# wrapped at both ends, three pieces or runs); rows and columns no multiple
# of the tile and a last chunk short of C; a chunk longer than the axis;
# each axis halo-padded.
PLANE_ANA_CASES = [
    ((9, 10, 12), "db1", F32, None, None),
    ((10, 16, 24), "db2", BF16, None, None),
    ((12, 14, 16), "db3", F64, None, None),
    ((8, 12, 16), "db4", F32, None, None),  # slot 0 of extent K
    ((9, 12, 16), "db4", F64, None, None),
    ((8, 12, 24), "db4", BF16, None, None),
    ((9, 12, 20), "db4", F32, None, (9, 64, 16)),  # the tile wider than n1, row pieces
    ((11, 40, 36), "db2", F32, None, (4, 8, 128)),  # whole rows, ragged rows, chunk
    ((11, 20, 40), "db2", F32, None, (4, 32, 32)),  # row pieces, ragged columns
    ((10, 20, 34), "db4", F64, None, (3, 16, 32)),
    ((12, 24, 72), "db3", BF16, None, (5, 32, 32)),
    ((13, 20, 24), "db2", F32, None, (5, 2, 512)),  # whole rows of a tile twice as wide
    ((9, 24, 16), "db3", F32, None, (20, 8, 128)),  # a chunk longer than n0
    ((10, 22, 12), "db1", F64, None, (4, 32, 16)),
    ((12, 9, 12), "db2", F32, (True, False, False), None),
    ((10, 12, 16), "db4", F64, (False, True, False), None),
    ((10, 9, 13), "db2", F32, (False, False, True), None),  # row pieces, unwrapped
    ((11, 12, 15), "db1", BF16, (True, True, True), None),
    ((9, 11, 19), "db3", F32, (True, False, True), (3, 4, 256)),
]


@pytest.mark.parametrize("lam,final", [(0.0, False), (0.1, True)])
@pytest.mark.parametrize("shape,wv,dtype,padded,plan", PLANE_ANA_CASES)
def test_plane_ana_schedule_matches_plain(monkeypatch, shape, wv, dtype, padded, plan, lam,
                                          final):
    """The replay of the analysis plane body's schedule
    (``stream_ref.plane_ana_replay``: one stage a plane, the bulk copies of
    the window's rows in pieces split at the periodic wrap with their
    16-byte slack, or in runs of whole rows, slot 1 before slot 2, the
    in-plane bands split between the CTA's halves, the division-free
    shrink) on the launch ``dec_stream_args`` builds, against
    ``dec_level_ref``: every band of ``big`` (written at offset 8, the rest
    untouched) and the approximation, with every stage count the layout
    allows."""
    if plan is not None:
        monkeypatch.setattr(ck, "_plane_ana_plan", lambda *args: plan)
    rng = np.random.default_rng(shape[0] * 17 + shape[2])
    taps = tw.NDDWT(wv, shape, device="cpu").taps_hp
    x = _randn(rng, _padded_in(shape, taps, padded), dtype)
    (n, k, t, left, bit, pad, arr), body = ck.dec_stream_args(x, shape, taps, padded)
    assert body == "plane"
    stages = ck._plane_stages(n, k, t, dtype, pad, 1)
    assert stages >= 2
    for used in sorted({2, stages}):
        big, approx = _dec_outputs(rng, 8, shape, dtype)
        want_big, want_approx = big.clone(), approx.clone()
        got_approx = big[0] if final else approx
        stream_ref.plane_ana_replay(x, big, got_approx, 8, n, k, t, left, bit, pad, arr, lam,
                                    used, ck._PLANE_THREADS)
        ref = level_ref.dec_level_ref(x, want_big, 8, taps, lam, final, padded)
        _close(big, want_big, dtype)
        if not final:
            _close(approx, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16, F64])
def test_plane_ana_matches_window_body_on_card(dtype):
    """On the card, ``dec_level`` on the analysis plane body against the
    window body on the same input moved off 16 bytes (the counter
    ``nddwt.dec_level.body.*`` says which ran) and against
    ``dec_level_ref``: whole rows and row pieces, a halo-padded axis, lam 0
    and 0.1, ``final`` both ways."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from non_decimated_wavelets_tpu_torch import tracing

    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape, wv, padded in (((24, 40, 72), "db4", None), ((9, 6, 600), "db2", None),
                              ((11, 12, 16), "db3", (True, False, False)),
                              ((10, 9, 13), "db2", (False, False, True))):
        taps = tw.NDDWT(wv, shape, device="cuda").taps_hp
        ins = _padded_in(shape, taps, padded)
        x = torch.randn(ins, generator=gen, device="cuda").to(dtype)
        moved = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:].view(ins).copy_(x)
        for lam, final in ((0.0, False), (0.1, True), (0.1, False)):
            got = []
            for inp, want in ((x, "plane"), (moved, "window")):
                big = torch.zeros((15,) + shape, dtype=dtype, device="cuda")
                tracing.reset()
                tracing.enable()
                a = ck.dec_level(inp, big, 8, taps, lam, final, padded)
                torch.cuda.synchronize()
                tracing.disable()
                counters = tracing.summary()["counters"]
                assert [c for c in counters if c.startswith("nddwt.dec_level.body.")] == [
                    f"nddwt.dec_level.body.{want}"]
                got.append(big if final else torch.cat([big, a[None]]))
            rb = torch.zeros((15,) + shape, dtype=dtype)
            ra = level_ref.dec_level_ref(x.cpu(), rb, 8, taps, lam, final, padded)
            want = rb if final else torch.cat([rb, ra[None]])
            _close(got[0].cpu(), want, dtype)
            _close(got[0], got[1], dtype)


@pytest.mark.cuda
def test_level_launch_refuses_a_plan_not_of_its_body():
    """``nddwt_dec_level`` and ``nddwt_rec_level`` run the body they are
    named and return ``cudaErrorInvalidValue`` (1) where the plan does not
    fit it: the window body's plan named plane, the plane body's named
    window, the plane body named where the input is off 16 bytes, and a
    body that does not exist; the plan built for each body runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import ctypes

    shape, stream = (24, 40, 72), torch.cuda.current_stream().cuda_stream
    taps = tw.NDDWT("db4", shape, device="cuda").taps_hp
    x = torch.randn(shape, device="cuda")
    moved = torch.empty(x.numel() + 1, device="cuda")[1:].view(shape).copy_(x)
    big, out = torch.zeros((15,) + shape, device="cuda"), torch.empty(shape, device="cuda")
    lib = ck.load()
    (n, k, plane, left, bit, pad, arr), body = ck.dec_stream_args(x, shape, taps)
    window = ck._stream_plan(n, k, F32, "dec")
    assert body == "plane"

    def dec(inp, t, body):
        return lib.nddwt_dec_level(
            inp.data_ptr(), big.data_ptr(), out.data_ptr(), 0, *map(ck._ints, (n, k, t, left, bit)),
            ck._taps_ptr(arr), 8, 0.0, ck._walk_bands(k, window, F32), ck._ints(pad), body,
            stream)

    assert [dec(x, window, 1), dec(x, plane, 0), dec(moved, plane, 1), dec(x, plane, 2)] == [1] * 4
    assert [dec(x, plane, 1), dec(x, window, 0), dec(moved, window, 0)] == [0] * 3
    y = torch.randn((8,) + shape, device="cuda")
    src = [("y", b) for b in range(8)]
    _, _, (n, k, plane, left, bit, pad, arr), body = ck.rec_stream_args(y, None, src, taps)
    window = ck._stream_plan(n, k, F32, "rec")
    assert body == "plane"
    idx = (ctypes.c_longlong * 8)(*range(8))

    def rec(t, body):
        return lib.nddwt_rec_level(
            y.data_ptr(), y.data_ptr(), out.data_ptr(), 0, *map(ck._ints, (n, k, t, left, bit)),
            ck._taps_ptr(arr), idx, 1.0, ck._ints(pad), body, stream)

    assert [rec(window, 1), rec(plane, 0), rec(plane, 2)] == [1] * 3
    assert [rec(plane, 1), rec(window, 0)] == [0] * 2
    torch.cuda.synchronize()


# (view n, taps per slot, halo-padded flags, dtype, the input off 16 bytes):
# the body nddwt_dec_level takes
DEC_BODIES = [
    ((320, 320, 256), [8] * 3, [False] * 3, F32, False, "plane"),
    ((320, 320, 256), [8] * 3, [False] * 3, F64, False, "plane"),
    ((256, 256, 256), [8] * 3, [False] * 3, BF16, False, "plane"),
    ((40, 41, 48), [2] * 3, [False] * 3, F32, False, "plane"),
    ((40, 41, 48), [6] * 3, [True, True, False], BF16, False, "plane"),
    ((40, 41, 45), [4] * 3, [False, False, True], F32, False, "plane"),  # m2 = 48
    ((40, 41, 46), [4] * 3, [False] * 3, F64, False, "plane"),
    ((40, 41, 46), [4] * 3, [False] * 3, F32, False, "window"),  # rows off 16 bytes
    ((40, 41, 44), [4] * 3, [False] * 3, BF16, False, "window"),
    ((40, 41, 48), [4] * 3, [False] * 3, F32, True, "window"),  # the input off 16 bytes
    ((320, 1, 256), [8, 1, 8], [False] * 3, F32, False, "window"),  # 2D
    ((64, 64, 512), [8, 8, 1], [False] * 3, F32, False, "window"),  # lead_dec's view
    ((48, 48, 48), [10] * 3, [False] * 3, F32, False, "window"),  # db5
    ((48, 48, 48), [8, 4, 6], [False] * 3, F32, False, "window"),  # mixed
]


@pytest.mark.parametrize("n,k,pad,dtype,off,want", DEC_BODIES)
def test_dec_body_choice(n, k, pad, dtype, off, want):
    """``_dec_body`` (``plane_ana_takes``): the plane body for 3D views with
    one length of 2 to 8 taps on every slot whose input rows start on 16
    bytes; the window body for 2D views, ``nddwt_lead_dec``'s view, db5 and
    up, mixed filters and rows or an input off 16 bytes."""
    ptrs = [4096 + (2 if off else 0)]
    assert ck._dec_body(list(n), k, pad, dtype, ptrs) == want
    if want == "plane":
        assert ck._plane_ana_plan(list(n), k, dtype, pad) is not None


@pytest.mark.parametrize("dtype", [F32, BF16, F64])
def test_dec_body_of_arrays(dtype):
    """``dec_stream_args`` on arrays: the plane body, with
    ``_plane_ana_plan``'s plan, for a 3D db4 level with rows on 16 bytes;
    the window body, with ``_stream_plan``'s plan, for the same input moved
    off 16 bytes, for 2D levels and for db5."""
    shape = (10, 12, 16)
    taps = tw.NDDWT("db4", shape, device="cpu").taps_hp
    x = torch.zeros(shape, dtype=dtype)
    for a, want in ((x, "plane"), (_offset(x, 1), "window")):
        (n, k, t, *_), body = ck.dec_stream_args(a, shape, taps)
        assert body == want
        assert tuple(t) == (ck._plane_ana_plan(n, k, dtype) if want == "plane"
                            else ck._stream_plan(n, k, dtype, "dec"))
    for shape, wv in (((24, 40), "db4"), ((12, 12, 16), "db5")):
        taps = tw.NDDWT(wv, shape, device="cpu").taps_hp
        assert ck.dec_stream_args(torch.zeros(shape, dtype=dtype), shape, taps)[1] == "window"


@pytest.mark.parametrize("dtype", [F32, BF16, F64])
def test_plane_ana_plan_fits_and_covers(dtype):
    """Every analysis plane plan: the form ``plane_ana_takes`` checks,
    shared memory (with the static taps and barriers) within one SM's 227
    KB, a chunk of at least K0, and chunks and tiles that cover each output
    once."""
    word = 8 if dtype == F64 else 4
    ni = {4: 4, 8: 2}[word]
    static = 3 * 2 * 76 * word + 32
    threads = ck._PLANE_THREADS
    for n in PLANE_SHAPES:
        for K in (2, 4, 6, 8):
            for pad in ([False] * 3, [True, True, False], [False, False, True]):
                k = [K] * 3
                m2 = n[2] + (K - 1 if pad[2] else 0)
                if m2 % (16 // torch.empty((), dtype=dtype).element_size()):
                    continue
                C, T1, T2 = t = ck._plane_ana_plan(list(n), k, dtype, pad)
                assert T1 % 2 == 0 and T2 & (T2 - 1) == 0 and T1 * T2 == threads // 2 * ni
                cols = n[2] if ck._plane_whole(n, t, pad) else T2 + K - 1
                assert T1 // 2 * cols <= 3 * threads
                stages = ck._plane_stages(n, k, t, dtype, pad, 1)
                smem = ck._plane_smem(n, k, t, dtype, stages, pad, 1)
                assert 2 <= stages <= 4 and smem <= ck._PLANE_SMEM
                assert smem + static <= 227 * 1024
                assert min(n[0], K) <= C <= n[0]
                for extent, step in ((n[0], C), (n[1], T1), (n[2], T2)):
                    starts = range(0, extent, step)
                    cover = [p for s in starts for p in range(s, min(s + step, extent))]
                    assert cover == list(range(extent))


def test_plane_ana_plans_of_the_benchmark():
    """knee3d's (320, 320, 256) db4 level: the float32 analysis plan's tile
    spans the rows (whole-row windows of 4 rows a tile, four stages), its
    240 CTAs two waves of one CTA an SM; float64 tiles of 2 rows, 640 CTAs
    in five; 256^3 and its {"x": 2} block in one wave."""
    k = [8] * 3
    for n, dtype, plan, ctas in (((320, 320, 256), F32, (107, 4, 256), 240),
                                 ((320, 320, 256), F64, (80, 2, 256), 640),
                                 ((320, 320, 256), BF16, (107, 4, 256), 240),
                                 ((256, 256, 256), F32, (128, 4, 256), 128),
                                 ((256, 256, 256), F64, (256, 2, 256), 128),
                                 ((128, 256, 256), F32, (64, 4, 256), 128)):
        t = ck._plane_ana_plan(list(n), k, dtype)
        assert t == plan and ck._plane_whole(n, t, [False] * 3)
        assert -(-n[0] // t[0]) * -(-n[1] // t[1]) == ctas
        assert ck._dec_body(list(n), k, [False] * 3, dtype, [0]) == "plane"
    assert ck._plane_stages((320, 320, 256), k, (107, 4, 256), F32, windows=1) == 4


def test_plane_ana_smem_is_the_sources_layout():
    """``_plane_smem`` of the analysis (one window a stage) at a few plans,
    worked by hand from ``plane_ana_layout``: 128 bytes to align the
    buffers, stage buffers of one window of T1 + K - 1 rows (whole rows of
    n2, else T2 + K - 1 columns and the shift's slack in whole 128 bytes),
    and Q, 2 x 2 x T1 rows of T2 - NI + NI + K - 1 rounded to a vector."""
    n = (320, 320, 256)
    # whole rows, f32 db4 (4, 256): 11 rows of 256 floats; Q rows of 256 - 4 + 12
    assert ck._plane_smem(n, [8] * 3, (107, 4, 256), F32, 4, windows=1) == (
        128 + 4 * 11 * 256 * 4 + 4 * 4 * 264 * 4)
    # row pieces, f32 db4 (8, 128): rows of 135 + 3 -> 160 floats, Q rows 136
    assert ck._plane_smem(n, [8] * 3, (107, 8, 128), F32, 3, windows=1) == (
        128 + 3 * 15 * 160 * 4 + 4 * 8 * 136 * 4)
    # whole rows, f64 db4 (2, 256): 9 rows of 256 doubles, Q rows 256 - 2 + 10
    assert ck._plane_smem(n, [8] * 3, (80, 2, 256), F64, 4, windows=1) == (
        128 + 4 * 9 * 256 * 8 + 4 * 2 * 264 * 8)


LEAD_CASES = [
    ((8, 12, 8, 9), "db4", F32, None, None),  # X of extent K
    ((8, 12, 8, 9), "db4", BF16, None, None),
    ((13, 11, 4, 5), "db2", F32, None, (4, 32, 32)),
    ((9, 10, 4, 4), "db2", F64, None, (1, 64, 16)),  # a chunk of one plane
    ((9, 10, 4, 6), "db2", F32, (True, False), None),  # padded X (streamed)
    ((9, 10, 6, 7), "db3", F64, (False, True), None),  # padded Y
    ((40, 41, 45), "db20", F32, None, None),  # the 3D long-filter route
]


@pytest.mark.parametrize("shape,wv,dtype,padded,plan", LEAD_CASES)
def test_lead_adj_schedule_matches_plain(monkeypatch, shape, wv, dtype, padded, plan):
    """The replay of ``nddwt_lead_adj``'s schedule against
    ``lead_adj_ref`` on the (X, Y, Z*T) view, every lane group."""
    if plan is not None:
        monkeypatch.setattr(ck, "_stream_plan", lambda *args: plan)
    rng = np.random.default_rng(shape[0] * 7 + len(shape))
    taps = tw.NDDWT(wv, shape, device="cpu").taps_hp
    pad2 = padded or (False, False)
    in_shape = _padded_in(shape, taps, pad2 + (False,) * (len(shape) - 2))
    nb = 2 ** len(shape)
    y = _randn(rng, (2 * nb - 1,) + in_shape, dtype)
    approx = _randn(rng, in_shape, dtype)
    src = [("a", 0)] + [("y", nb + b - 1) for b in range(1, nb)]
    n, k, t, left, arr = (list(v) if not isinstance(v, np.ndarray) else v
                          for v in ck._stage_geometry(shape, taps, False, True, dtype, pad2)[0])
    idx = [-1] + [nb + b - 1 for b in range(1, nb)]
    pad = list(pad2) + [False]
    view = (-1, in_shape[0], in_shape[1], int(np.prod(in_shape[2:])))
    nl = nb // 4
    got = stream_ref.stream_replay(
        y.reshape(view), approx.reshape(view[1:]), idx + [-1] * (16 - nb), n, k, t, left,
        [0, 1, 0], pad, arr, nl, 1.0, ck._stream_items(k))
    want = level4_ref.lead_adj_ref(y, approx, src, taps, pad2)
    _close(got.reshape(want.shape), want, dtype)


# (output shape, wavelet, dtype, halo-padded axes, plan override (C, T1, T2),
# whether the walk is split: fewer in-plane bands a walk than the plane has)
DEC_CASES = [
    ((8, 40, 72), "db4", F32, None, None, False),  # streamed axis of extent K
    ((8, 40, 72), "db4", BF16, None, None, False),
    ((8, 12, 16), "db4", F64, None, None, False),
    ((9, 10, 12), "db1", F32, None, None, False),  # K = 2
    ((11, 21, 37), "db2", F32, None, (4, 16, 64), False),  # no multiple of tile or chunk
    ((11, 21, 37), "db2", F64, None, (1, 16, 32), False),  # a chunk of one plane
    ((10, 12, 14), ("db2", "db3", "db4"), F64, None, None, False),  # mixed: runtime taps
    ((30, 30, 31), "db10", F32, None, None, False),  # runtime taps, the whole ring
    ((24, 25, 26), "db11", F64, None, None, True),  # the longest f64 3D filter here
    ((12, 9, 10), "db2", F32, (True, False, False), None, False),  # padded streamed axis
    ((10, 12, 9), "db4", BF16, (False, False, True), None, False),  # padded fast axis
    ((10, 9, 12), "db3", F64, (True, True, False), None, False),
    ((9, 300), ("db2", "db6"), F32, None, None, False),  # 2D
    ((32, 40), "db4", BF16, None, None, False),  # 2D, unrolled taps
    ((9, 40), "db2", F64, (False, True), None, False),  # 2D, padded
    ((80, 90), "db38", F64, None, None, True),  # 2D, 76 taps
]


def _dec_outputs(rng, nb, shape, dtype):
    """A band array of 2 levels' worth of bands, filled, and its approx."""
    big = _randn(rng, (2 * nb - 1,) + shape, dtype)
    return big, _randn(rng, shape, dtype)


@pytest.mark.parametrize("shape,wv,dtype,padded,plan,split", DEC_CASES)
def test_dec_schedule_matches_plain(monkeypatch, shape, wv, dtype, padded, plan, split):
    """The replay of ``nddwt_dec_level``'s schedule against
    ``dec_level_ref``: every band of ``big`` (written at offset ``nb``, the
    rest untouched) and the approximation, lam 0 and 0.1, ``final`` both
    ways."""
    if plan is not None:
        monkeypatch.setattr(ck, "_stream_plan", lambda *args: plan)
    rng = np.random.default_rng(len(shape) * 100 + shape[0] + 1)
    taps = tw.NDDWT(wv, shape, device="cpu").taps_hp
    x = _randn(rng, _padded_in(shape, taps, padded), dtype)
    nb = 2 ** len(shape)
    n, k, left, bit, pad, arr = ck._level_stream_view(shape, taps, dtype, padded, False)
    t = ck._stream_plan(n, k, dtype, "dec")
    gw = ck._walk_bands(k, t, dtype)
    assert (gw < ck._ana_bands(k)) == split
    view = tuple(m + (K - 1 if p else 0) for m, K, p in zip(n, k, pad))
    for lam, final in ((0.0, False), (0.1, True)):
        big, approx = _dec_outputs(rng, nb, shape, dtype)
        want_big, want_approx = big.clone(), approx.clone()
        got_approx = big[0] if final else approx
        stream_ref.stream_ana_replay(
            x.reshape((1,) + view), big.view((-1,) + tuple(n)), got_approx.view(n), nb,
            n, k, t, gw, left, bit, pad, arr, 1, lam, ck._ana_items(k, dtype))
        ref = level_ref.dec_level_ref(x, want_big, nb, taps, lam, final, padded)
        _close(big, want_big, dtype)
        if not final:
            _close(approx, ref, dtype)


LEAD_DEC_CASES = [
    ((8, 12, 8, 9), "db4", F32, None, None, False),  # X of extent K
    ((8, 12, 8, 9), "db4", BF16, None, None, False),
    ((13, 11, 4, 5), "db2", F32, None, (4, 32, 32), False),
    ((9, 10, 4, 4), "db2", F64, None, (1, 64, 16), False),  # a chunk of one plane
    ((9, 10, 4, 6), "db2", F32, (True, False), None, False),  # padded X (streamed)
    ((9, 10, 6, 7), "db3", F64, (False, True), None, False),  # padded Y
    ((40, 41, 45), "db20", F32, None, None, False),  # the 3D long-filter route
    ((40, 41, 45), "db20", F64, None, (40, 4, 64), True),  # a plan whose ring must split
]


@pytest.mark.parametrize("shape,wv,dtype,padded,plan,split", LEAD_DEC_CASES)
def test_lead_dec_schedule_matches_plain(monkeypatch, shape, wv, dtype, padded, plan, split):
    """The replay of ``nddwt_lead_dec``'s schedule against ``lead_dec_ref``
    on the (X, Y, Z*T) view, every lane group: the bands at offset ``4 nl``
    and the approximation, lam 0 and 0.1, ``final`` both ways."""
    if plan is not None:
        monkeypatch.setattr(ck, "_stream_plan", lambda *args: plan)
    rng = np.random.default_rng(shape[0] * 7 + len(shape) + 1)
    taps = tw.NDDWT(wv, shape, device="cpu").taps_hp
    pad2 = padded or (False, False)
    in_shape = _padded_in(shape, taps, pad2 + (False,) * (len(shape) - 2))
    nl = 2 ** (len(shape) - 2)
    temp = _randn(rng, (nl,) + in_shape, dtype)
    n, k, t, left, arr = (list(v) if not isinstance(v, np.ndarray) else v
                          for v in ck._stage_geometry(shape, taps, False, False, dtype, pad2)[0])
    gw = ck._walk_bands(k, t, dtype)
    assert (gw < ck._ana_bands(k)) == split
    view = (nl, in_shape[0], in_shape[1], int(np.prod(in_shape[2:])))
    for lam, final in ((0.0, False), (0.1, True)):
        big, approx = _dec_outputs(rng, 4 * nl, shape, dtype)
        want_big, want_approx = big.clone(), approx.clone()
        got_approx = big[0] if final else approx
        stream_ref.stream_ana_replay(
            temp.reshape(view), big.view((-1,) + tuple(n)), got_approx.view(n), 4 * nl,
            n, k, t, gw, left, [0, 1, 0], list(pad2) + [False], arr, nl, lam,
            ck._ana_items(k, dtype))
        ref = level4_ref.lead_dec_ref(temp, want_big, 4 * nl, taps, lam, final, pad2)
        _close(big, want_big, dtype)
        if not final:
            _close(approx, ref, dtype)


def _views():
    """(kind, view extents, taps per slot) of the launches the routes send
    to the streamed bodies, over every filter length they take; the 3D
    analysis kinds are cut, in the test, to the lengths outside the stage
    route (``stage_route``)."""
    for K in range(2, 77, 2):
        yield "2D", [max(K, 9), 1, max(K, 300)], [K, 1, K]
        yield "lead", [max(K, 12), max(K, 20), 200], [K, K, 1]
        yield "dec 2D", [max(K, 9), 1, max(K, 300)], [K, 1, K]
        yield "lead_dec", [max(K, 12), max(K, 20), 200], [K, K, 1]
        yield "dec 3D", [max(K, 40)] * 3, [K, K, K]
        yield "dec 3D mixed", [max(K, 40)] * 3, [K, 4, 6]
        if K <= 30:  # longer 3D filters take the stage kernels
            yield "3D", [max(K, 40)] * 3, [K, K, K]
            yield "3D mixed", [max(K, 40)] * 3, [K, 4, 6]


# The analysis's plane elements a thread where the taps are unrolled, at K =
# 2, 4, 6, 8: a ring of K x G x items words in 64 registers (G = 4 in 3D, 2
# in 2D and the lead stage; a float64 word takes two).
ANA_ITEMS = {(4, 4): (4, 4, 2, 2), (4, 8): (4, 2, 1, 1), (2, 4): (4, 4, 4, 4),
             (2, 8): (4, 4, 2, 2)}


@pytest.mark.parametrize("dtype", [F32, BF16, F64])
def test_stream_plan_fits_and_covers(dtype):
    """Every plan: the launch constraints ``launch_stream`` and
    ``launch_stream_ana`` check, shared memory within the budget, and chunks
    and plane tiles that cover each output plane and column once; for the
    synthesis 4 elements a thread exactly where the source unrolls the taps,
    for the analysis the elements of ``ANA_ITEMS`` there and the most
    in-plane bands a walk that fit (all of them where the taps unroll)."""
    word = 8 if dtype == F64 else 4
    for kind, n, k in _views():
        ana = kind.startswith("dec") or kind == "lead_dec"
        if kind.startswith("dec 3D") and ck.stage_route(n, [np.zeros((2, K)) for K in k], dtype):
            continue  # the stage kernels take such levels
        plan_kind = {"lead": "lead", "lead_dec": "lead_dec"}.get(kind, "dec" if ana else "rec")
        C, T1, T2 = ck._stream_plan(n, k, dtype, plan_kind)
        unrolled = k[0] in (2, 4, 6, 8) and "mixed" not in kind
        if ana:
            G = ck._ana_bands(k)
            assert G == (4 if "3D" in kind else 2)
            items = ck._ana_items(k, dtype)
            assert items == (ANA_ITEMS[G, word][k[0] // 2 - 1] if unrolled else 1), (kind, k)
            gw = ck._walk_bands(k, (C, T1, T2), dtype)
            assert G % gw == 0 and (gw == G or not unrolled), (kind, k)
            assert ck._stream_smem(k, (C, T1, T2), dtype, bands=gw) <= ck._STREAM_SMEM_BUDGET
            if gw < G:  # twice the bands would not fit
                assert (ck._stream_smem(k, (C, T1, T2), dtype, 2, 2 * gw)
                        > ck._STREAM_SMEM_BUDGET)
        else:
            items = ck._stream_items(k)
            assert items == (4 if unrolled else 1)
            assert ck._stream_smem(k, (C, T1, T2), dtype) <= ck._STREAM_SMEM_BUDGET
        assert T2 & (T2 - 1) == 0 and T1 * T2 == 256 * items, (kind, k)
        assert min(n[0], k[0]) <= C <= n[0]
        for extent, step in ((n[0], C), (n[1], T1), (n[2], T2)):
            starts = range(0, extent, step)
            cover = [p for s in starts for p in range(s, min(s + step, extent))]
            assert cover == list(range(extent))
        grid = (-(-n[2] // T2), -(-n[1] // T1), -(-n[0] // C))
        assert max(grid[1:]) <= 65535


def test_stream_smem_is_the_sources_layout():
    """``_stream_smem`` at a few plans, worked by hand from
    ``stream_layout``: the rows' offsets, rows of whole 16-byte pieces, four
    window buffers where they fit (fewer where not), the intermediate (for
    the analysis one slice per two in-plane bands a walk keeps), the ring
    where the taps run at runtime (for the analysis one per band a walk
    keeps)."""
    # 256^3 db4 f32, (C, 8, 128): 15 offsets (128 B), rows 15 x 140 floats, Q 15 x 128
    assert ck._stream_smem([8, 8, 8], (64, 8, 128), F32) == 128 + 4 * 15 * 140 * 4 + 15 * 128 * 4
    # the same in f64: rows 15 x 136 doubles
    assert ck._stream_smem([8, 8, 8], (64, 8, 128), F64) == 128 + 4 * 15 * 136 * 8 + 15 * 128 * 8
    # 2D (db2, db6), runtime taps: one row of 256 + 11 (+ 3) floats, ring 4 x 256
    assert ck._stream_smem([4, 1, 12], (4, 1, 256), F32) == 16 + 4 * 272 * 4 + 4 * 256 * 4
    # the lead adjoint, bf16: 23 rows of 64 (+ 7 -> 72) halves, no Q
    assert ck._stream_smem([8, 8, 1], (64, 16, 64), BF16) == 192 + 4 * 23 * 72 * 2
    # 2D db38 f64, runtime taps: the 76-plane ring leaves room for 4 windows
    # of 256 + 75 (+ 1) doubles; at 16 x 16 the lead adjoint's 91 rows of
    # 16 (+ 1 -> 18) fit three times beside its ring
    assert ck._stream_smem([76, 1, 76], (76, 1, 256), F64) == 16 + 4 * 332 * 8 + 76 * 256 * 8
    assert ck._stream_smem([76, 76, 1], (76, 16, 16), F64) == (
        736 + 3 * 91 * 18 * 8 + 76 * 256 * 8)
    assert ck._stream_smem([76, 76, 1], (76, 16, 16), F64, 4) > ck._STREAM_SMEM_BUDGET
    # The analysis. 256^3 db4 f32, (128, 4, 128), 4 bands: 11 offsets (96 B),
    # rows 11 x 140 floats, Q in two slices of 11 x 128, the ring in registers
    assert ck._stream_smem([8, 8, 8], (128, 4, 128), F32, bands=4) == (
        96 + 4 * 11 * 140 * 4 + 2 * 11 * 128 * 4)
    # f64, (256, 2, 128): 9 offsets (80 B), rows 9 x 136 doubles, Q 2 x 9 x 128
    assert ck._stream_smem([8, 8, 8], (256, 2, 128), F64, bands=4) == (
        80 + 4 * 9 * 136 * 8 + 2 * 9 * 128 * 8)
    # 3D db11 f64, (22, 4, 64): 25 rows of 64 + 21 (-> 86) doubles; two bands
    # a walk keep one Q slice and a ring of 22 x 2 x 256; all four do not fit
    assert ck._stream_smem([22, 22, 22], (22, 4, 64), F64, bands=2) == (
        208 + 4 * 25 * 86 * 8 + 25 * 64 * 8 + 22 * 2 * 256 * 8)
    assert ck._stream_smem([22, 22, 22], (22, 4, 64), F64, 2, 4) > ck._STREAM_SMEM_BUDGET
    # 2D db38 f64: one band a walk is the synthesis's layout; two do not fit
    assert ck._stream_smem([76, 1, 76], (76, 1, 256), F64, bands=1) == 16 + 4 * 332 * 8 + 76 * 256 * 8
    assert ck._stream_smem([76, 1, 76], (76, 1, 256), F64, 2, 2) > ck._STREAM_SMEM_BUDGET
    # the lead analysis f32, (128, 16, 64): 23 rows of 64 (+ 3 -> 68) floats, no Q
    assert ck._stream_smem([8, 8, 1], (128, 16, 64), F32, bands=2) == 192 + 4 * 23 * 68 * 4


# (shape, wavelet): (stage_route, the multilevel route at L3) in f32, bf16, f64,
# as the routes answered before the streamed synthesis existed.
ROUTES = [
    ((256, 256, 256), "db4", [(False, False)] * 3),
    ((48, 44, 46), "db14", [(False, True), (False, True), (True, False)]),
    ((48, 44, 46), "db15", [(True, False)] * 3),
    ((64, 64, 64), "db12", [(False, True), (False, True), (True, False)]),
    ((64, 64, 64), "db11", [(False, True)] * 3),
    ((40, 41, 45), "db20", [(True, False)] * 3),
    ((48, 44, 46), ("db15", "db15", "db2"), [(False, True)] * 3),
    ((128, 128, 128, 32), "db4", [(True, False)] * 3),
    ((256, 256), "db4", [(False, True)] * 3),
    ((9, 300), ("db2", "db6"), [(False, True)] * 3),
    ((2048, 2048), "db10", [(False, True)] * 3),
    ((128, 128, 128), "db4", [(False, True)] * 3),
    ((64, 64, 64), "db10", [(False, True)] * 3),
    ((37, 41, 45), "db4", [(False, True)] * 3),
    ((80, 90), "db38", [(False, True)] * 3),
    ((24, 40, 72), "db1", [(False, True)] * 3),
]


@pytest.mark.parametrize("shape,wv,want", ROUTES)
def test_routes_are_pinned(monkeypatch, shape, wv, want):
    """``stage_route`` and, beyond the flat kernel's size, whether
    ``NDDWT.route`` takes the multilevel kernels, at L3 and L1."""
    monkeypatch.setattr(flat, "FLAT_MAX_NUMEL", {None: 0})
    plan = tw.NDDWT(wv, shape, device="cpu")
    got = [(ck.stage_route(shape, plan.taps_hp, dt),
            plan.route(dt, 3, on_card=True) == "multi") for dt in (F32, BF16, F64)]
    assert got == want
    assert not any(plan.route(dt, 1, on_card=True) == "multi" for dt in (F32, BF16, F64))
