"""The lane body (``csrc/nddwt_lane.cuh``: ``nddwt_lane_dec`` and
``nddwt_lane_adj``) on the CPU.

* Its schedule replayed (``stream_ref.lane_replay``) on the geometry the
  wrappers build (``cuda_kernels._stage_geometry``, ``_lane_plan``) or a
  forced plan, against the plain versions ``level4_ref.lane_dec_ref`` and
  ``level4_ref.lane_adj_ref``, which ``tests/test_torch_4d.py`` holds
  against the JAX package's ``_lane_dec_call``/``_lane_adj_call`` in
  interpret mode: units of whole slabs and chunks of Z that end ragged, a
  chunk split at the periodic wrap, inputs at an address that is no
  multiple of 16 bytes with odd Z·T (ragged head and tail pieces) in
  float32, bfloat16 and float64, Z = K, T = 1 (the 3D long-filter route),
  T > 128 and T > 256, K = 76, mixed filters, one unit buffer, and grids
  of fewer CTAs than units and more. Tolerance relative to max|plain|:
  float32 1e-5, float64 1e-12, bfloat16 1e-2.
* The plan: shared memory within its budget, the launch constraints the
  source checks, units that cover every output once, the order of
  preference, and the class left on the tile body pinned (db38 in
  float64 beyond it raises).
"""

import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import level4_ref, stream_ref

torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-2}
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
MIXED = ("db1", "db2", "db3", "db2")


def _taps(wv, ndim):
    """The plan's float64 taps (one (2, K) array per axis), from a shape
    every filter fits."""
    return tw.NDDWT(wv, (80,) * ndim, device="cpu").taps_hp


def _close(got, want, dtype):
    want = want.double()
    err = (got.double() - want).abs().max().item()
    assert err <= TOL[dtype] * want.abs().max().item(), err


# (shape, wavelet, dtype, the input's byte address mod 16, plan override
# (R, Zc, stages), CTAs)
LANE_CASES = [
    ((5, 3, 11, 9), "db2", F32, 4, (4, 11, 2), 3),  # 15 slabs in units of 4, odd Z*T
    ((5, 3, 11, 9), "db2", BF16, 2, (4, 11, 3), 264),  # bf16 at an odd element offset
    ((5, 3, 11, 9), "db2", F64, 8, None, 264),
    ((3, 2, 13, 7), "db2", F32, 0, (1, 4, 2), 2),  # chunks 4, 4, 4, 1; the first wraps
    ((3, 2, 13, 7), "db3", BF16, 6, (1, 5, 1), 5),  # one buffer
    ((3, 2, 13, 7), "db2", F64, 8, (1, 3, 4), 1),
    ((4, 3, 8, 9), "db4", F32, 12, None, 264),  # Z = K
    ((4, 3, 8, 9), "db4", F64, 8, (1, 1, 2), 4),  # Z = K, chunks of one row
    ((6, 5, 44), "db20", F32, 4, None, 264),  # T = 1: the 3D long-filter route
    ((6, 5, 44), "db20", BF16, 2, (1, 5, 3), 7),
    ((6, 5, 44), "db20", F64, 0, (4, 44, 2), 3),
    ((2, 3, 4, 136), "db2", F32, 0, None, 264),  # T > 128
    ((2, 2, 4, 300), "db2", BF16, 14, None, 3),  # T > 256: two column passes
    ((3, 2, 76, 77), "db38", F32, 12, None, 264),  # K = 76
    ((2, 2, 76, 76), "db38", F64, 8, (1, 1, 1), 2),
    ((8, 16, 8, 16), MIXED, F32, 0, None, 264),  # K = 6 on Z, 4 on T: runtime taps
    ((8, 8, 12, 9), "db2", F32, 0, None, 2),  # many more units than CTAs
    ((64, 64, 20, 10), "db2", BF16, 0, None, 264),  # the reference's 4D volume
]


@pytest.mark.parametrize("adj", [False, True])
@pytest.mark.parametrize("shape,wv,dtype,shift,plan,ctas", LANE_CASES)
def test_lane_schedule_matches_plain(shape, wv, dtype, shift, plan, ctas, adj):
    taps = _taps(wv, len(shape))
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    geometry, body = ck._stage_geometry(shape, taps, True, adj, dtype)
    n, k, t, left, arr = (tuple(v) if i < 4 else v for i, v in enumerate(geometry))
    assert body == "lane"  # not the tile body
    t = plan or t
    nl = 2 ** (len(shape) - 2)
    if adj:
        src = level4_ref.lane_dec_ref(x, taps)
        want = level4_ref.lane_adj_ref(src, taps, 0.25)
        got = stream_ref.lane_replay(src.reshape((nl,) + n), n, k, t, left, arr,
                                     True, 0.25, ctas, shift)
    else:
        want = level4_ref.lane_dec_ref(x, taps)
        got = stream_ref.lane_replay(x.reshape(n), n, k, t, left, arr, False, 1.0, ctas,
                                     shift)
    assert got.dtype == dtype
    _close(got.reshape(want.shape), want, dtype)


def test_lane_replay_sees_a_missed_piece(monkeypatch):
    """The replay's windows hold nothing but what the copies put there: a
    plan whose chunk window misses the second piece of a wrapped chunk
    reads NaN, not stale data."""
    shape = (3, 2, 13, 7)
    taps = _taps("db2", 4)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape)).float()
    n, k, t, left, arr = (tuple(v) if i < 4 else v for i, v in
                          enumerate(ck._stage_geometry(shape, taps, True, False)[0]))
    real = stream_ref._lane_bulk

    def drop_second_piece(a, m, size, tlo, thi):
        lo, hi, e_lo, e_hi = real(a, m, size, tlo, thi)
        return (lo, lo, 0, m) if (a - tlo) // size % (13 * 7) == 0 else (lo, hi, e_lo, e_hi)

    monkeypatch.setattr(stream_ref, "_lane_bulk", drop_second_piece)
    got = stream_ref.lane_replay(x.reshape(n), n, k, (1, 4, 2), left, arr, False)
    assert torch.isnan(got).any()


# Lane views (n0, Z, T) and taps (1, K1, K2) the plan must serve: the 4D
# workload, the reference's 4D volume, odd extents, T > 128 and 256, Z = K,
# the 3D long-filter routes (T = 1), K = 76, mixed filters.
VIEWS = [((16384, 128, 32), (1, 8, 8)), ((4096, 20, 10), (1, 4, 4)),
         ((15, 11, 9), (1, 4, 4)), ((24, 4, 136), (1, 4, 4)), ((6, 8, 300), (1, 4, 4)),
         ((12, 8, 9), (1, 8, 8)), ((16384, 128, 1), (1, 40, 1)), ((6080, 84, 1), (1, 76, 1)),
         ((5852, 76, 76), (1, 76, 76)), ((128, 8, 16), (1, 6, 4)), ((30, 44, 1), (1, 40, 1)),
         ((100, 200, 200), (1, 8, 8)), ((256, 1024, 8), (1, 4, 4))]


def _covers(n, plan):
    """Each (slab, z) output once over the units of ``plan``."""
    n0, Z, _ = n
    R, Zc, _ = plan
    seen = np.zeros((n0, Z), int)
    if Zc >= Z:
        for u in range(-(-n0 // R)):
            seen[u * R:min(n0, u * R + R)] += 1
    else:
        for s in range(n0):
            for z0 in range(0, Z, Zc):
                seen[s, z0:min(Z, z0 + Zc)] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("adj", [False, True])
@pytest.mark.parametrize("dtype", [F32, BF16, F64])
def test_lane_plan_fits_and_covers(dtype, adj):
    """Every view's plan: the launch constraints ``launch_lane`` checks
    (1 to 4 buffers, a window of at most Z rows, shared memory within the
    stream budget), units that cover every output once, a chunk window of
    fewer rows than Z wherever a buffer is in flight, and the two-CTA
    budget wherever a plan of whole slabs with two buffers fits it."""
    for n, k in VIEWS:
        plan = ck._lane_plan(n, k, dtype, adj)
        assert plan is not None, (n, k)
        R, Zc, stages = plan
        assert 1 <= stages <= ck._LANE_MAX_STAGES and R >= 1 and Zc >= 1
        smem = ck._lane_smem(n, k, plan, dtype, adj)
        assert smem <= ck._STREAM_SMEM_BUDGET
        if Zc < n[1]:
            assert R == 1 and Zc + k[1] - 1 <= n[1]
            assert Zc + k[1] - 1 < n[1] or stages == 1
        assert _covers((min(n[0], 40),) + n[1:], plan)
        if ck._lane_smem(n, k, (1, n[1], 2), dtype, adj) <= ck._LANE_TWO_PER_SM:
            assert Zc >= n[1] and smem <= ck._LANE_TWO_PER_SM


def test_lane_plan_prefers():
    """The plans at the workloads: the 4D analysis in whole slabs with four
    buffers, two CTAs an SM; the 4D adjoint (4 lane bands a unit) in whole
    slabs with one buffer in float32 (two in bfloat16), in chunks of Z in
    float64; the 3D db20 route in units of 21 slabs (3 units on the busiest
    CTA of one wave: 63 slabs, the fewest); one buffer where no two fit."""
    assert ck._lane_plan((16384, 128, 32), (1, 8, 8), F32, False) == (1, 128, 4)
    assert ck._lane_plan((16384, 128, 32), (1, 8, 8), F32, True) == (1, 128, 1)
    assert ck._lane_plan((16384, 128, 32), (1, 8, 8), BF16, True) == (1, 128, 2)
    assert ck._lane_plan((16384, 128, 32), (1, 8, 8), F64, False) == (1, 128, 1)
    assert ck._lane_plan((16384, 128, 32), (1, 8, 8), F64, True) == (1, 64, 1)
    assert ck._lane_plan((16384, 128, 1), (1, 40, 1), F32, False) == (21, 128, 4)
    assert ck._lane_plan((16384, 128, 1), (1, 40, 1), F32, True) == (21, 128, 4)
    assert ck._lane_plan((16384, 128, 1), (1, 40, 1), F64, True) == (9, 128, 4)
    assert ck._lane_plan((5852, 76, 76), (1, 76, 76), F32, True) == (1, 76, 1)
    assert ck._lane_plan((5852, 76, 76), (1, 76, 76), F64, True) == (1, 1, 1)


def test_lane_smem_is_the_sources_layout():
    """``_lane_smem`` worked by hand from ``lane_smem``: per buffer one
    window per input array of R x Ew x T elements rounded to 16 bytes plus
    three 16-byte pieces of slack, then two halves of Q in the compute
    type."""
    # the 4D analysis f32, (1, 128, 4): 4 x (4096 + 12) floats, Q 2 x 4096
    assert ck._lane_smem((16384, 128, 32), (1, 8, 8), (1, 128, 4)) == (
        4 * 4108 * 4 + 2 * 4096 * 4)
    # the adjoint in chunks of 64: 71 window rows of 4 bands, Q 2 x 64 x 32
    assert ck._lane_smem((16384, 128, 32), (1, 8, 8), (1, 64, 2), F32, True) == (
        2 * 4 * (71 * 32 + 12) * 4 + 2 * 64 * 32 * 4)
    # bf16 storage, f32 Q: 3 slabs of 20 x 10 (600, + 24 slack) halves
    assert ck._lane_smem((4096, 20, 10), (1, 4, 4), (3, 20, 4), BF16) == (
        4 * 624 * 2 + 2 * 3 * 20 * 10 * 4)
    # the 3D route: no Q; the adjoint copies 2 lane bands; f64 slack 3 x 2
    assert ck._lane_smem((16384, 128, 1), (1, 40, 1), (15, 128, 3), F64, True) == (
        3 * 2 * (1920 + 6) * 8)
    # a chunk plan is one slab a unit whatever its R
    assert ck._lane_smem((99, 13, 7), (1, 4, 4), (5, 4, 2)) == ck._lane_smem(
        (99, 13, 7), (1, 4, 4), (1, 4, 2))


@pytest.mark.parametrize("shape,wv,dtype,want", [
    ((16, 16, 8, 2048), "db4", F32, ("lane", "tile")),  # 4 bands x 8 rows of 2048
    ((16, 16, 8, 1504), "db4", F32, ("lane", "lane")),
    ((16, 16, 8, 1505), "db4", F32, ("lane", "tile")),
    ((8, 8, 8, 1100), "db4", F64, ("tile", "tile")),
    ((4, 4, 76, 83), "db38", F64, ("lane", "lane")),
    ((4, 4, 76, 84), "db38", F64, ("lane", "none")),
    ((128, 128, 128, 32), "db4", F64, ("lane", "lane")),
    ((77, 76, 76, 76), "db38", F64, ("lane", "lane")),
    ((128, 128, 128), "db20", BF16, ("lane", "lane")),
])
def test_lane_route_pins_the_tile_class(shape, wv, dtype, want):
    """The class left on the tile body: a lane stage where even one Z row
    chunk (K1 rows of the whole T row of every input array, one buffer)
    overflows the stream budget, so that ``_lane_plan`` finds no plan. Its
    geometry names the tile body and carries its tile, inside that body's
    32 KB; where no tile fits 32 KB either (db38 in float64), the geometry
    raises ("none")."""
    taps = _taps(wv, len(shape))
    n, slot_taps = ck._stage_slots(shape, taps, True)
    k = tuple(1 if t is None else int(np.shape(t)[1]) for t in slot_taps)
    word = 8 if dtype == F64 else 4
    got = []
    for adj in (False, True):
        if ck._lane_plan(tuple(n), k, dtype, adj) is not None:
            got.append("lane")
        else:
            got.append("tile" if ck._stage_tiles(tuple(n), k, adj, word) else "none")
    assert tuple(got) == want
    for adj, route in zip((False, True), got):
        if route == "none":
            with pytest.raises(NotImplementedError, match="neither the lane body"):
                ck._stage_geometry(shape, taps, True, adj, dtype)
            continue
        (n, k, t, left, arr), body = ck._stage_geometry(shape, taps, True, adj, dtype)
        assert body == route
        if route == "lane":
            assert tuple(t) == ck._lane_plan(tuple(n), tuple(k), dtype, adj)
        else:
            tile = tuple(t)
            assert min(tile) >= 1 and all(a <= b for a, b in zip(tile, n))
            assert word * ck._stage_words(tile, list(k), adj) <= ck._LANE_SMEM_BUDGET
