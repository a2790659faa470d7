"""The streamed synthesis (``csrc/nddwt_stream.cuh``, the body of
``nddwt_rec_level`` and ``nddwt_lead_adj``) on the CPU.

* Its schedule replayed (``ops/stream_ref.py``) on the geometry the wrappers
  build (``cuda_kernels.rec_stream_args``, ``cuda_kernels._stage_geometry``)
  against the plain versions ``level_ref.rec_level_ref`` and
  ``level4_ref.lead_adj_ref``, which the older tests hold against the JAX
  package's kernels in interpret mode: filters of 2 to 76 taps, an axis of
  exactly K, extents that are no multiple of the plane tile or the chunk, a
  chunk of one plane, the halo-padded mode on the streamed axis and on a
  fast one, 2D, and the 3D long-filter route of the lead stage. Tolerance
  relative to max|plain|: float32 1e-5, float64 1e-12, bfloat16 1e-2.
* The plan: shared memory within the budget for every filter length and
  dtype, the launch constraints the kernel checks, and chunks and plane
  tiles that cover every output once.
* ``stage_route`` and ``multi.multi_supported`` pinned to their answers on
  a table of shapes, wavelets and dtypes: the new plan moves no route.
"""

import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import level4_ref, level_ref, multi, stream_ref

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
    """The replay of ``nddwt_rec_level``'s schedule against
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
        out_shape, idx, (n, k, t, left, bit, pad, arr) = ck.rec_stream_args(
            y, approx, src, taps, padded)
        assert out_shape == shape
        view = (-1,) + tuple(m + (K - 1 if p else 0) for m, K, p in zip(n, k, pad))
        got = stream_ref.stream_replay(
            y.reshape(view), approx.reshape(view[1:]), idx + [-1] * (16 - nb), n, k, t,
            left, bit, pad, arr,
            1, 0.125, ck._stream_items(k))
        want = level_ref.rec_level_ref(y, approx, src, taps, 0.125, padded)
        _close(got.reshape(shape), want, dtype)


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
                          for v in ck._stage_geometry(shape, taps, False, True, dtype, pad2))
    idx = [-1] + [nb + b - 1 for b in range(1, nb)]
    pad = list(pad2) + [False]
    view = (-1, in_shape[0], in_shape[1], int(np.prod(in_shape[2:])))
    nl = nb // 4
    got = stream_ref.stream_replay(
        y.reshape(view), approx.reshape(view[1:]), idx + [-1] * (16 - nb), n, k, t, left,
        [0, 1, 0], pad, arr, nl, 1.0, ck._stream_items(k))
    want = level4_ref.lead_adj_ref(y, approx, src, taps, pad2)
    _close(got.reshape(want.shape), want, dtype)


def _views():
    """(kind, view extents, taps per slot) of the launches the route sends
    to the streamed synthesis, over every filter length it takes."""
    for K in range(2, 77, 2):
        yield "2D", [max(K, 9), 1, max(K, 300)], [K, 1, K]
        yield "lead", [max(K, 12), max(K, 20), 200], [K, K, 1]
        if K <= 30:  # longer 3D filters take the stage kernels
            yield "3D", [max(K, 40)] * 3, [K, K, K]
            yield "3D mixed", [max(K, 40)] * 3, [K, 4, 6]


@pytest.mark.parametrize("dtype", [F32, BF16, F64])
def test_stream_plan_fits_and_covers(dtype):
    """Every plan: the launch constraints ``launch_stream`` checks, shared
    memory within the budget, and chunks and plane tiles that cover each
    output plane and column once; 4 elements a thread exactly where the
    source unrolls the taps."""
    for kind, n, k in _views():
        C, T1, T2 = ck._stream_plan(n, k, dtype, "lead" if kind == "lead" else "rec")
        items = ck._stream_items(k)
        assert items == (4 if k[0] in (2, 4, 6, 8) and kind != "3D mixed" else 1)
        assert T2 & (T2 - 1) == 0 and T1 * T2 == 256 * items, (kind, k)
        assert ck._stream_smem(k, (C, T1, T2), dtype) <= ck._STREAM_SMEM_BUDGET
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
    window buffers where they fit (fewer where not), the intermediate, the
    ring where the taps run at runtime."""
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


# (shape, wavelet): (stage_route, multi_supported at L3) in f32, bf16, f64,
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
def test_routes_are_pinned(shape, wv, want):
    taps = tw.NDDWT(wv, shape, device="cpu").taps_hp
    got = [(ck.stage_route(shape, taps, dt), multi.multi_supported(shape, taps, dt, 3))
           for dt in (F32, BF16, F64)]
    assert got == want
    assert not any(multi.multi_supported(shape, taps, dt, 1) for dt in (F32, BF16, F64))
