"""The multilevel kernels' persistent schedule, replayed on the CPU.

``nddwt_dec_multi`` and ``nddwt_rec_multi`` (``csrc/nddwt_multi.cu``) run
the per-level kernels' streamed bodies for every level and item of a batch
in one launch: a persistent grid claims the units of each level, a unit
being one CTA tile of the per-level launch of one item, a 2D batch of
narrow rows folded into the view's pass-through slot ``(n0, N, n1)``.
``ops/stream_ref.multi_replay`` replays that schedule CTA by CTA on the
geometry ``multi._multi_geometry`` builds (unit order, the fold's item
strides, the ping slots, each level's band table; every output written
once a level). Here it is held against the kernels' plain versions
(``ops/multi_ref.py``) and against the JAX package's one-launch multilevel
kernels ``_fused_dec_multi``/``_fused_rec_multi`` in TPU interpret mode.

Also: ``multi_supported``'s boundary (an extent equal to the filter, one
shorter, the stage route's filters) and ``stage_route``'s answers
over a grid of 3D shapes and filters, pinned to what they were before the
multilevel kernels streamed.

Tolerances: float32 1e-5 (bands) and 1e-4 (reconstructions), the JAX
tests' own (``tests/test_pallas.py:66-70``), float64 1e-12, each times the
largest magnitude of the reference where that exceeds 1.
"""

import types

import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import multi, multi_ref, stream_ref

torch.set_num_threads(1)

F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64
LAM = 0.1

# (shape, wavelet, level, batch, dtype): 2D and 3D, odd extents, an extent
# equal to K (db4 on 8, db5 on 10), batches of 1, 3 and 5, L2-L5, db1, db2,
# db4, K = 10 (db5: runtime tap loops) and mixed wavelets per axis (runtime
# loops too: the halo slots do not share one K).
CASES = [
    ((20, 24), "db2", 3, 3, F32),
    ((37, 29), ("db2", "db3"), 4, 5, F64),
    ((8, 30), "db4", 2, 1, F32),
    ((21, 40), "db5", 5, 3, F64),
    ((33, 17), "db1", 5, 5, F32),
    ((13, 11, 9), "db2", 3, 3, F64),
    ((9, 8, 10), "db4", 2, 1, F32),
    ((16, 12, 10), ("db1", "db3", "db2"), 4, 5, F32),
    ((10, 12, 11), "db5", 2, 3, F64),
    ((12, 9, 14), "db1", 5, 1, F32),
]
TOL = {F32: (1e-5, 1e-4), F64: (1e-12, 1e-12)}


def _close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = max(1.0, want.double().abs().max().item())
    assert (got.double() - want.double()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("pl2", [False, True], ids=["scaled", "l2"])
@pytest.mark.parametrize("shape,wv,level,batch,dtype", CASES)
def test_multi_replay_matches_plain_versions(shape, wv, level, batch, dtype, pl2):
    """The analysis (lam 0 and 0.1) and the synthesis of those bands (scale
    1 with ``preserve_l2``, else ``1/2^d``) as the kernels schedule them
    equal the plain versions."""
    taps = tw.NDDWT(wv, shape, preserve_l2=pl2, device="cpu").taps_hp
    rng = np.random.default_rng(len(shape) * 100 + level * 10 + batch)
    x = torch.from_numpy(rng.standard_normal((batch,) + shape)).to(dtype)
    tol_dec, tol_rec = TOL[dtype]
    for lam in (0.0, LAM):
        want = multi_ref.dec_multi_ref(x, taps, level, lam)
        _close(stream_ref.multi_replay("dec", x, taps, level, lam), want, tol_dec)
    scale = 1.0 if pl2 else 0.5 ** len(shape)
    _close(stream_ref.multi_replay("rec", want, taps, level, scale),
           multi_ref.rec_multi_ref(want, taps, level, scale), tol_rec)


@pytest.mark.parametrize("shape,batch,view,tile", [((9, 200), 6, [9, 6, 200], (4, 256)),
                                                   ((5, 1100), 3, [5, 1, 1100], (1, 1024))])
def test_multi_replay_batch_views(shape, batch, view, tile):
    """A 2D batch whose rows are narrower than the plane tile is folded into
    the view's pass-through slot, four items' rows a tile (the last tile
    ragged); one whose rows fill the tile is not (an item's units, two
    column tiles a row). More units than the grid (each CTA runs several a
    level): the plan, and the replay on it."""
    level = 3
    taps = tw.NDDWT("db2", shape, device="cpu").taps_hp
    for rec in (False, True):
        n, k, t, *_ = multi._multi_geometry(shape, taps, rec, F32, batch)
        assert n == view and k == [4, 1, 4] and tuple(t[1:]) == tile
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((batch,) + shape)).float()
    want = multi_ref.dec_multi_ref(x, taps, level, LAM)
    _close(stream_ref.multi_replay("dec", x, taps, level, LAM, ctas=5), want, 1e-5)
    _close(stream_ref.multi_replay("rec", want, taps, level, 0.25, ctas=5),
           multi_ref.rec_multi_ref(want, taps, level, 0.25), 1e-4)


def test_multi_plan_fills_one_wave():
    """The chunk is sized over the whole batch's units: a 3D batch of 8
    (256, 128, 128) items and the 16-item 256^2 batch take one wave of 264
    units or less, each chunk at least K planes."""
    for shape, batch in (((256, 128, 128), 8), ((256, 256), 16), ((128, 128, 128), 2)):
        taps = tw.NDDWT("db4", shape, device="cpu").taps_hp
        for rec in (False, True):
            n, k, (C, T1, T2), *_ = multi._multi_geometry(shape, taps, rec, F32, batch)
            units = -(-n[0] // C) * -(-n[1] // T1) * -(-n[2] // T2)
            units *= 1 if len(shape) == 2 else batch
            assert units <= 2 * 132 and C >= 8, (shape, rec, C, units)
            if len(shape) == 2:
                assert (T1, T2) == (4, 256)  # four items' rows of 256 a tile


@pytest.fixture(scope="module")
def jax_multi():
    """The JAX one-launch multilevel kernels in interpret mode at one 2D and
    one 3D case of ``tests/test_pallas.py``'s ``MULTI_CASES``: the input,
    the taps, the analysis with the shrink and the synthesis of the direct
    path's bands with ``preserve_l2``."""
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    import non_decimated_wavelets_tpu as nw
    from non_decimated_wavelets_tpu.ops import direct_path, pallas_kernels

    rng = np.random.default_rng(11)
    out = []
    for shape, wv, level in (((64, 128), "db2", 3), ((32, 16, 128), "db4", 3)):
        x = rng.standard_normal(shape).astype(np.float32)
        plan = nw.NDDWT(wavelet=wv, shape=shape, dtype=jax.numpy.float32, preserve_l2=True)
        taps = tuple(np.asarray(t) for t in plan.taps_hp)
        yd = direct_path.dec_direct(jax.numpy.asarray(x), plan.taps, level)
        with pltpu.force_tpu_interpret_mode():
            dec = pallas_kernels._fused_dec_multi(jax.numpy.asarray(x), taps, level, lam=LAM)
            rec = pallas_kernels._fused_rec_multi(yd, taps, level, True)
        out.append(types.SimpleNamespace(x=x, taps=taps, level=level, bands=np.array(yd),
                                         dec=np.asarray(dec), rec=np.asarray(rec)))
    return out


@pytest.mark.parametrize("case", [0, 1], ids=["2D", "3D"])
def test_multi_replay_matches_pallas_multi(jax_multi, case):
    """The replayed schedule equals the JAX one-launch kernels: the
    analysis with the fused shrink within 1e-5, the synthesis within
    1e-4."""
    c = jax_multi[case]
    got = stream_ref.multi_replay("dec", torch.from_numpy(c.x)[None], c.taps, c.level, LAM)
    np.testing.assert_allclose(got[0].numpy(), c.dec, atol=1e-5)
    got = stream_ref.multi_replay("rec", torch.from_numpy(c.bands)[None], c.taps, c.level, 1.0)
    np.testing.assert_allclose(got[0].numpy(), c.rec, atol=1e-4)


# ----------------------------------------------------------------- routes


@pytest.mark.parametrize("shape,wv,dtype,want", [
    ((8, 30), "db4", F32, True),  # an extent equal to the filter
    ((7, 30), "db4", F32, False),  # one shorter
    ((30, 8), "db4", F64, True),
    ((8, 9, 10), "db4", BF16, True),
    ((9, 10, 7), "db4", F32, False),
    ((64, 64, 64), "db15", F32, True),  # the stage route's filters (NDDWT.route
    ((64, 64, 64), "db12", F64, True),  # keeps those levels on the stage kernels)
    ((64, 64, 64), "db12", F32, True),
    ((48, 44, 46), ("db15", "db15", "db2"), F64, True),
    ((80, 90), "db38", F64, True),  # 2D: every filter length
])
def test_multi_supported_boundary(shape, wv, dtype, want):
    """``multi_supported`` holds where both directions' streamed plans exist
    (every filter no longer than its axis), and then ``_multi_geometry``
    builds both launches at any batch; where it does not, the geometry
    raises."""
    ext = tuple(max(s, 8) for s in shape) if not want else shape
    taps = tw.NDDWT(wv, ext, device="cpu").taps_hp
    assert multi.multi_supported(shape, taps, dtype, 3) is want
    for rec in (False, True):
        for batch in (1, 3):
            if want:
                n, k, t, left, bit, arr, gw = multi._multi_geometry(shape, taps, rec, dtype,
                                                                    batch)
                assert n[1] == (batch if len(shape) == 2 else shape[1])
                assert t[1] * t[2] == 256 * (ck._stream_items(k) if rec
                                             else ck._ana_items(k, dtype))
            else:
                with pytest.raises(NotImplementedError):
                    multi._multi_geometry(shape, taps, rec, dtype, batch)


# stage_route before this change, per 3D shape and dtype (float32, bfloat16,
# float64): the shortest uniform filter (taps) that takes the stage kernels
# (None: none up to the extent or 76), and per mixed taps its answer.
FIRST_STAGE = {
    (256, 256, 256): (30, 30, 24), (40, 41, 45): (30, 30, 24), (64, 64, 64): (30, 30, 24),
    (48, 44, 46): (30, 30, 24), (24, 30, 100): (None, None, 24), (12, 12, 12): (None,) * 3,
    (100, 20, 30): (None,) * 3,
}
MIXED_STAGE = {(30, 30, 4): (False,) * 3, (30, 4, 30): (False,) * 3, (4, 30, 30): (False,) * 3,
               (40, 2, 2): (False,) * 3, (24, 24, 24): (False, False, True),
               (28, 28, 30): (False, False, True)}


@pytest.mark.parametrize("shape", list(FIRST_STAGE))
def test_stage_route_is_unchanged(shape):
    for dt, first in zip((F32, BF16, F64), FIRST_STAGE[shape]):
        for K in range(2, min(min(shape), 76) + 1, 2):
            want = first is not None and K >= first
            assert ck.stage_route(shape, [np.zeros((2, K))] * 3, dt) is want, (dt, K)
        for ks, want in MIXED_STAGE.items():
            if max(ks) <= min(shape):
                got = ck.stage_route(shape, [np.zeros((2, K)) for K in ks], dt)
                assert got is want[(F32, BF16, F64).index(dt)], (dt, ks)
