"""The tiled schedule of the one-launch flat kernels, replayed on the CPU.

``csrc/nddwt_flat.cu`` runs one pass per axis group, level and direction:
each CTA copies a tile's window into shared memory and runs the level's
band tree there, as ``ops/flat.py``'s ``_flat_plan`` lays out.
``ops/stream_ref.flat_replay`` walks that schedule with torch ops (the
plan checked as the kernel checks it, every window read through the
kernel's tables, every stage inside its buffer, every output written
once). Here it is held against

* the plain versions (``flat_ref.flat_pair_ref``/``flat_iter_ref``): 1D,
  2D, 3D and 5D (axis groups), a window longer than its extent, batch 0
  and 2, every mode, float32 (1e-5 of max|plain|), float64 (1e-12) and
  bfloat16 (1e-2); forced plans (ragged tiles, several units a CTA, other
  groupings); and
* the JAX package's flat kernels (``pallas_flat``) in TPU interpret mode,
  as ``tests/test_torch_flat.py`` runs them, at one 2D and one 3D shape
  (float32 atol 1e-5 on bands, 1e-4 on reconstructions, 2e-3 on the
  solve: the JAX tests' own).

It also pins the plans of the main paths and their shared-memory budget.
"""

import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch.models import cs_recon
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import flat, flat_ref
from non_decimated_wavelets_tpu_torch.ops.stream_ref import flat_replay

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-2}
LAMS, MOMS = [0.2, 0.1, 0.05], [0.0, 0.3, 0.4]
CASES = [
    ((54,), "db4", 3),
    ((40, 36), "db4", 3),
    ((24, 18, 10), ("db2", "db3", "db2"), 2),
    ((20, 22), "db10", 2),  # windows of 39 x 41: longer than the extents
]
FIVE_D = ((12, 10, 8, 6, 5), "db1", 2)  # three axis groups


def _close(got, want, dt):
    got, want = got.double(), want.double()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= TOL[dt] * want.abs().max()


def _taps(wv, shape):
    return tw.NDDWT(wv, shape, device="cpu").taps_hp


def _modes(shape, taps, level, dt, batch, seed, sweeps=LAMS, plan=None, ctas=264,
           lams=(0.0, 0.1)):
    """Every mode of the replay against the plain versions."""
    g = torch.Generator().manual_seed(seed)
    lead = (2,) if batch else ()
    x = torch.randn(lead + shape, generator=g).to(dt)
    for lam in lams:
        got = flat_replay("pair", x, taps, level, True, lam, batch, plan=plan, ctas=ctas)
        want = flat_ref.flat_pair_ref("pair", x, taps, level, True, lam, batch)
        _close(got[0], want[0], dt)
        _close(got[1], want[1], dt)
    _close(flat_replay("dec", x, taps, level, False, 0.1, batch, plan=plan, ctas=ctas),
           flat_ref.flat_pair_ref("dec", x, taps, level, False, 0.1, batch), dt)
    _close(flat_replay("rec", want[0], taps, level, False, 0.0, batch, plan=plan, ctas=ctas),
           flat_ref.flat_pair_ref("rec", want[0], taps, level, batch=batch), dt)
    mask = (torch.rand(shape, generator=g) < 0.6).to(dt)
    b = (mask * x).to(dt)
    moms = MOMS[:len(sweeps)]
    _close(flat_replay("fista", b, taps, level, True, batch=batch, mask=mask, lams=sweeps,
                       moms=moms, step=1.0, plan=plan, ctas=ctas),
           flat_ref.flat_iter_ref("fista", b, mask, taps, level, True, sweeps, moms, 1.0,
                                  batch), dt)
    _close(flat_replay("chain", x, taps, level, True, batch=batch, lams=sweeps, plan=plan,
                       ctas=ctas),
           flat_ref.flat_iter_ref("chain", x, None, taps, level, True, sweeps, None, 0.0,
                                  batch), dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("shape,wv,level", CASES)
def test_replay_matches_plain_versions(shape, wv, level, dtype):
    """dec, rec, pair (lam 0 and 0.1), chain and fista, batch 0 and 2."""
    taps = _taps(wv, shape)
    for batch in (0, 2):
        _modes(shape, taps, level, dtype, batch, seed=batch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [0, 2])
def test_replay_5d_axis_groups(batch, dtype):
    """5D: three axis groups a level (partial bands through memory), every
    mode, one sweep of the iterates."""
    shape, wv, level = FIVE_D
    taps = _taps(wv, shape)
    plan = flat._flat_plan(shape, (2,) * 5, dtype, batch)
    assert len(plan.ends) > 1
    _modes(shape, taps, level, dtype, batch, seed=5, sweeps=LAMS[:1], lams=(0.1,))


FORCED = [  # (shape, wavelet, level, group ends, tile): ragged tiles, other groupings
    ((40, 36), "db4", 2, (1, 2), (3, 7)),
    ((40, 36), "db4", 2, (2,), (40, 5)),
    ((24, 18, 10), ("db2", "db3", "db2"), 2, (2, 3), (7, 18, 4)),
    ((24, 18, 10), ("db2", "db3", "db2"), 2, (1, 2, 3), (5, 4, 3)),
    ((20, 22), "db10", 2, (2,), (7, 9)),
    ((54,), "db4", 3, (1,), (5,)),
]


@pytest.mark.parametrize("shape,wv,level,ends,tile", FORCED)
def test_replay_forced_plans(shape, wv, level, ends, tile):
    """Plans the cost model would not pick, on a grid of 3 CTAs (several
    units a CTA), batch 2, float64."""
    taps = _taps(wv, shape)
    k = tuple(t.shape[1] for t in taps)
    lay = flat.flat_layout(shape, k, tile, ends, 2, 8)
    plan = flat.FlatPlan(ends, tile, lay["smem"], lay["units"])
    _modes(shape, taps, level, torch.float64, 2, seed=7, sweeps=LAMS[:2], plan=plan, ctas=3)


def test_replay_refuses_a_plan_the_kernel_refuses():
    """A plan whose shared memory or units disagree with its tiles, or
    whose tile exceeds the extent, fails as the kernel's check fails."""
    shape, taps = (40, 36), _taps("db4", (40, 36))
    x = torch.randn(shape)
    good = flat._flat_plan(shape, (8, 8), torch.float32, 0)
    for bad in (good._replace(smem=good.smem - 4), good._replace(units=good.units + 1),
                good._replace(tile=(41, 36))):
        with pytest.raises(AssertionError):
            flat_replay("pair", x, taps, 2, True, 0.1, 0, plan=bad)


# ------------------------------------------- against pallas_flat (interpret)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    import non_decimated_wavelets_tpu as nw
    from non_decimated_wavelets_tpu.ops import pallas_flat

    return jax, pltpu, nw, pallas_flat


@pytest.mark.parametrize("shape,wv,level,iters", [((26, 26), ("db1", "db3"), 2, 4),
                                                  ((24, 18, 10), ("db2", "db3", "db2"), 2, 1)])
def test_replay_matches_pallas_flat(jx, shape, wv, level, iters, rng):
    """dec, rec and pair (threshold 0.1) of the replay against
    ``pallas_flat._call``, and a FISTA solve against ``_call_iter``, in
    interpret mode."""
    jax, pltpu, nw, pallas_flat = jx
    jnp = jax.numpy
    jp = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=True, dtype=jnp.float32)
    taps = tuple(np.asarray(t) for t in jp.taps_hp)
    x = rng.standard_normal(shape).astype(np.float32)
    mask = (rng.random(shape) < 0.6).astype(np.float32)
    b = mask * x
    lams, moms = cs_recon._fista_schedule(iters, 0.05, 1.0)
    with pltpu.force_tpu_interpret_mode():
        y_j = np.asarray(pallas_flat.dec_flat(jnp.asarray(x), taps, level))
        xr_j = np.asarray(pallas_flat.rec_flat(jnp.asarray(y_j), taps, level, True))
        yp_j, xp_j = pallas_flat.pair_flat(jnp.asarray(x), taps, level, True, 0.1)
        xf_j = np.asarray(pallas_flat.fista_flat(jnp.asarray(b), jnp.asarray(mask), taps,
                                                 level, True, lams, moms, 1.0))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(flat_replay("dec", xt, taps, level).numpy(), y_j, atol=1e-5)
    np.testing.assert_allclose(
        flat_replay("rec", torch.from_numpy(y_j.copy()), taps, level, True).numpy(), xr_j,
        atol=1e-4)
    yp, xp = flat_replay("pair", xt, taps, level, True, 0.1)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yp_j), atol=1e-5)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xp_j), atol=1e-4)
    xf = flat_replay("fista", torch.from_numpy(b), taps, level, True,
                     mask=torch.from_numpy(mask), lams=lams, moms=moms, step=1.0)
    np.testing.assert_allclose(xf.numpy(), xf_j, atol=2e-3)


# ------------------------------------------------------------------ the plans


BUDGET_SHAPES = [((256, 256), (8, 8)), ((264, 264), (2, 6)), ((64, 64, 64), (8, 8, 8)),
                 ((2**20,), (8,)), ((2048, 2048), (8, 8)), ((16, 16, 16, 16), (4,) * 4),
                 ((128, 128, 160), (8, 8, 8)), ((64, 64, 64), (40, 40, 40)),
                 ((8,) * 8, (2,) * 8), ((128, 128), (76, 76))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_replay_copies_whole_pieces(dtype):
    """Windows are copied in 16-byte pieces where the last extent is a
    multiple of a piece's words, also where a window wraps more than once
    ((20, 24) db10: rows of 41 columns); never where it is not ((20, 23))."""
    taps = _taps("db10", (20, 24))
    x = torch.randn((2, 20, 24), generator=torch.Generator().manual_seed(5)).to(dtype)
    for shape, want_whole in (((20, 24), True), ((20, 23), False)):
        xs = x[..., :shape[-1]].contiguous()
        stats = {}
        got = flat_replay("pair", xs, taps, 2, True, 0.1, 2, stats=stats)
        want = flat_ref.flat_pair_ref("pair", xs, taps, 2, True, 0.1, 2)
        _close(got[1], want[1], dtype)
        if want_whole:
            assert stats["whole"] > 4 * stats["single"]
        else:
            assert stats["whole"] == 0 and stats["single"] > 0


@pytest.mark.parametrize("shape,k", BUDGET_SHAPES)
def test_plans_fit_and_cover(shape, k):
    """Every plan: groups of consecutive axes covering the array, at most
    ``_FLAT_GROUP`` a pass, tiles within the extents, shared memory within
    the budget and the kernel's figures (``flat_layout``)."""
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        for batch in (0, 2):
            p = flat._flat_plan(shape, k, dtype, batch)
            d = len(shape)
            widths = np.diff((0,) + p.ends)
            assert p.ends[-1] == d and (widths >= 1).all()
            assert widths.max() <= min(flat._FLAT_GROUP, d)
            assert all(1 <= t <= n for t, n in zip(p.tile, shape))
            lay = flat.flat_layout(shape, k, p.tile, p.ends, max(batch, 1), ck._word(dtype))
            assert (lay["smem"], lay["units"]) == (p.smem, p.units)
            assert p.smem <= flat._FLAT_SMEM_BUDGET
            assert len(p.ints()) == flat.PLAN_INTS


def test_main_path_plans():
    """The one-launch solve (256^2 db4) takes one pass a level and
    direction; 5D takes groups of two axes."""
    solve = flat._flat_plan((256, 256), (8, 8), torch.float32, 0)
    assert solve.ends == (2,)
    assert flat._flat_plan((256, 256), (8, 8), torch.float32, 2).ends == (2,)
    assert flat._flat_plan(FIVE_D[0], (2,) * 5, torch.float32, 0).ends == (2, 4, 5)
    lay = flat.flat_layout((256, 256), (8, 8), solve.tile, solve.ends, 1, 4)
    assert len(lay["passes"]) == 2  # a level's analysis and synthesis


def test_no_plan_raises(monkeypatch):
    """A shape no plan fits raises; it is never sent to another route."""
    monkeypatch.setattr(flat, "_FLAT_SMEM_BUDGET", 64)
    flat._flat_plan.cache_clear()
    try:
        with pytest.raises(NotImplementedError, match="no plan"):
            flat._flat_plan((64, 64), (8, 8), torch.float32, 0)
    finally:
        flat._flat_plan.cache_clear()
