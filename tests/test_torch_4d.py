"""The 4D level of the torch port against the JAX package on the CPU, and —
on a CUDA device only — the four stage kernels against their plain versions.

* The plain versions of the stage kernels (``ops/level4_ref.py``) against
  the JAX package's 4D Pallas kernels in TPU interpret mode
  (``pallas_4d._lane_dec_call``, ``_lead_dec_call``, ``_lead_adj_call``,
  ``_lane_adj_call``), reshaped to the JAX stage layouts, at shapes that
  ``pallas_4d.supported`` accepts (those of ``tests/test_pallas.py``).
* ``cuda_kernels.dec_levels``/``rec_levels`` in 4D against
  ``pallas_4d.dec4``/``rec4``.
* The port's 4D plan on its CPU route and on the kernel route (the device
  check stubbed, so the wrappers run their plain versions) against the JAX
  plan on the CPU and the float64 oracle, at odd extents and T > 128
  (which the TPU package refuses); complex and split data; float64.
* The solvers in 4D against the JAX solvers, and the 3D long-filter route.

Tolerances: float32 atol 1e-5 (bands; 1e-4 reconstructions and round
trips), the JAX kernel tests' own; float64 1e-12, solvers 1e-10.

JAX is imported by the ``jx`` fixture, not at module level, so that the
CUDA cases also run on a GPU machine without JAX:
``python -m pytest tests/test_torch_4d.py -m cuda --noconftest``.
"""

import contextlib
import types
from functools import partialmethod

import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import convert, oracle
from non_decimated_wavelets_tpu_torch import plan as tplan
from non_decimated_wavelets_tpu_torch.models import cs_recon
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import level4_ref as r4
from non_decimated_wavelets_tpu_torch.ops import level_ref
from non_decimated_wavelets_tpu_torch.ops import flat, multi

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)

KERNEL_CASES = [((8, 8, 4, 32), "db2"), ((8, 16, 8, 16), ("db1", "db2", "db3", "db2"))]
STAGES = ("lane_dec", "lead_dec", "lead_adj", "lane_adj", "dec_level", "rec_level")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    import non_decimated_wavelets_tpu as nw
    from non_decimated_wavelets_tpu import models
    from non_decimated_wavelets_tpu.ops import pallas_4d

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, pltpu=pltpu, nw=nw,
                                 models=models, pallas_4d=pallas_4d)


@pytest.fixture
def as_cuda(monkeypatch):
    """Route every tensor as if it were on a CUDA device: the plan takes
    the kernel route, whose wrappers run their plain versions here."""
    monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=True))
    # The per-level route at these small shapes: tests/test_torch_flat.py
    # holds the one-launch flat route, tests/test_torch_multi.py the
    # multilevel one.
    monkeypatch.setattr(flat, "FLAT_MAX_NUMEL", {None: 0})
    monkeypatch.setattr(multi, "MULTI_MAX_NUMEL", 0)
    monkeypatch.setattr(flat, "ITER_MAX_NUMEL", 0)


@pytest.fixture
def per_level(monkeypatch):
    """Hold a plan on the card to the per-level route at a shape within the
    one-launch flat and multilevel kernels' sizes (tests/test_torch_flat.py
    and tests/test_torch_multi.py hold those)."""
    monkeypatch.setattr(flat, "FLAT_MAX_NUMEL", {None: 0})
    monkeypatch.setattr(multi, "MULTI_MAX_NUMEL", 0)
    monkeypatch.setattr(flat, "ITER_MAX_NUMEL", 0)


@pytest.fixture
def calls(monkeypatch):
    """Count the level and stage wrappers' calls (what the card launches)."""
    counts = dict.fromkeys(STAGES, 0)
    for name in STAGES:
        real = getattr(ck, name)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ck, name, spy)
    return counts


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * np.abs(want).max())


def _jax_taps(jx, wv, shape):
    jplan = jx.nw.NDDWT(wavelet=wv, shape=shape, dtype=jx.jnp.float32)
    return tuple(np.asarray(t) for t in jplan.taps_hp)


def _lead_geometry(jx, shape, taps):
    """The JAX lead stage's lane chunking and tiles (as ``dec4`` picks them)."""
    X, Y, Z, T = shape
    zct = jx.pallas_4d._chunk(Z, T) * T
    tiles = jx.pallas_4d._lead_tiles(X, Y, zct, taps[0].shape[1], taps[1].shape[1])
    return (X, Y, Z * T // zct, zct), tiles, zct


def _lane_tiles(jx, shape, taps):
    X, Y, Z, T = shape
    return jx.pallas_4d._lane_tiles(X, Y, Z * T, max(taps[2].shape[1], taps[3].shape[1]))


def _interpret(jx, fn, *args):
    with jx.pltpu.force_tpu_interpret_mode():
        return jx.jax.jit(fn)(*args)


# ------------------------------------------------- plain versions vs Pallas


@pytest.mark.parametrize("shape,wv", KERNEL_CASES)
def test_lane_stage_refs_match_jax(jx, shape, wv, rng):
    """``lane_dec_ref`` against ``_lane_dec_call`` and ``lane_adj_ref``
    against ``_lane_adj_call`` (scales 1 and 1/16)."""
    taps = _jax_taps(jx, wv, shape)
    X, Y, Z, T = shape
    tiles = _lane_tiles(jx, shape, taps)
    x = rng.standard_normal(shape).astype(np.float32)
    want = _interpret(jx, lambda v: jx.pallas_4d._lane_dec_call(v, taps, T, tiles),
                      x.reshape(X, Y, Z * T))
    got = r4.lane_dec_ref(torch.from_numpy(x), taps)
    assert got.shape == (4,) + shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().reshape(4, X, Y, Z * T), want, atol=1e-5)
    partial = rng.standard_normal((4,) + shape).astype(np.float32)
    for scale in (1.0, 1.0 / 16):
        want = _interpret(
            jx, lambda p: jx.pallas_4d._lane_adj_call(p, taps, T, tiles, scale),
            partial.reshape(4, X, Y, Z * T))
        got = r4.lane_adj_ref(torch.from_numpy(partial), taps, scale)
        np.testing.assert_allclose(got.numpy().reshape(X, Y, Z * T), want, atol=1e-5)


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("lam", [0.0, 0.1])
@pytest.mark.parametrize("shape,wv", KERNEL_CASES)
def test_lead_dec_ref_matches_jax(jx, shape, wv, lam, final, rng):
    """``lead_dec_ref`` against ``_lead_dec_call``: the 15 details in place
    at ``band_off`` (shrunk by ``lam``), the approximation returned or, at
    the final level, into band 0 (``approx_to_big``); other bands kept."""
    taps = _jax_taps(jx, wv, shape)
    view, tiles, zct = _lead_geometry(jx, shape, taps)
    B, off = 31, 16
    temp = rng.standard_normal((4,) + shape).astype(np.float32)
    big = rng.standard_normal((B,) + shape).astype(np.float32)

    def run(t5, b5):
        return jx.pallas_4d._lead_dec_call(t5, b5, off, taps, tiles, zct,
                                          approx_to_big=final, lam=lam)

    out = _interpret(jx, run, temp.reshape((4,) + view), big.reshape((B,) + view))
    big_j, app_j = (out, None) if final else out
    big_t = torch.from_numpy(big.copy())
    app_t = r4.lead_dec_ref(torch.from_numpy(temp), big_t, off, taps, lam, final)
    np.testing.assert_allclose(big_t.numpy(), np.asarray(big_j).reshape(big.shape),
                               atol=1e-5)
    if final:
        assert app_t is None
    else:
        np.testing.assert_allclose(app_t.numpy(), np.asarray(app_j).reshape(shape),
                                   atol=1e-5)


@pytest.mark.parametrize("band0", ["y", "a"])
@pytest.mark.parametrize("shape,wv", KERNEL_CASES)
def test_lead_adj_ref_matches_jax(jx, shape, wv, band0, rng):
    """``lead_adj_ref`` against ``_lead_adj_call`` with both kinds of band
    source: all 16 bands from ``y``, or band 0 from the running
    approximation and the details from a deeper group of ``y``."""
    taps = _jax_taps(jx, wv, shape)
    view, tiles, zct = _lead_geometry(jx, shape, taps)
    B = 31
    y = rng.standard_normal((B,) + shape).astype(np.float32)
    acc = rng.standard_normal(shape).astype(np.float32)
    if band0 == "y":
        src = [("y", b) for b in range(16)]
        want = _interpret(
            jx, lambda v: jx.pallas_4d._lead_adj_call(v, None, src, taps, tiles, zct),
            y.reshape((B,) + view))
    else:
        src = [("a", 0)] + [("y", 16 + b - 1) for b in range(1, 16)]
        want = _interpret(
            jx, lambda v, a: jx.pallas_4d._lead_adj_call(v, a, src, taps, tiles, zct),
            y.reshape((B,) + view), acc.reshape((1,) + view))
    got = r4.lead_adj_ref(torch.from_numpy(y), torch.from_numpy(acc), src, taps)
    assert got.shape == (4,) + shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape((4,) + shape),
                               atol=1e-5)


@pytest.mark.parametrize("lam", [0.0, 0.1])
@pytest.mark.parametrize("shape,wv", KERNEL_CASES)
def test_levels_match_dec4_rec4(jx, shape, wv, lam, rng):
    """The port's 4D level loops (lane and lead stage per level) against
    ``pallas_4d.dec4``/``rec4``; and the round trip."""
    taps = _jax_taps(jx, wv, shape)
    level = 2
    x = rng.standard_normal(shape).astype(np.float32)
    want = _interpret(jx, lambda v: jx.pallas_4d.dec4(v, taps, level, lam=lam), x)
    y = ck.dec_levels(torch.from_numpy(x), taps, level, lam, stages=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5)
    xr_j = _interpret(jx, lambda v: jx.pallas_4d.rec4(v, taps, level, False), y.numpy())
    xr = ck.rec_levels(y, taps, level, False, stages=True)
    np.testing.assert_allclose(xr.numpy(), np.asarray(xr_j), atol=1e-5)
    if not lam:
        np.testing.assert_allclose(xr.numpy(), x, atol=1e-4)


# -------------------------------------------------------------- the 4D plan


@pytest.mark.parametrize("route", ["direct", "kernels"])
@pytest.mark.parametrize("pl2", [False, True])
@pytest.mark.parametrize("shape,wv,level",
                         [((12, 10, 9, 7), "db2", 2), ((6, 4, 4, 136), "db2", 1)])
def test_plan_4d_matches_jax_and_oracle(jx, request, calls, route, shape, wv,
                                        level, pl2, rng):
    """Odd extents and T > 128: ``dec_rec`` with the fused shrink against
    the JAX plan; ``dec`` against the float64 oracle; the round trip. The
    kernel route launches one lane and one lead stage per level and
    direction, and no per-level kernel."""
    if route == "kernels":
        request.getfixturevalue("as_cuda")
    jp = jx.nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2, dtype=jx.jnp.float32)
    tp = tw.NDDWT(wv, shape, preserve_l2=pl2, device="cpu")
    x = rng.standard_normal(shape).astype(np.float32)
    y_j, xr_j = jp.dec_rec(jx.jnp.asarray(x), level, threshold=0.1)
    calls.update(dict.fromkeys(calls, 0))
    y_t, xr_t = tp.dec_rec(x, level, threshold=0.1)
    per_level = level if route == "kernels" else 0
    assert calls == {**dict.fromkeys(STAGES[:4], per_level), "dec_level": 0,
                     "rec_level": 0}
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(xr_t.numpy(), np.asarray(xr_j), atol=1e-4)
    y = tp.dec(x, level)
    np.testing.assert_allclose(
        y.numpy(), oracle.dec(x.astype(np.float64), wv, level, pl2), atol=1e-5)
    np.testing.assert_allclose(tp.rec(y).numpy(), x, atol=1e-4)


def test_complex_and_split_4d_match_jax(jx, as_cuda, calls, rng):
    """Complex ``dec_rec`` and the split ``dec_rec_split`` on the kernel
    route (each re/im component through its own stage chain, the joint
    shrink between them) against the JAX plan on the CPU."""
    shape, wv, level, thr = (6, 6, 5, 7), "db2", 2, 0.3
    jp = jx.nw.NDDWT(wavelet=wv, shape=shape, dtype=jx.jnp.float32)
    tp = tw.NDDWT(wv, shape, device="cpu")
    z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    y_j, xr_j = jp.dec_rec(jx.jnp.asarray(z), level, threshold=thr)
    y_t, xr_t = tp.dec_rec(z, level, threshold=thr)
    assert y_t.dtype == torch.complex64
    _close(y_t.numpy(), y_j, 1e-5)
    _close(xr_t.numpy(), xr_j, 1e-4)
    pair = np.stack([z.real, z.imag])
    yp_j, xp_j = jp.dec_rec_split(jx.jnp.asarray(pair), level, threshold=thr)
    calls.update(dict.fromkeys(calls, 0))
    yp_t, xp_t = tp.dec_rec_split(pair, level, threshold=thr)
    assert calls["lane_dec"] == calls["lane_adj"] == 2 * level
    _close(yp_t.numpy(), yp_j, 1e-5)
    _close(xp_t.numpy(), xp_j, 1e-4)
    _close(tp.rec_split(tp.dec_split(pair, level)).numpy(), pair, 1e-4)


def test_float64_4d_levels_and_plan(jx, rng):
    """float64 to 1e-12: the stage plain versions' level loops against the
    oracle (bands and round trip), and the port's plan against the JAX
    plan."""
    shape, wv, level = (12, 10, 9, 7), ("db2", "db1", "db3", "db2"), 2
    x = rng.standard_normal(shape)
    tp = tw.NDDWT(wv, shape, dtype="float64", device="cpu")
    y = ck.dec_levels(torch.from_numpy(x), tp.taps_hp, level, stages=True)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.movedim(0, -1).numpy(), oracle.dec(x, wv, level),
                               atol=1e-12)
    np.testing.assert_allclose(ck.rec_levels(y, tp.taps_hp, level, False, stages=True).numpy(), x,
                               atol=1e-12)
    jp = jx.nw.NDDWT(wavelet=wv, shape=shape, dtype=jx.jnp.float64)
    np.testing.assert_allclose(tp.dec(x, level).numpy(),
                               np.asarray(jp.dec(jx.jnp.asarray(x), level)), atol=1e-12)


@pytest.mark.parametrize("pl2", [False, True])
def test_gradcheck_4d_f64(pl2, rng):
    shape, level = (4, 4, 4, 5), 1
    plan = tw.NDDWT("db2", shape, preserve_l2=pl2, dtype="float64", device="cpu")
    x = torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
    assert torch.autograd.gradcheck(lambda v: plan.dec(v, level, band_axis=0), (x,),
                                    fast_mode=True)
    y = torch.from_numpy(rng.standard_normal((16,) + shape)).requires_grad_()
    assert torch.autograd.gradcheck(lambda v: plan.rec(v, band_axis=0), (y,),
                                    fast_mode=True)


def test_plan_from_jax_4d(jx):
    jp = jx.nw.NDDWT(wavelet=("db2", "sym4", "haar", "db4"), shape=(8, 10, 6, 140),
                     preserve_l2=True, dtype=jx.jnp.float32)
    taps_hp = tuple(np.asarray(t) for t in jp.taps_hp)
    tp = convert.plan_from_jax(jp.to_config(), taps_hp, device="cpu")
    assert tp.to_config() == jp.to_config() and tp.ndim == 4
    for a, b in zip(tp.taps_hp, taps_hp):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------------------------ solvers


def test_fista_4d_match_jax_f64(jx, rng):
    """``fista_cs_mri`` (``fftn`` over all four axes) and ``fista_inpaint``
    on a small 4D volume against the JAX solvers, float64."""
    shape, wv, level, iters = (6, 6, 4, 5), "db2", 2, 8
    img = rng.standard_normal(shape)
    mask = (rng.random(shape) < 0.5).astype(np.float64)
    jp = jx.nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=True, dtype=jx.jnp.float64)
    tp = tw.NDDWT(wv, shape, preserve_l2=True, dtype="float64", device="cpu")
    b = mask * np.fft.fftn(img, norm="ortho")
    want = jx.models.fista_cs_mri(jp, jx.jnp.asarray(b), jx.jnp.asarray(mask),
                                  lam=0.02, level=level, iters=iters)
    got = tw.models.fista_cs_mri(tp, b, mask, 0.02, level, iters)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)
    want = jx.models.fista_inpaint(jp, jx.jnp.asarray(mask * img), jx.jnp.asarray(mask),
                                   0.02, level=level, iters=iters)
    got = tw.models.fista_inpaint(tp, mask * img, mask, 0.02, level, iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)
    _, moms = cs_recon._fista_schedule(iters, 0.02, 1.0)
    got = cs_recon._fista_stepped(tp, torch.from_numpy(mask * img),
                                  torch.from_numpy(mask), 0.02, level, moms, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


def test_fista_cs_mri_4d_kernel_route(jx, as_cuda, calls, rng):
    """The route the card takes for 4D CS-MRI (float32, preserve_l2): per
    iteration two stage chains per direction; against the JAX solver."""
    shape, wv, level, iters = (8, 6, 5, 7), "db2", 2, 4
    img = rng.standard_normal(shape).astype(np.float32)
    mask = (rng.random(shape) < 0.4).astype(np.float32)
    b = (mask * np.fft.fftn(img, norm="ortho")).astype(np.complex64)
    jp = jx.nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=True, dtype=jx.jnp.float32)
    tp = tw.NDDWT(wv, shape, preserve_l2=True, device="cpu")
    want = jx.models.fista_cs_mri(jp, jx.jnp.asarray(b), jx.jnp.asarray(mask),
                                  lam=0.05, level=level, iters=iters)
    calls.update(dict.fromkeys(calls, 0))
    got = tw.models.fista_cs_mri(tp, b, mask, 0.05, level, iters)
    n = 2 * level * iters
    assert calls == {**dict.fromkeys(STAGES[:4], n), "dec_level": 0, "rec_level": 0}
    _close(got.numpy(), want, 1e-5)


# ------------------------------------------------ the 3D long-filter route


def test_long_filter_3d_route(calls, rng):
    """A 3D plan whose filters the per-level kernels' tile cannot hold runs
    on the stage kernels (one lane axis, 8 bands): the stage plain versions
    give the per-level plain versions' bands and synthesis."""
    shape, level, B = (40, 41, 42), 2, 15
    taps = tw.NDDWT("db20", shape, device="cpu").taps_hp
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    stages = ck.stage_route(shape, taps)
    y = ck.dec_levels(x, taps, level, lam=0.1, stages=stages)
    want = torch.empty_like(y)
    a = x
    for lvl in range(level):
        a = level_ref.dec_level_ref(a, want, B - 7 * (lvl + 1), taps, 0.1,
                                    final=lvl == level - 1)
    _close(y.numpy(), want.numpy(), 1e-5)
    xr = ck.rec_levels(y, taps, level, False, stages=stages)
    acc = level_ref.rec_level_ref(y, None, [("y", b) for b in range(8)], taps, 1 / 8)
    acc = level_ref.rec_level_ref(y, acc, [("a", 0)] + [("y", 7 + b) for b in range(1, 8)],
                                  taps, 1 / 8)
    _close(xr.numpy(), acc.numpy(), 1e-5)
    assert calls == {**dict.fromkeys(STAGES[:4], level), "dec_level": 0, "rec_level": 0}


@pytest.mark.parametrize("wv,stages", [("db4", False), ("db14", False), ("db15", True),
                                       ("sym20", True), (("db15", "db15", "db2"), False)])
def test_stage_route(wv, stages):
    """Every 4D level takes the stage kernels; a 3D level does when the
    per-level kernels' tile cannot hold its filters; 2D never."""
    shape = (48, 44, 46)
    taps = tw.NDDWT(wv, shape, device="cpu").taps_hp
    assert ck.stage_route(shape, taps) is stages
    assert ck.stage_route(shape + (64,), taps + taps[2:])
    assert not ck.stage_route(shape[:2], taps[:2])


@pytest.mark.parametrize(
    "shape,wv",
    [((128, 128, 128, 32), "db4"), ((64, 64, 20, 10), "db2"), ((6, 4, 4, 136), "db2"),
     ((8, 16, 8, 16), ("db1", "db2", "db3", "db2")), ((76, 80, 84), "db38"),
     ((128, 128, 128), "db20"), ((77, 76, 76, 76), "db38")],
)
@pytest.mark.parametrize("lane", [True, False])
@pytest.mark.parametrize("adj", [False, True])
def test_stage_geometry(shape, wv, lane, adj):
    """The launch geometry the stage wrappers hand the kernels: the 3-slot
    view, one tap of 1.0 on the pass-through slot, the analysis/adjoint
    halos and tap orientation, and a plan inside the shared-memory budget:
    for the lane stages the lane body's (R, Zc, stages), whose units cover
    the view, for the lead stages their streamed plan, inside the stream
    budget (the analysis's with the in-plane bands a walk keeps)."""
    taps = tw.NDDWT(wv, shape, device="cpu").taps_hp
    (n, k, t, left, arr), body = ck._stage_geometry(shape, taps, lane, adj)
    assert body == ("lane" if lane else "window")
    lane_axes = list(range(2, len(shape)))
    if lane:
        want_n = [shape[0] * shape[1], shape[2], shape[3] if len(shape) == 4 else 1]
        slot_taps = [None] + [taps[a] for a in lane_axes] + [None] * (4 - len(shape))
    else:
        want_n = [shape[0], shape[1], int(np.prod(shape[2:]))]
        slot_taps = [taps[0], taps[1], None]
    assert list(n) == want_n
    for a, tp in enumerate(slot_taps):
        if tp is None:
            assert k[a] == 1 and left[a] == 0 and t[a] >= 1
            assert arr[a, :, 0].tolist() == [1.0, 1.0] and not arr[a, :, 1:].any()
        else:
            K = tp.shape[1]
            assert k[a] == K and left[a] == (K // 2 if adj else K // 2 - 1)
            want = tp[:, ::-1] if adj else tp
            np.testing.assert_array_equal(arr[a, :, :K], want.astype(np.float32))
    if not lane:  # the lead stages stream X: (C, T1, T2)
        items = ck._stream_items(list(k)) if adj else ck._ana_items(list(k))
        assert t[1] * t[2] == 256 * items and t[2] & (t[2] - 1) == 0
        assert 1 <= t[0] <= n[0] and 1 <= t[1]
        bands = 1 if adj else ck._walk_bands(list(k), list(t))
        assert 2 % bands == 0
        assert (ck._stream_smem(list(k), list(t), torch.float32, bands=bands)
                <= ck._STREAM_SMEM_BUDGET)
        return
    R, Zc, stages = t
    assert 1 <= stages <= ck._LANE_MAX_STAGES and 1 <= R <= n[0] and Zc >= 1
    assert Zc >= n[1] or (R == 1 and Zc + k[1] - 1 <= n[1])
    assert (ck._lane_smem(tuple(n), tuple(k), tuple(t), torch.float32, adj)
            <= ck._STREAM_SMEM_BUDGET)


def test_launch_arguments():
    """The ctypes arguments every launch takes, built here as on the card:
    the extents and the tap array the kernels read through a pointer."""
    shape = (8, 8, 4, 6)
    taps = tw.NDDWT("db2", shape, device="cpu").taps_hp
    stage, _ = ck._stage_geometry(shape, taps, True, False)
    multilevel = multi._multi_geometry(shape[:3], taps[:3], True, torch.float32, 1)
    for n, arr in ((stage[0], stage[-1]), (multilevel[0], multilevel[5])):
        ptr = ck._taps_ptr(arr)
        assert [ptr[i] for i in range(arr.size)] == arr.ravel().tolist()
        assert all(v >= 1 for v in n)


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


def test_cuda_branches_against_a_stub_library(monkeypatch):
    """The wrappers' CUDA branches, run here against a library stub that
    records each launch: the arguments they build, the counts they keep
    and the arrays they hand back (the card runs the real library)."""
    launched = []

    class Stub:
        def __getattr__(self, name):
            return lambda *args: launched.append((name, args)) or 0

    monkeypatch.setattr(ck, "load", lambda: Stub())
    monkeypatch.setattr(ck, "load4", lambda: Stub())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    on_card = lambda t: t.as_subclass(_OnCard)  # noqa: E731
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: on_card(empty(*a, **k)))
    before = dict(ck.launch_counts)
    shape, level = (8, 8, 4, 6), 2
    taps = tw.NDDWT("db2", shape, device="cpu").taps_hp
    y = ck.dec_levels(on_card(torch.zeros(shape)), taps, level, stages=True)
    assert y.shape == (31,) + shape
    x = ck.rec_levels(on_card(y), taps, level, False, stages=True)
    assert x.shape == shape
    names = [name for name, _ in launched]
    assert names == ["nddwt_lane_dec", "nddwt_lead_dec"] * level + [
        "nddwt_lead_adj", "nddwt_lane_adj"] * level
    n = launched[0][1][3]  # lane_dec: x, temp, dtype, n, ...
    assert list(n) == [64, 4, 6]
    assert launched[0][1][8] == 0  # body: the lane body, named by the wrapper
    src = launched[2 * level + 2][1][9]  # the second level's band sources
    assert list(src) == [-1] + list(range(16, 31))
    y3 = ck.dec_levels(on_card(torch.zeros(shape[:3])), taps[:3], 1, stages=False)
    ck.rec_levels(on_card(y3), taps[:3], 1, True, stages=False)
    assert [name for name, _ in launched[-2:]] == ["nddwt_dec_level", "nddwt_rec_level"]
    for name in ck.launch_counts:
        if name.startswith("nddwt_l"):
            assert ck.launch_counts[name] == before[name] + level
    for name in ("nddwt_dec_level", "nddwt_rec_level"):
        assert ck.launch_counts[name] == before[name] + 1


def test_stage_wrappers_check_their_operands(rng):
    shape = (8, 8, 4, 6)
    taps = tw.NDDWT("db2", shape, device="cpu").taps_hp
    temp = torch.zeros((4,) + shape)
    with pytest.raises(ValueError, match="cannot take"):
        ck.lead_dec(temp, torch.zeros((16,) + shape), 2, taps)
    with pytest.raises(ValueError, match="cannot take"):
        ck.lead_dec(temp[:2], torch.zeros((16,) + shape), 1, taps)
    y = torch.zeros((16,) + shape)
    with pytest.raises(ValueError, match="bad band source"):
        ck.lead_adj(y, None, [("y", 16)] + [("y", b) for b in range(1, 16)], taps)
    with pytest.raises(ValueError, match="needs an approx"):
        ck.lead_adj(y, None, [("a", 0)] + [("y", b) for b in range(1, 16)], taps)
    with pytest.raises(ValueError, match="expected 16 band sources"):
        ck.lead_adj(y, None, [("y", b) for b in range(8)], taps)
    with pytest.raises(ValueError, match="lane bands"):
        ck.lane_adj(temp[:2], taps, 1.0)
    with pytest.raises(NotImplementedError, match="3D and 4D"):
        ck.lane_dec(torch.zeros(8, 8), taps[:2])


# ------------------------------------------------------------ on the card


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,wv", [((12, 10, 9, 7), "db2"), ((8, 8, 8, 136), "db4"),
                                      ((40, 41, 45), "db20")])
def test_cuda_stage_kernels_match_plain_versions(shape, wv, dtype):
    _need_cuda()
    dt = getattr(torch, dtype)
    tol = 1e-5 if dt == torch.float32 else 1e-2  # relative to max|plain|
    taps = tw.NDDWT(wv, shape, device="cuda").taps_hp
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda").to(dt)

    def close(k, r):
        assert (k.float() - r.float()).abs().max() <= tol * r.float().abs().max()

    temp = r4.lane_dec_ref(x, taps)
    close(ck.lane_dec(x, taps), temp)
    nb = 4 * temp.shape[0]
    for lam in (0.0, 0.1):
        for final in (False, True):
            bk = torch.zeros((2 * nb - 1,) + shape, dtype=dt, device="cuda")
            br = bk.clone()
            ak = ck.lead_dec(temp, bk, nb, taps, lam, final)
            ar = r4.lead_dec_ref(temp, br, nb, taps, lam, final)
            close(bk, br)
            if not final:
                close(ak, ar)
    y = torch.randn((2 * nb - 1,) + shape, generator=g, device="cuda").to(dt)
    for src in ([("y", b) for b in range(nb)],
                [("a", 0)] + [("y", nb + b - 1) for b in range(1, nb)]):
        close(ck.lead_adj(y, x, src, taps), r4.lead_adj_ref(y, x, src, taps))
    for scale in (1.0, 1.0 / nb):
        close(ck.lane_adj(temp, taps, scale), r4.lane_adj_ref(temp, taps, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("pl2", [False, True])
def test_cuda_4d_plan_matches_cpu_plan(per_level, pl2):
    """The 4D plan on the stage kernels against the plan on the CPU direct
    path: ``dec_rec`` with the fused shrink, exactly one launch of each
    stage kernel per level, and the autograd adjoints."""
    _need_cuda()
    shape, level = (12, 10, 9, 7), 2
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(shape)).float()
    gpu = tw.NDDWT("db2", shape, preserve_l2=pl2, device="cuda")
    cpu = tw.NDDWT("db2", shape, preserve_l2=pl2, device="cpu")
    before = dict(ck.launch_counts)
    for a, b in zip(gpu.dec_rec(x.cuda(), level, 0.1), cpu.dec_rec(x, level, 0.1)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
    for name in ("nddwt_lane_dec", "nddwt_lead_dec", "nddwt_lead_adj", "nddwt_lane_adj"):
        assert ck.launch_counts[name] == before[name] + level
    for name in ("nddwt_dec_level", "nddwt_rec_level"):
        assert ck.launch_counts[name] == before[name]
    grads = []
    for plan, dev in ((gpu, "cuda"), (cpu, "cpu")):
        xg = x.to(dev).requires_grad_()
        y = plan.dec(xg, level, band_axis=0)
        (plan.rec(y * y, band_axis=0) ** 2).sum().backward()
        grads.append(xg.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], atol=1e-4, rtol=1e-4)
