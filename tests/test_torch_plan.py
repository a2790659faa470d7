"""The torch port's ``NDDWT`` plan, denoising models and JAX-plan
conversion against the JAX package on the same seeded inputs (CPU).

Tolerances: float32 atol 1e-5 (dec) and 1e-4 (rec), float64 1e-12 — the
JAX package's own. The CUDA route of the plan is exercised on the CPU by
stubbing the device check: the kernel wrappers then run their plain
versions, so the level loops, the fused shrink and the autograd wiring of
the CUDA path are all held against JAX here.
"""

import importlib
from functools import partialmethod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import non_decimated_wavelets_tpu as nw
from non_decimated_wavelets_tpu.ops import pallas_kernels

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import convert
from non_decimated_wavelets_tpu_torch import plan as tplan
from non_decimated_wavelets_tpu_torch.ops import flat, multi

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)

# ``models.denoise`` the module, not the function the package re-exports.
jden = importlib.import_module("non_decimated_wavelets_tpu.models.denoise")
tden = importlib.import_module("non_decimated_wavelets_tpu_torch.models.denoise")

TOL = {"float32": (1e-5, 1e-4), "float64": (1e-12, 1e-12)}


@pytest.fixture
def as_cuda(monkeypatch):
    """Route every tensor as if it were on a CUDA device."""
    monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=True))
    # The per-level route at these small shapes: tests/test_torch_flat.py
    # holds the one-launch flat route, tests/test_torch_multi.py the
    # multilevel one.
    monkeypatch.setattr(flat, "FLAT_MAX_NUMEL", {None: 0})
    monkeypatch.setattr(multi, "MULTI_MAX_NUMEL", 0)
    monkeypatch.setattr(flat, "ITER_MAX_NUMEL", 0)


def _check_plan_vs_jax(shape, wv, level, pl2, dtype, rng):
    jp = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2, dtype=dtype)
    tp = tw.NDDWT(wv, shape, preserve_l2=pl2, dtype=dtype, device="cpu")
    atol_dec, atol_rec = TOL[dtype]
    x = rng.standard_normal(shape).astype(dtype)
    y_j = np.array(jp.dec(jnp.asarray(x), level))
    y_t = tp.dec(x, level)
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=atol_dec)
    np.testing.assert_allclose(
        tp.rec(y_j).numpy(), np.asarray(jp.rec(jnp.asarray(y_j))), atol=atol_rec
    )
    yb_j, xr_j = jp.dec_rec(jnp.asarray(x), level, threshold=0.1)
    yb_t, xr_t = tp.dec_rec(x, level, threshold=0.1)
    np.testing.assert_allclose(yb_t.numpy(), np.asarray(yb_j), atol=atol_dec)
    np.testing.assert_allclose(xr_t.numpy(), np.asarray(xr_j), atol=atol_rec)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("pl2", [False, True])
def test_plan_matches_jax(pl2, dtype, rng):
    _check_plan_vs_jax((16, 12, 20), "db4", 3, pl2, dtype, rng)


def test_bf16_plan_matches_jax(rng):
    """bfloat16 storage on the CPU direct path: bf16 bands and
    reconstruction, within a few bf16 ulps (2^-8 relative) of JAX's."""
    shape, level = (16, 12, 20), 2
    jp = nw.NDDWT(wavelet="db4", shape=shape, dtype=jnp.bfloat16)
    tp = tw.NDDWT("db4", shape, dtype="bfloat16", device="cpu")
    x = rng.standard_normal(shape).astype(np.float32)
    y_j = np.asarray(jp.dec(jnp.asarray(x), level, band_axis=0)).astype(np.float32)
    y_t = tp.dec(x, level, band_axis=0)
    assert y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(y_t.float().numpy(), y_j,
                               atol=4 * 2**-8 * np.abs(y_j).max())
    xr = tp.rec(y_t, band_axis=0)
    assert xr.dtype == torch.bfloat16
    np.testing.assert_allclose(xr.float().numpy(), x,
                               atol=8 * 2**-8 * np.abs(x).max())


@pytest.mark.parametrize("pl2", [False, True])
def test_cuda_route_matches_jax(as_cuda, pl2, rng):
    """The kernel route (level loops, fused shrink in dec) of 3D and 2D
    plans, run on the kernels' plain versions."""
    _check_plan_vs_jax((16, 12, 20), "db4", 3, pl2, "float32", rng)
    _check_plan_vs_jax((24, 40), ("db2", "db6"), 3, pl2, "float32", rng)


def test_dec_rec_threshold_matches_jax_dispatch(as_cuda, rng):
    """The fused-shrink iterate against the JAX package's TPU dispatch
    (``_dec_dispatch(lam)`` / ``_rec_dispatch``) in interpret mode."""
    shape, level = (16, 16, 128), 3
    jp = nw.NDDWT(wavelet="db4", shape=shape, dtype=jnp.float32)
    taps_np = tuple(np.asarray(t) for t in jp.taps_hp)
    x = rng.standard_normal(shape).astype(np.float32)

    def pair(v):
        y = pallas_kernels._dec_dispatch(v, taps_np, level, lam=0.1)
        return y, pallas_kernels._rec_dispatch(y, taps_np, level, False)

    with pltpu.force_tpu_interpret_mode():
        y_j, xr_j = jax.jit(pair)(x)
    y_t, xr_t = tw.NDDWT("db4", shape, device="cpu").dec_rec(x, level, 0.1, band_axis=0)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(xr_t.numpy(), np.asarray(xr_j), atol=1e-4)


def test_flagship_step_matches_graft_entry():
    """The 64^3 db4 L3 dec -> soft-threshold -> rec step of
    ``__graft_entry__.entry``, through the port (and through ``denoise``)."""
    import __graft_entry__

    forward, (x,) = __graft_entry__.entry()
    want = np.asarray(forward(x))
    plan = tw.NDDWT("db4", (64, 64, 64), device="cpu")
    xt = torch.from_numpy(np.array(x))
    y = plan.dec(xt, 3, band_axis=0)
    y = torch.cat([y[:1], tden.soft_threshold(y[1:], 0.1)])
    got = plan.rec(y, band_axis=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(tden.denoise(plan, xt, 3, 0.1).numpy(), want,
                               atol=1e-4)


def test_band_axis_and_level_inference(rng):
    shape = (8, 10, 12)
    plan = tw.NDDWT("db2", shape, dtype="float64", device="cpu")
    x = rng.standard_normal(shape)
    y0 = plan.dec(x, 2, band_axis=0)
    y1 = plan.dec(x, 2)
    assert y0.shape == (plan.num_bands(2),) + shape == (15,) + shape
    assert y1.shape == shape + (15,)
    torch.testing.assert_close(y1, y0.movedim(0, -1))
    torch.testing.assert_close(plan.rec(y0, band_axis=0), plan.rec(y1))
    torch.testing.assert_close(plan.rec(y1), torch.from_numpy(x))
    _, xr = plan.dec_rec(x, 2, band_axis=0)
    torch.testing.assert_close(xr, torch.from_numpy(x))
    with pytest.raises(ValueError, match="band_axis"):
        plan.dec(x, 2, band_axis=1)
    with pytest.raises(ValueError, match="not a valid"):
        plan.rec(y0[:14], band_axis=0)
    with pytest.raises(ValueError, match="does not match"):
        plan.dec(x[:4], 2)
    with pytest.raises(ValueError, match="level"):
        plan.dec(x, 0)
    with pytest.raises(ValueError, match="threshold"):
        plan.dec_rec(x, 2, threshold=-1.0)
    with pytest.raises(ValueError, match="precision"):
        tw.NDDWT("db2", shape, dtype="int32", device="cpu")
    with pytest.raises(ValueError, match="shorter"):
        tw.NDDWT("db4", (4, 8), device="cpu")


def test_band_axis_positive_index_matches_jax(rng):
    """``band_axis=plan.ndim``, the band axis's positive index, names the
    band-last layout in ``dec``, ``rec`` and ``dec_rec``, as in the JAX plan
    (JAX ``plan.py:368,383,510``): (16, 16) db2 L2 f64 gives (16, 16, 7)."""
    shape, level = (16, 16), 2
    jp = nw.NDDWT(wavelet="db2", shape=shape, dtype="float64")
    tp = tw.NDDWT("db2", shape, dtype="float64", device="cpu")
    x = rng.standard_normal(shape)
    y_j = np.asarray(jp.dec(jnp.asarray(x), level, band_axis=2))
    y_t = tp.dec(x, level, band_axis=2)
    assert y_t.shape == y_j.shape == (16, 16, 7)
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=1e-12)
    np.testing.assert_allclose(tp.rec(y_t, band_axis=2).numpy(),
                               np.asarray(jp.rec(jnp.asarray(y_j), band_axis=2)),
                               atol=1e-12)
    yb_j, xr_j = jp.dec_rec(jnp.asarray(x), level, threshold=0.1, band_axis=2)
    yb_t, xr_t = tp.dec_rec(x, level, threshold=0.1, band_axis=2)
    np.testing.assert_allclose(yb_t.numpy(), np.asarray(yb_j), atol=1e-12)
    np.testing.assert_allclose(xr_t.numpy(), np.asarray(xr_j), atol=1e-12)
    with pytest.raises(ValueError, match="band_axis"):
        tp.dec(x, level, band_axis=1)


def test_config_round_trip_and_plan_from_jax():
    jp = nw.NDDWT(wavelet=("db2", "sym4", "haar"), shape=(16, 24, 8),
                  preserve_l2=True, dtype=jnp.bfloat16)
    cfg = jp.to_config()
    taps_hp = tuple(np.asarray(t) for t in jp.taps_hp)
    tp = convert.plan_from_jax(cfg, taps_hp, device="cpu")
    assert tp.to_config() == cfg
    assert tp.real_dtype == torch.bfloat16 and tp.device == torch.device("cpu")
    again = tw.NDDWT.from_config(tp.to_config(), device="cpu")
    for a, b in zip(again.taps_hp, taps_hp):
        assert np.array_equal(a, b)
    tampered = (taps_hp[0], np.nextafter(taps_hp[1], 1.0), taps_hp[2])
    with pytest.raises(ValueError, match="differ"):
        convert.plan_from_jax(cfg, tampered, device="cpu")


@pytest.mark.parametrize(
    "shape,dtype,path,match",
    [
        ((4, 4, 4, 4, 4), "float32", "auto", "5D"),
        ((64,), "float32", "auto", "1D"),
        ((8, 8, 8), "float64", "auto", "float64"),
        ((8, 8, 8), "float32", "fft", "fft"),
    ],
)
def test_unported_cuda_cases_raise(as_cuda, monkeypatch, shape, dtype, path, match, rng):
    """5D on CUDA beyond the flat kernel's size (here 0, ``as_cuda``) still
    raises. 1D, float64 and ``path='fft'``, which raised
    before they were ported, now take the 1D kernels, the float64 level
    kernels and the FFT path, and give the CPU direct path's numbers."""
    plan = tw.NDDWT("db2", shape, dtype=dtype, path=path, device="cpu")
    ref = tw.NDDWT("db2", shape, dtype=dtype, path="direct", device="cpu")
    x = rng.standard_normal(shape)
    calls = [lambda p: p.dec(x, 1), lambda p: p.dec_rec(x, 1, 0.1)[1],
             lambda p: p.dec(x + 1j * x, 1), lambda p: p.dec_split(np.stack([x, x]), 1)]
    if match == "5D":
        for call in calls:
            with pytest.raises(NotImplementedError, match=match):
                call(plan)
        return
    routes = []
    for module, name in ((tplan.cuda_kernels, "dec1_level"), (tplan.cuda_kernels, "dec_level"),
                         (tplan.fft_path, "dec_fft")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _f=real, _n=name, **k: routes.append(_n) or _f(*a, **k))
    want = {"1D": "dec1_level", "float64": "dec_level", "fft": "dec_fft"}[match]
    for call in calls:
        routes.clear()
        got = call(plan)
        assert routes and set(routes) == {want}
        tol = 1e-12 if dtype == "float64" else 1e-5
        np.testing.assert_allclose(got.numpy(), call(ref).numpy(), atol=tol)


def test_plans_default_to_the_card():
    """A plan runs on the card unless the caller asks for the CPU: on a
    machine without one, the first use fails loudly instead of running on
    the host."""
    plan = tw.NDDWT("db2", (8, 8))
    assert plan.device.type == "cuda"
    with pytest.raises(ValueError, match="given to a plan on cuda"):
        plan.dec(torch.zeros(8, 8), 1)
    jp = nw.NDDWT(wavelet="db2", shape=(8, 8))
    taps_hp = tuple(np.asarray(t) for t in jp.taps_hp)
    for p in (tw.NDDWT.from_config(plan.to_config()),
              convert.plan_from_jax(jp.to_config(), taps_hp)):
        assert p.device.type == "cuda"


@pytest.mark.parametrize("plan_dev,tensor_dev", [("cpu", "meta"), ("cuda", "cpu")])
def test_tensor_on_another_device_raises(plan_dev, tensor_dev):
    """A tensor is never copied to the plan's device: a CUDA tensor given
    to a CPU plan would otherwise run on the host (the meta device stands
    in for the card here)."""
    shape = (8, 8, 8)
    plan = tw.NDDWT("db2", shape, device=plan_dev)
    x = torch.zeros(shape, device=tensor_dev)
    y = torch.zeros((15,) + shape, device=tensor_dev)
    for call in (lambda: plan.dec(x, 2), lambda: plan.rec(y, band_axis=0),
                 lambda: plan.dec_rec(x, 2, 0.1), lambda: tden.denoise(plan, x, 2, 0.1)):
        with pytest.raises(ValueError, match="given to a plan on"):
            call()


@pytest.mark.parametrize("path", ["direct", "pallas"])
def test_path_picks_the_route(as_cuda, monkeypatch, path, rng):
    """On a (stubbed) CUDA tensor ``'direct'`` runs the torch direct path
    and ``'pallas'`` the kernels (the per-level loops, the route the plan
    names); both match JAX. ``'pallas'`` refuses a tensor the kernels
    cannot take."""
    route = []
    for name in ("dec_levels", "rec_levels"):
        real = getattr(tplan.cuda_kernels, name)
        monkeypatch.setattr(tplan.cuda_kernels, name,
                            lambda *a, _f=real, **k: route.append(1) or _f(*a, **k))
    shape = (16, 12, 20)
    jp = nw.NDDWT(wavelet="db4", shape=shape, dtype=jnp.float32)
    tp = tw.NDDWT("db4", shape, path=path, device="cpu")
    assert tp.route(torch.float32, 3) == ("level" if path == "pallas" else "direct")
    x = rng.standard_normal(shape).astype(np.float32)
    yb_j, xr_j = jp.dec_rec(jnp.asarray(x), 3, threshold=0.1)
    yb_t, xr_t = tp.dec_rec(x, 3, threshold=0.1)
    np.testing.assert_allclose(yb_t.numpy(), np.asarray(yb_j), atol=1e-5)
    np.testing.assert_allclose(xr_t.numpy(), np.asarray(xr_j), atol=1e-4)
    assert len(route) == (2 if path == "pallas" else 0)
    monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=False))
    if path == "pallas":
        with pytest.raises(ValueError, match="path='pallas'"):
            tp.dec(x, 3)
    else:
        np.testing.assert_allclose(tp.dec(x, 3).numpy(), np.asarray(jp.dec(x, 3)),
                                   atol=1e-5)


def test_fused_shrink_has_no_adjoint(as_cuda, rng):
    plan = tw.NDDWT("db2", (8, 8, 8), device="cpu")
    x = torch.from_numpy(rng.standard_normal((8, 8, 8)).astype(np.float32))
    with pytest.raises(RuntimeError, match="no adjoint"):
        plan.dec_rec(x.requires_grad_(), 2, threshold=0.1)


@pytest.mark.parametrize("pl2", [False, True])
def test_gradcheck_f64(pl2, rng):
    """Exact adjoints: the backward of dec is the preserve_l2 synthesis,
    the backward of rec the analysis with the transpose scales."""
    shape, level = (4, 6, 8), 2
    plan = tw.NDDWT("db2", shape, preserve_l2=pl2, dtype="float64", device="cpu")
    x = torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
    # fast_mode (random projections of the Jacobians): the full check runs
    # one backward per output element, 2880 of them, ~10 s per call.
    assert torch.autograd.gradcheck(lambda v: plan.dec(v, level, band_axis=0),
                                    (x,), fast_mode=True)
    y = torch.from_numpy(rng.standard_normal((15,) + shape)).requires_grad_()
    assert torch.autograd.gradcheck(lambda v: plan.rec(v, band_axis=0), (y,),
                                    fast_mode=True)
    assert torch.autograd.gradcheck(lambda v: plan.rec(v), (y.movedim(0, -1),),
                                    fast_mode=True)


def test_thresholds_match_jax(rng):
    y = rng.standard_normal((5, 6, 7))
    for name in ("soft_threshold", "hard_threshold"):
        np.testing.assert_allclose(
            getattr(tden, name)(torch.from_numpy(y), 0.5).numpy(),
            np.asarray(getattr(jden, name)(jnp.asarray(y), 0.5)), atol=1e-15,
        )
    pair = rng.standard_normal((2, 4, 6, 7))
    np.testing.assert_allclose(
        tden.soft_threshold_mag_pair(torch.from_numpy(pair), 0.5).numpy(),
        np.asarray(jden.soft_threshold_mag_pair(jnp.asarray(pair), 0.5)),
        atol=1e-15,
    )
    plan = tw.NDDWT("db2", (6, 7), dtype="float64", device="cpu")
    jp = nw.NDDWT(wavelet="db2", shape=(6, 7), dtype=jnp.float64)
    lam = np.full((1,), 0.3)
    np.testing.assert_allclose(
        tden.denoise(plan, y[0], 2, torch.from_numpy(lam), mode="hard").numpy(),
        np.asarray(jden.denoise(jp, jnp.asarray(y[0]), 2, jnp.asarray(lam),
                                mode="hard")),
        atol=1e-12,
    )
