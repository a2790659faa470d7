"""The one-launch route of the torch port against the JAX package on the
CPU, and — on a CUDA device only — the two one-launch kernels against their
plain versions.

* The kernels' plain versions (``ops/flat_ref.py``, what the wrappers of
  ``ops/flat.py`` run for a CPU tensor) against the JAX package's flat
  kernels (``pallas_flat``) in TPU interpret mode: dec, rec and pair at
  four of ``tests/test_pallas.py``'s ``CASES_FLAT`` (1D to 4D), the split
  pair with the joint-magnitude shrink, the chain and both FISTA solves;
  and against the resident kernels (``pallas_resident``) at their test
  shapes, which the flat kernel serves in its dec, pair and rec modes.
* The plan on its kernel route (the device check stubbed), built from the
  JAX plan with ``convert.plan_from_jax``, against the JAX plan on the CPU:
  ``dec_rec_n`` and the one-launch FISTA solves (one ``nddwt_flat_iter``
  each and nothing else), dec/rec/dec_rec and their split and complex
  forms (one ``nddwt_flat_pair`` each), 5D plans, and the per-level route
  beyond the size limit.
* The wrappers' CUDA branches against a stub library.

Tolerances: float32 atol 1e-5 (bands) and 1e-4 (reconstructions), 2e-3 for
the FISTA solves (``tests/test_pallas.py:541,555,579,606``, the JAX tests'
own); float64 1e-12, 1e-10 for the solves.

JAX is imported by the ``jx`` fixture, not at module level, so that the
CUDA cases also run on a GPU machine without JAX:
``python -m pytest tests/test_torch_flat.py -m cuda --noconftest``.
"""

import contextlib
import ctypes
import types
from functools import partialmethod

import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import convert
from non_decimated_wavelets_tpu_torch import plan as tplan
from non_decimated_wavelets_tpu_torch.models import cs_recon
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import elemwise, flat, flat_ref, multi

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    import non_decimated_wavelets_tpu as nw
    from non_decimated_wavelets_tpu.models import cs_recon as jcs
    from non_decimated_wavelets_tpu.ops import pallas_flat, pallas_resident

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, pltpu=pltpu, nw=nw,
                                 jcs=jcs, pallas_flat=pallas_flat,
                                 pallas_resident=pallas_resident)


@pytest.fixture
def as_cuda(monkeypatch):
    """Route every tensor as if it were on a CUDA device: the plan takes
    the kernel route, whose wrappers run their plain versions here."""
    monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=True))


@pytest.fixture
def calls(monkeypatch):
    """Count what the card would launch: the flat wrappers' launches and
    the per-level and elementwise wrappers' calls."""
    counts = {"pair": 0, "iter": 0, "levels": 0, "elemwise": 0}

    def spy(module, name, key):
        real = getattr(module, name)

        def wrapped(*a, **k):
            counts[key] += 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    spy(flat, "_call", "pair")
    spy(flat, "_call_iter", "iter")
    for name in ("dec_level", "rec_level", "dec1_level", "rec1_level",
                 "lane_dec", "lead_dec", "lead_adj", "lane_adj"):
        spy(ck, name, "levels")
    for name in ("mag_shrink_pair", "fista_step"):
        spy(elemwise, name, "elemwise")
    return counts


def _jax_plan(jx, wv, shape, pl2=False, dtype="float32"):
    return jx.nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2,
                       dtype=getattr(jx.jnp, dtype))


def _port_plan(jp):
    return convert.plan_from_jax(jp.to_config(),
                                 tuple(np.asarray(t) for t in jp.taps_hp),
                                 device="cpu")


def _taps(jp):
    return tuple(np.asarray(t) for t in jp.taps_hp)


# ------------------------------------------ plain versions vs pallas_flat

CASES = [  # a subset of tests/test_pallas.py's CASES_FLAT
    ((54,), "db4", 3, False),
    ((26, 26), ("db1", "db3"), 2, True),
    ((24, 18, 10), ("db2", "db3", "db2"), 2, False),
    ((14, 10, 6, 6), "db1", 2, True),
]


@pytest.mark.parametrize("shape,wv,level,pl2", CASES)
def test_pair_ref_matches_pallas_flat(jx, shape, wv, level, pl2, rng):
    """dec, rec and pair (details shrunk by 0.1) of the plain version
    against ``dec_flat``/``rec_flat``/``pair_flat`` in interpret mode."""
    taps = _taps(_jax_plan(jx, wv, shape))
    x = rng.standard_normal(shape).astype(np.float32)
    with jx.pltpu.force_tpu_interpret_mode():
        y_j = np.asarray(jx.pallas_flat.dec_flat(jx.jnp.asarray(x), taps, level))
        xr_j = np.asarray(jx.pallas_flat.rec_flat(jx.jnp.asarray(y_j), taps,
                                                  level, pl2))
        yp_j, xp_j = jx.pallas_flat.pair_flat(jx.jnp.asarray(x), taps, level,
                                              pl2, 0.1)
    xt = torch.from_numpy(x)
    y = flat.dec_flat(xt, taps, level)
    np.testing.assert_allclose(y.numpy(), y_j, atol=1e-5)
    np.testing.assert_allclose(flat.rec_flat(torch.from_numpy(y_j), taps, level,
                                             pl2).numpy(), xr_j, atol=1e-4)
    yp, xp = flat.pair_flat(xt, taps, level, pl2, 0.1)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yp_j), atol=1e-5)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xp_j), atol=1e-4)


def test_pair_split_ref_matches_pallas_flat(jx, rng):
    """The split pair's joint-magnitude shrink: ``pair_split_flat``."""
    shape, wv, level = (26, 26), ("db1", "db3"), 2
    taps = _taps(_jax_plan(jx, wv, shape))
    x = rng.standard_normal((2,) + shape).astype(np.float32)
    with jx.pltpu.force_tpu_interpret_mode():
        y_j, xr_j = jx.pallas_flat.pair_split_flat(jx.jnp.asarray(x), taps,
                                                   level, True, 0.3)
    y, xr = flat.pair_split_flat(torch.from_numpy(x), taps, level, True, 0.3)
    assert y.shape == (2, 7) + shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(xr.numpy(), np.asarray(xr_j), atol=1e-4)
    y0 = flat.dec_split_flat(torch.from_numpy(x), taps, level)
    np.testing.assert_allclose(
        flat.rec_split_flat(y0, taps, level, False).numpy(), x, atol=1e-4)


def test_chain_ref_matches_pallas_flat(jx, rng):
    """Three sweeps with a varying threshold: ``chain_flat``."""
    shape, level, lams = (22, 30), 2, (0.3, 0.12, 0.05)
    taps = _taps(_jax_plan(jx, "db2", shape))
    x = rng.standard_normal(shape).astype(np.float32)
    with jx.pltpu.force_tpu_interpret_mode():
        xr_j = jx.pallas_flat.chain_flat(jx.jnp.asarray(x), taps, level, False,
                                         lams)
    xr = flat.chain_flat(torch.from_numpy(x), taps, level, False, lams)
    np.testing.assert_allclose(xr.numpy(), np.asarray(xr_j), atol=1e-4)


@pytest.mark.parametrize("split", [False, True])
def test_fista_ref_matches_pallas_flat(jx, split, rng):
    """The whole solve: ``fista_flat`` at (40, 40), 12 iterations;
    ``fista_split_flat`` at (32, 32), 10 (db2 L2, preserve_l2)."""
    n, iters = (32, 10) if split else (40, 12)
    shape = (n, n)
    jp = _jax_plan(jx, "db2", shape, pl2=True)
    taps = _taps(jp)
    mask = (rng.random(shape) < 0.6).astype(np.float32)
    x = rng.standard_normal(((2,) if split else ()) + shape)
    b = (mask * x).astype(np.float32)
    lams, moms = cs_recon._fista_schedule(iters, 0.05, 1.0)
    run = jx.pallas_flat.fista_split_flat if split else jx.pallas_flat.fista_flat
    with jx.pltpu.force_tpu_interpret_mode():
        xr_j = run(jx.jnp.asarray(b), jx.jnp.asarray(mask), taps, 2, True, lams,
                   moms, 1.0)
    port = flat.fista_split_flat if split else flat.fista_flat
    xr = port(torch.from_numpy(b), torch.from_numpy(mask), taps, 2, True, lams,
              moms, 1.0)
    np.testing.assert_allclose(xr.numpy(), np.asarray(xr_j), atol=2e-3)


# --------------------------------------- plain versions vs pallas_resident


@pytest.mark.parametrize("shape,wv,level", [((1024,), "db4", 3),
                                            ((64, 128), ("db3", "db5"), 2)])
def test_pair_ref_matches_pallas_resident(jx, shape, wv, level, rng):
    """The flat kernel's dec, pair and rec modes compute the resident
    kernels' functions: ``dec_resident``, ``pair_resident`` (shrink 0.1,
    preserve_l2) and ``rec_resident``."""
    taps = _taps(_jax_plan(jx, wv, shape))
    x = rng.standard_normal(shape).astype(np.float32)
    with jx.pltpu.force_tpu_interpret_mode():
        y_j = np.asarray(jx.pallas_resident.dec_resident(jx.jnp.asarray(x),
                                                         taps, level))
        yp_j, xp_j = jx.pallas_resident.pair_resident(jx.jnp.asarray(x), taps,
                                                      level, True, 0.1)
        xr_j = np.asarray(jx.pallas_resident.rec_resident(jx.jnp.asarray(y_j),
                                                          taps, level, False))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(flat.dec_flat(xt, taps, level).numpy(), y_j,
                               atol=1e-5)
    yp, xp = flat.pair_flat(xt, taps, level, True, 0.1)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yp_j), atol=1e-5)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xp_j), atol=1e-4)
    np.testing.assert_allclose(
        flat.rec_flat(torch.from_numpy(y_j), taps, level, False).numpy(), xr_j,
        atol=1e-4)


# -------------------------------------------- the plan on its kernel route


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("float64", 1e-12)])
def test_dec_rec_n_one_launch(jx, as_cuda, calls, dtype, tol, rng):
    """``dec_rec_n`` against the JAX plan's loop of ``dec_rec``: one
    ``nddwt_flat_iter`` launch, nothing else."""
    shape, level, lams = (16, 20), 2, [0.2, 0.1, 0.05]
    jp = _jax_plan(jx, "db3", shape, dtype=dtype)
    tp = _port_plan(jp)
    x = rng.standard_normal(shape).astype(dtype)
    got = tp.dec_rec_n(x, level, lams)
    assert calls == {"pair": 0, "iter": 1, "levels": 0, "elemwise": 0}
    want = np.asarray(jp.dec_rec_n(jx.jnp.asarray(x), level, lams))
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    with pytest.raises(ValueError, match="at least one"):
        tp.dec_rec_n(x, level, [])
    with pytest.raises(ValueError, match="threshold"):
        tp.dec_rec_n(x, level, [0.1, -0.1])
    with pytest.raises(ValueError, match="real-only"):
        tp.dec_rec_n(x + 1j * x, level, lams)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-3), ("float64", 1e-10)])
def test_fista_one_launch(jx, as_cuda, calls, split, dtype, tol, rng):
    """``fista_inpaint``/``fista_inpaint_split`` against the JAX solvers on
    the CPU: the whole solve is one ``nddwt_flat_iter`` launch."""
    shape, iters, lam = (24, 20), 10, 0.05
    jp = _jax_plan(jx, "db2", shape, pl2=True, dtype=dtype)
    tp = _port_plan(jp)
    mask = (rng.random(shape) < 0.6).astype(dtype)
    b = (mask * rng.standard_normal(((2,) if split else ()) + shape)).astype(dtype)
    solve_t = cs_recon.fista_inpaint_split if split else cs_recon.fista_inpaint
    solve_j = jx.jcs.fista_inpaint_split if split else jx.jcs.fista_inpaint
    got = solve_t(tp, b, mask, lam, 2, iters)
    assert calls == {"pair": 0, "iter": 1, "levels": 0, "elemwise": 0}
    want = np.asarray(solve_j(jp, jx.jnp.asarray(b), jx.jnp.asarray(mask), lam,
                              level=2, iters=iters))
    np.testing.assert_allclose(got.numpy(), want, atol=tol)


def test_fista_fused_declines(jx, as_cuda, monkeypatch, rng):
    """The solve's route declines the one-launch solve (``iter``) where
    ``nddwt_flat_iter`` does not serve it (complex data, beyond
    ``ITER_MAX_NUMEL``, a CPU tensor), as the JAX plan does; and
    ``_fista_fused`` checks its shapes."""
    tp = _port_plan(_jax_plan(jx, "db2", (16, 16)))
    good = torch.ones(16, 16)
    lams, moms = cs_recon._fista_schedule(2, 0.05, 1.0)

    def route(b, split=False):
        return cs_recon._solve_route(tp, b, 0.05, 1, split)

    assert route(good + 0j) == "flat"  # the generic loop, on the flat kernel
    assert route(torch.stack([good, good]), True) == "iter"
    with pytest.raises(ValueError, match="does not match"):
        tp._fista_fused(good, good, 1, lams, moms, 1.0, split=True)
    with pytest.raises(ValueError, match="mask shape"):
        tp._fista_fused(good, torch.ones(8, 8), 1, lams, moms, 1.0)
    assert route(good) == "iter"
    assert tp._fista_fused(good, good, 1, lams, moms, 1.0).shape == (16, 16)
    monkeypatch.setattr(flat, "ITER_MAX_NUMEL", 255)
    assert route(good) == "stepped"
    monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=False))
    monkeypatch.setattr(flat, "ITER_MAX_NUMEL", 2**20)
    assert route(good) == "direct"


@pytest.mark.parametrize("dtype,tol", [("float32", (1e-5, 1e-4)),
                                       ("float64", (1e-12, 1e-12))])
def test_plan_transforms_one_launch(jx, as_cuda, calls, dtype, tol, rng):
    """dec, rec, dec_rec (real and complex), dec_split, rec_split and
    dec_rec_split against the JAX plan: one ``nddwt_flat_pair`` each."""
    shape, wv, level = (18, 12), ("db2", "db3"), 2
    jp = _jax_plan(jx, wv, shape, pl2=True, dtype=dtype)
    tp = _port_plan(jp)
    atol_y, atol_x = tol
    x = rng.standard_normal(shape).astype(dtype)
    z = x + 1j * rng.standard_normal(shape)
    pair = np.stack([z.real, z.imag]).astype(dtype)
    jnp = jx.jnp
    for data in (x, z):
        y = tp.dec(data, level)
        np.testing.assert_allclose(y.numpy(), np.asarray(jp.dec(jnp.asarray(data), level)),
                                   atol=atol_y)
        np.testing.assert_allclose(tp.rec(y).numpy(), data, atol=atol_x)
        y, xr = tp.dec_rec(data, level, threshold=0.1, band_axis=0)
        y_j, xr_j = jp.dec_rec(jnp.asarray(data), level, threshold=0.1, band_axis=0)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=atol_y)
        np.testing.assert_allclose(xr.numpy(), np.asarray(xr_j), atol=atol_x)
    assert calls == {"pair": 6, "iter": 0, "levels": 0, "elemwise": 0}
    yp = tp.dec_split(pair, level)
    np.testing.assert_allclose(yp.numpy(), np.asarray(jp.dec_split(jnp.asarray(pair), level)),
                               atol=atol_y)
    np.testing.assert_allclose(tp.rec_split(yp).numpy(), pair, atol=atol_x)
    y, xr = tp.dec_rec_split(pair, level, threshold=0.1)
    y_j, xr_j = jp.dec_rec_split(jnp.asarray(pair), level, threshold=0.1)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=atol_y)
    np.testing.assert_allclose(xr.numpy(), np.asarray(xr_j), atol=atol_x)
    assert calls == {"pair": 9, "iter": 0, "levels": 0, "elemwise": 0}


@pytest.mark.parametrize("dtype,tol", [("float32", (1e-5, 1e-4)),
                                       ("float64", (1e-12, 1e-12))])
def test_plan_5d(jx, as_cuda, calls, monkeypatch, dtype, tol, rng):
    """A 5D plan on the kernel route against the JAX plan: dec, rec and
    dec_rec on the flat kernel; beyond its size limit it raises."""
    shape, level = (6, 5, 4, 4, 3), 2
    jp = _jax_plan(jx, "db1", shape, dtype=dtype)
    tp = _port_plan(jp)
    x = rng.standard_normal(shape).astype(dtype)
    y = tp.dec(x, level, band_axis=0)
    assert y.shape == (63,) + shape
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jp.dec(jx.jnp.asarray(x), level, band_axis=0)),
        atol=tol[0])
    np.testing.assert_allclose(tp.rec(y, band_axis=0).numpy(), x, atol=tol[1])
    _, xr = tp.dec_rec(x, level, threshold=0.2)
    _, xr_j = jp.dec_rec(jx.jnp.asarray(x), level, threshold=0.2)
    np.testing.assert_allclose(xr.numpy(), np.asarray(xr_j), atol=tol[1])
    assert calls == {"pair": 3, "iter": 0, "levels": 0, "elemwise": 0}
    monkeypatch.setattr(flat, "FLAT_MAX_NUMEL", {None: 1000})
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        tp.dec(x, level)


def test_per_level_route_beyond_the_limit(as_cuda, calls, monkeypatch, rng):
    """Beyond ``FLAT_MAX_NUMEL`` (a pair counts twice) the per-level route
    runs as before (the multilevel route switched off; tests/test_torch_multi.py
    holds it); the autograd adjoint of the flat route is the same."""
    tp = tw.NDDWT("db2", (16, 16), preserve_l2=True, dtype="double",
                  device="cpu")
    x = torch.from_numpy(rng.standard_normal((16, 16)))
    monkeypatch.setattr(flat, "FLAT_MAX_NUMEL", {None: 256})
    monkeypatch.setattr(multi, "MULTI_MAX_NUMEL", 0)
    tp.dec_rec(x, 2, threshold=0.1)
    assert calls == {"pair": 1, "iter": 0, "levels": 0, "elemwise": 0}
    tp.dec_rec(x + 1j * x, 2, threshold=0.1)  # 512 elements: per level
    assert calls == {"pair": 1, "iter": 0, "levels": 8, "elemwise": 1}
    xg = x.clone().requires_grad_()
    assert torch.autograd.gradcheck(lambda v: tp.dec(v, 2, band_axis=0), (xg,))
    assert calls["pair"] > 1 and calls["levels"] == 8


# ------------------------------------------------ the CUDA branches, stubbed


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype,code,ctype", [(torch.float32, 0, ctypes.c_float),
                                              (torch.bfloat16, 1, ctypes.c_float),
                                              (torch.float64, 2, ctypes.c_double)])
def test_flat_cuda_branches_against_a_stub_library(monkeypatch, dtype, code, ctype):
    """The flat wrappers' CUDA branches against a library stub that records
    each call: mode, pointers, geometry, the taps and schedule on the
    device in the compute type, the scale, the plan last (``_flat_plan``),
    the scratch sized by the library, the launch counts."""
    launched = []

    class Stub:
        def __getattr__(self, name):
            return lambda *args: launched.append((name, args)) or 0

    monkeypatch.setattr(flat, "load", lambda: Stub())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    on_card = lambda t: t.as_subclass(_OnCard)  # noqa: E731
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: on_card(empty(*a, **k)))
    before = dict(ck.launch_counts)
    shape, level = (6, 5, 4), 2
    taps = tw.NDDWT(("db1", "db2", "db1"), shape, device="cpu").taps_hp
    cdt = np.float64 if code == 2 else np.float32
    x = on_card(torch.zeros((2,) + shape, dtype=dtype))
    y, xr = flat.pair_split_flat(x, taps, level, False, 0.25)
    assert y.shape == (2, 15) + shape and xr.shape == (2,) + shape
    assert launched[-2] == ("nddwt_flat_work_words", (3, 2 * 120))
    name, args = launched[-1]
    (mode, px, pb, po, pw, pt, dt, nd, batch, lvl, n, k, lam, scale, _, plan) = args
    assert name == "nddwt_flat_pair" and (mode, dt, nd, batch, lvl) == (2, code, 3, 2, 2)
    assert tuple(plan) == flat._flat_plan(shape, (2, 4, 2), dtype, 2).ints()
    assert (px, pb, po) == (x.data_ptr(), y.data_ptr(), xr.data_ptr())
    assert list(n[:3]) == [6, 5, 4] and list(k[:3]) == [2, 4, 2]
    assert (lam, scale) == (0.25, 1 / 8)
    tp_host = flat._taps_on(taps, dtype, torch.device("cpu"))
    assert tp_host.dtype == (torch.float64 if code == 2 else torch.float32)
    assert np.array_equal(tp_host[1, :, :4].numpy(), taps[1].astype(cdt))
    flat.rec_flat(on_card(torch.zeros((15,) + shape, dtype=dtype)), taps, level, True)
    assert launched[-1][1][0] == 1 and launched[-1][1][3] is not None
    assert launched[-1][1][-3] == 1.0  # preserve_l2: no per-level scale
    flat.dec_flat(on_card(torch.zeros(shape, dtype=dtype)), taps, level)
    assert launched[-1][1][0] == 0 and launched[-1][1][3] is None
    mask = on_card(torch.ones(shape, dtype=dtype))
    flat.fista_split_flat(x, mask, taps, level, True, [0.1, 0.2], [0.0, 0.5], 0.9)
    name, args = launched[-1]
    assert name == "nddwt_flat_iter" and args[0] == 4
    assert args[2] == mask.data_ptr() and args[5] is not None  # mask, z
    assert args[9:14] == (code, 3, 2, 2, 2) and args[-4] == 0.9
    flat.chain_flat(on_card(torch.zeros(shape, dtype=dtype)), taps, level, False, [0.1])
    assert launched[-1][1][0] == 3 and launched[-1][1][2] is None
    assert ck.launch_counts["nddwt_flat_pair"] == before["nddwt_flat_pair"] + 3
    assert ck.launch_counts["nddwt_flat_iter"] == before["nddwt_flat_iter"] + 2


def test_flat_wrappers_check_their_operands():
    taps = tw.NDDWT("db2", (8, 8), device="cpu").taps_hp
    with pytest.raises(ValueError, match="expected"):
        flat.dec_split_flat(torch.zeros(3, 8, 8), taps, 2)
    with pytest.raises(NotImplementedError, match="one filter each"):
        flat.dec_flat(torch.zeros(8, 8, 8), taps, 2)
    with pytest.raises(ValueError, match="at least one sweep"):
        flat.chain_flat(torch.zeros(8, 8), taps, 2, False, [])
    with pytest.raises(ValueError, match="a mask of"):
        flat.fista_flat(torch.zeros(8, 8), torch.zeros(4, 4), taps, 2, True,
                        [0.1], [0.0], 1.0)
    assert flat.flat_supported((8, 8), torch.float64, 2)
    assert not flat.flat_supported((8, 8), torch.int32)
    assert not flat.flat_supported((2,) * 9, torch.float32)
    assert flat.iter_supported((256, 256), torch.float32, 2)


@pytest.mark.parametrize("wv,shape,route", [
    ("db4", (2**20,), "1d"),
    ("db4", (64, 64), None),
    ("db4", (64, 64, 64), None),
    ("db20", (64, 64, 64), "stage"),  # too long for the level kernels' tile
    ("db2", (16, 16, 16, 16), "stage"),
    ("db1", (4,) * 5, None),
])
def test_flat_limit_follows_the_per_level_route(wv, shape, route):
    """The flat kernel's size limit is the one measured against the
    per-level route the array would take otherwise: ``NDDWT.route`` takes
    the flat kernel up to it and not beyond (where 5D and up raise)."""
    limit = flat.FLAT_MAX_NUMEL[route]
    assert flat.flat_limit(route) == limit
    plan = tw.NDDWT(wv, shape, device="cpu")
    assert (plan.route(torch.float32, 2, on_card=True) == "flat") == (np.prod(shape) <= limit)
    side = round(limit ** (1 / len(shape)))
    assert not flat.flat_supported((side + 1,) * len(shape), torch.float32, replaces=route)
    beyond = tw.NDDWT(wv, (side + 1,) * len(shape), device="cpu")
    if len(shape) > 4:
        with pytest.raises(NotImplementedError, match="flat kernel only"):
            beyond.route(torch.float32, 2, on_card=True)
    else:
        assert beyond.route(torch.float32, 2, on_card=True) != "flat"


# --------------------------------------------------------------- on the card


def _close(k, r, dt):
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float64: 1e-12}[dt]
    assert (k.double() - r.double()).abs().max() <= tol * r.double().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("shape,wv,level", [((64, 64), "db2", 2), ((54,), "db4", 3),
                                            ((24, 18, 10), ("db2", "db3", "db2"), 2),
                                            ((12, 10, 8, 6, 5), "db1", 2),
                                            ((8, 8), "db4", 2), ((40, 36), "db4", 3),
                                            ((20, 22), "db10", 2), ((48, 40, 36), "db4", 2),
                                            ((20, 24), "db10", 2)])
def test_cuda_flat_kernels_match_plain_versions(shape, wv, level, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    taps = tw.NDDWT(wv, shape, device="cuda").taps_hp
    g = torch.Generator(device="cuda").manual_seed(0)
    for batch in (0, 2):
        lead = (2,) if batch else ()
        x = torch.randn(lead + shape, generator=g, device="cuda").to(dt)
        for lam in (0.0, 0.1):
            k = flat._call("pair", x, taps, level, True, lam, shape, batch)
            r = flat_ref.flat_pair_ref("pair", x, taps, level, True, lam, batch)
            _close(k[0], r[0], dt)
            _close(k[1], r[1], dt)
        _close(flat._call("rec", r[0], taps, level, False, 0.0, shape, batch),
               flat_ref.flat_pair_ref("rec", r[0], taps, level, False, 0.0, batch), dt)
        mask = (torch.rand(shape, generator=g, device="cuda") < 0.6).to(dt)
        b = (mask * x).to(dt)
        lams, moms = [0.2, 0.1, 0.05], [0.0, 0.3, 0.4]
        _close(flat._call_iter("fista", b, mask, taps, level, True, lams, moms, 1.0,
                               shape, batch),
               flat_ref.flat_iter_ref("fista", b, mask, taps, level, True, lams, moms,
                                      1.0, batch), dt)
        _close(flat._call_iter("chain", x, None, taps, level, True, lams, None, 0.0,
                               shape, batch),
               flat_ref.flat_iter_ref("chain", x, None, taps, level, True, lams, None,
                                      0.0, batch), dt)


@pytest.mark.cuda
def test_cuda_fista_one_launch():
    """A 256^2 split solve on the card: one ``nddwt_flat_iter`` launch,
    within 1e-4 of max of the plain route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from non_decimated_wavelets_tpu_torch.models import fista_inpaint_split

    shape = (256, 256)
    gpu = tw.NDDWT("db4", shape, preserve_l2=True, device="cuda")
    ref = tw.NDDWT("db4", shape, preserve_l2=True, path="direct", device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    mask = (torch.rand(shape, generator=g, device="cuda") < 0.4).float()
    b = mask * torch.randn((2,) + shape, generator=g, device="cuda")
    before = dict(ck.launch_counts)
    got = fista_inpaint_split(gpu, b, mask, 0.05, 3, 10)
    assert {n: ck.launch_counts[n] - before[n] for n in before} == {
        **dict.fromkeys(before, 0), "nddwt_flat_iter": 1}
    want = fista_inpaint_split(ref, b, mask, 0.05, 3, 10)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
