"""The torch port's FISTA solvers against the JAX package's on the same
seeded inputs (CPU).

``fista_cs_mri`` (the JAX package's own CS-MRI case), ``fista_inpaint`` and
``fista_inpaint_split``, on the generic loop of a CPU plan and on the
stepped routes the card takes (``_fista_stepped``/``_split``, whose kernel
calls run their plain versions here). On the CPU the JAX package runs its
generic loop, the same iteration. Tolerances: float64 1e-10; float32 16^3
db4 1e-5 relative to max|JAX| (ten iterations of float32 transforms summed
in another order, and float32 vs float64 momentum coefficients; measured
4e-7).
"""

from functools import partialmethod

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu as nw
from non_decimated_wavelets_tpu import models as jm

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import models as tm
from non_decimated_wavelets_tpu_torch import plan as tplan
from non_decimated_wavelets_tpu_torch.models import cs_recon
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels, elemwise, flat, multi

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)


@pytest.fixture
def calls(monkeypatch):
    """Count the kernel wrappers' calls; on the CPU they run the plain
    versions, so the counts are what the card would launch."""
    counts = {"dec": 0, "rec": 0, "mag": 0, "step": 0}
    for mod, name, key in ((cuda_kernels, "dec_level", "dec"),
                           (cuda_kernels, "rec_level", "rec"),
                           (elemwise, "mag_shrink_pair", "mag"),
                           (elemwise, "fista_step", "step")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _key=key, **k):
            counts[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return counts


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


def _plans(shape, wv, dtype, pl2=True):
    jp = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2, dtype=dtype)
    tp = tw.NDDWT(wv, shape, preserve_l2=pl2, dtype=dtype, device="cpu")
    return jp, tp


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * np.abs(want).max())


def _inpaint_data(shape, dtype, rng, frac=0.6):
    xc = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    mask = (rng.random(shape) < frac).astype(dtype)
    return (mask * xc.real).astype(dtype), (mask * xc.imag).astype(dtype), mask


def test_fista_cs_mri_matches_jax(rng):
    """32^2 db1 L2 float64, 60 iterations (``tests/test_models.py``'s
    undersampled-Fourier case): the same iterates, and the recovery."""
    n = 32
    img = np.zeros((n, n))
    img[8:24, 10:20] = 1.0
    img[12:16, 12:16] = 2.0
    mask = (rng.random((n, n)) < 0.5).astype(np.float64)
    mask[0, 0] = 1.0
    b = mask * np.fft.fftn(img, norm="ortho")
    jp, tp = _plans((n, n), "db1", "double")
    want = np.asarray(jm.fista_cs_mri(jp, jnp.asarray(b), jnp.asarray(mask),
                                      lam=5e-3, level=2, iters=60))
    got = tm.fista_cs_mri(tp, b, mask, lam=5e-3, level=2, iters=60)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)
    zf = np.real(np.fft.ifftn(b, norm="ortho"))
    assert np.linalg.norm(got.real.numpy() - img) < 0.2 * np.linalg.norm(zf - img)


@pytest.mark.parametrize("route", ["generic", "stepped"])
@pytest.mark.parametrize("shape,wv", [((24, 20), "db2"), ((8, 10, 12), "db2")])
def test_fista_inpaint_matches_jax(route, shape, wv, rng):
    """float64: the generic loop of a CPU plan, and ``_fista_stepped`` on
    the kernels' plain versions."""
    re, _, mask = _inpaint_data(shape, np.float64, rng)
    jp, tp = _plans(shape, wv, "double")
    want = jm.fista_inpaint(jp, jnp.asarray(re), jnp.asarray(mask), 0.02,
                            level=2, iters=15)
    if route == "generic":
        got = tm.fista_inpaint(tp, re, mask, 0.02, level=2, iters=15)
    else:
        _, moms = cs_recon._fista_schedule(15, 0.02, 1.0)
        got = cs_recon._fista_stepped(tp, torch.from_numpy(re),
                                      torch.from_numpy(mask), 0.02, 2, moms, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


@pytest.mark.parametrize("route", ["generic", "stepped"])
@pytest.mark.parametrize("shape,wv", [((24, 20), "db2"), ((8, 10, 12), "db2")])
def test_fista_inpaint_split_matches_jax(route, shape, wv, rng):
    """float64 split-complex FISTA, and the complex-data ``fista_inpaint``
    (generic loop, joint-magnitude shrink), which it equals."""
    re, im, mask = _inpaint_data(shape, np.float64, rng)
    pair = np.stack([re, im])
    jp, tp = _plans(shape, wv, "double")
    want = np.asarray(jm.fista_inpaint_split(jp, jnp.asarray(pair),
                                             jnp.asarray(mask), 0.02, level=2,
                                             iters=15))
    if route == "generic":
        got = tm.fista_inpaint_split(tp, pair, mask, 0.02, level=2, iters=15)
    else:
        _, moms = cs_recon._fista_schedule(15, 0.02, 1.0)
        got = cs_recon._fista_stepped_split(tp, torch.from_numpy(pair),
                                            torch.from_numpy(mask), 0.02, 2,
                                            moms, 1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)
    xc = tm.fista_inpaint(tp, re + 1j * im, mask, 0.02, level=2, iters=15)
    np.testing.assert_allclose(np.stack([xc.real.numpy(), xc.imag.numpy()]), want,
                               atol=1e-10)


@pytest.mark.parametrize("solver", ["inpaint", "inpaint_split"])
def test_fista_f32_16cube_db4_matches_jax(as_cuda, calls, solver, rng):
    """16^3 db4 L3 float32, 10 iterations, on the route the card takes
    (stepped, the transforms on the level kernels' plain versions)."""
    shape, level, iters = (16, 16, 16), 3, 10
    re, im, mask = _inpaint_data(shape, np.float32, rng, frac=0.4)
    jp, tp = _plans(shape, "db4", "float32")
    if solver == "inpaint":
        args = (re, mask)
    else:
        args = (np.stack([re, im]), mask)
    jf, tf = getattr(jm, f"fista_{solver}"), getattr(tm, f"fista_{solver}")
    want = jf(jp, *map(jnp.asarray, args), 0.05, level=level, iters=iters)
    got = tf(tp, *args, 0.05, level=level, iters=iters)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)
    assert calls["step"] == iters  # the stepped route


def test_solver_launch_counts(as_cuda, calls, rng):
    """Per iteration on the card's route: inpainting one fused dec_rec
    (L analysis and L synthesis launches) and one fista_step; split
    inpainting twice the transforms, one mag_shrink_pair, one fista_step;
    CS-MRI's complex dec_rec twice the transforms and one mag_shrink_pair.
    A tensor lam takes the generic loop (no fista_step)."""
    shape, level, iters = (8, 10, 12), 2, 3
    re, im, mask = _inpaint_data(shape, np.float32, rng)
    tp = tw.NDDWT("db2", shape, preserve_l2=True, device="cpu")
    runs = {
        "inpaint": lambda lam: tm.fista_inpaint(tp, re, mask, lam, level, iters),
        "split": lambda lam: tm.fista_inpaint_split(tp, np.stack([re, im]), mask,
                                                    lam, level, iters),
        "cs_mri": lambda lam: tm.fista_cs_mri(tp, mask * np.fft.fftn(re), mask,
                                              lam, level, iters),
    }
    L, n = level, iters
    want = {"inpaint": {"dec": L * n, "rec": L * n, "mag": 0, "step": n},
            "split": {"dec": 2 * L * n, "rec": 2 * L * n, "mag": n, "step": n},
            "cs_mri": {"dec": 2 * L * n, "rec": 2 * L * n, "mag": n, "step": 0}}
    for name, run in runs.items():
        calls.update(dict.fromkeys(calls, 0))
        run(0.05)
        assert calls == want[name], name
        calls.update(dict.fromkeys(calls, 0))
        run(torch.tensor(0.05))
        assert calls["step"] == 0 and calls["dec"] == calls["rec"] > 0, name


def test_solvers_refuse_other_transforms():
    with pytest.raises(TypeError, match="queue 1 item 14"):
        tm.fista_inpaint(object(), np.zeros((8, 8)), np.ones((8, 8)), 0.1)
    tp = tw.NDDWT("db2", (8, 8), device="cpu")
    with pytest.raises(ValueError, match="mask shape"):
        tm.fista_inpaint(tp, np.zeros((8, 8)), np.ones((8, 4)), 0.1)
