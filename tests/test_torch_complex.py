"""Complex data and the split-complex transforms of the torch port against
the JAX package on the same seeded inputs (CPU).

Complex ``dec``/``rec``/``dec_rec`` and ``dec_split``/``rec_split``/
``dec_rec_split``, 2D and 3D, db2 and db4, both normalizations. Tolerances,
relative to max|JAX|: float64 1e-12; float32 1e-5 (bands) and 1e-4
(reconstructions), the JAX package's own. The CUDA route (each component
through the level-kernel chain, the joint shrink through
``mag_shrink_pair``) runs here on the kernels' plain versions, by stubbing
the device check as ``tests/test_torch_plan.py`` does.
"""

from functools import partialmethod

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu as nw

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import plan as tplan
from non_decimated_wavelets_tpu_torch.ops import elemwise, flat, multi

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)

TOL = {"float32": (1e-5, 1e-4), "float64": (1e-12, 1e-12)}
CASES = [((12, 10), "db2"), ((12, 10), "db4"), ((8, 10, 12), "db2"),
         ((8, 10, 12), "db4")]
LEVEL = 2
THRESHOLD = 0.3


@pytest.fixture
def as_cuda(monkeypatch):
    """Route every tensor as if it were on a CUDA device, and count the
    joint-magnitude shrinks."""
    monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=True))
    # The per-level route at these small shapes: tests/test_torch_flat.py
    # holds the one-launch flat route, tests/test_torch_multi.py the
    # multilevel one.
    monkeypatch.setattr(flat, "FLAT_MAX_NUMEL", {None: 0})
    monkeypatch.setattr(multi, "MULTI_MAX_NUMEL", 0)
    monkeypatch.setattr(flat, "ITER_MAX_NUMEL", 0)
    calls = []
    real = elemwise.mag_shrink_pair
    monkeypatch.setattr(elemwise, "mag_shrink_pair",
                        lambda *a: calls.append(1) or real(*a))
    return calls


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * np.abs(want).max())


def _plans(shape, wv, pl2, dtype):
    jp = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2, dtype=dtype)
    tp = tw.NDDWT(wv, shape, preserve_l2=pl2, dtype=dtype, device="cpu")
    return jp, tp


def _complex_input(shape, dtype, rng):
    cdt = np.complex64 if dtype == "float32" else np.complex128
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(cdt)


def _check_complex(shape, wv, pl2, dtype, rng):
    jp, tp = _plans(shape, wv, pl2, dtype)
    rel_dec, rel_rec = TOL[dtype]
    x = _complex_input(shape, dtype, rng)
    y_j = np.array(jp.dec(jnp.asarray(x), LEVEL))
    y_t = tp.dec(x, LEVEL)
    assert y_t.dtype == tp.complex_dtype and y_t.shape == y_j.shape
    _close(y_t.numpy(), y_j, rel_dec)
    _close(tp.rec(y_j).numpy(), jp.rec(jnp.asarray(y_j)), rel_rec)
    yb_j, xr_j = jp.dec_rec(jnp.asarray(x), LEVEL, threshold=THRESHOLD, band_axis=0)
    yb_t, xr_t = tp.dec_rec(x, LEVEL, threshold=THRESHOLD, band_axis=0)
    _close(yb_t.numpy(), yb_j, rel_dec)
    _close(xr_t.numpy(), xr_j, rel_rec)


def _check_split(shape, wv, pl2, dtype, rng):
    jp, tp = _plans(shape, wv, pl2, dtype)
    rel_dec, rel_rec = TOL[dtype]
    x = _complex_input(shape, dtype, rng)
    pair = np.stack([x.real, x.imag])
    y_j = np.array(jp.dec_split(jnp.asarray(pair), LEVEL))
    y_t = tp.dec_split(pair, LEVEL)
    assert y_t.dtype == tp.real_dtype and y_t.shape == y_j.shape
    _close(y_t.numpy(), y_j, rel_dec)
    _close(tp.rec_split(y_j).numpy(), jp.rec_split(jnp.asarray(y_j)), rel_rec)
    for thr in (0.0, THRESHOLD):
        yb_j, xr_j = jp.dec_rec_split(jnp.asarray(pair), LEVEL, threshold=thr)
        yb_t, xr_t = tp.dec_rec_split(pair, LEVEL, threshold=thr)
        _close(yb_t.numpy(), yb_j, rel_dec)
        _close(xr_t.numpy(), xr_j, rel_rec)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("pl2", [False, True])
@pytest.mark.parametrize("shape,wv", CASES)
def test_complex_plan_matches_jax(shape, wv, pl2, dtype, rng):
    _check_complex(shape, wv, pl2, dtype, rng)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("pl2", [False, True])
@pytest.mark.parametrize("shape,wv", CASES)
def test_split_plan_matches_jax(shape, wv, pl2, dtype, rng):
    _check_split(shape, wv, pl2, dtype, rng)


@pytest.mark.parametrize("pl2", [False, True])
@pytest.mark.parametrize("shape,wv", CASES)
def test_cuda_route_complex_matches_jax(as_cuda, shape, wv, pl2, rng):
    """The kernel route of complex data: each component's level chain and
    one joint shrink per thresholded ``dec_rec``."""
    _check_complex(shape, wv, pl2, "float32", rng)
    assert len(as_cuda) == 1


@pytest.mark.parametrize("pl2", [False, True])
@pytest.mark.parametrize("shape,wv", CASES)
def test_cuda_route_split_matches_jax(as_cuda, shape, wv, pl2, rng):
    _check_split(shape, wv, pl2, "float32", rng)
    assert len(as_cuda) == 1


def test_complex_and_split_agree(rng):
    """The split pair is the complex transform's re/im parts; a bfloat16
    plan computes complex data in complex64 (with its bfloat16 taps, as the
    JAX plan does); bad pairs raise."""
    shape = (8, 10, 12)
    jp, tp = _plans(shape, "db4", True, jnp.bfloat16)
    assert tp.complex_dtype == torch.complex64
    x = _complex_input(shape, "float32", rng)
    y = tp.dec(x, LEVEL, band_axis=0)
    y_j = np.asarray(jp.dec(jnp.asarray(x), LEVEL, band_axis=0))
    assert y.dtype == torch.complex64 and y_j.dtype == np.complex64
    _close(y.numpy(), y_j, 1e-5)
    _close(tp.rec(y, band_axis=0).numpy(), jp.rec(jnp.asarray(y_j), band_axis=0),
           1e-4)
    tp64 = tw.NDDWT("db4", shape, dtype="float64", device="cpu")
    x = x.astype(np.complex128)
    pair = np.stack([x.real, x.imag])
    y, xr = tp64.dec_rec(x, LEVEL, threshold=THRESHOLD, band_axis=0)
    ys, xs = tp64.dec_rec_split(pair, LEVEL, threshold=THRESHOLD)
    torch.testing.assert_close(ys, torch.stack([y.real, y.imag]), atol=1e-13, rtol=0)
    torch.testing.assert_close(xs, torch.stack([xr.real, xr.imag]), atol=1e-13, rtol=0)
    with pytest.raises(ValueError, match="split re/im"):
        tp64.dec_split(pair[:1], LEVEL)
    with pytest.raises(ValueError, match="real and imaginary"):
        tp64.dec_split(np.stack([x, x]), LEVEL)
    with pytest.raises(ValueError, match="split band array"):
        tp64.rec_split(ys[0])
    with pytest.raises(ValueError, match="threshold"):
        tp64.dec_rec_split(pair, LEVEL, threshold=-1.0)
