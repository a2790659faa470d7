"""The benchmark's frozen reference against the JAX package's NumPy oracle
at small shapes. Only this test imports the JAX package; the benchmark
itself never does."""

import numpy as np
import pytest
import torch

from nddwt_bench.reference import nddwt_fft as W
from nddwt_bench.reference import solvers
from nddwt_bench.reference.taps import DAUBECHIES, scaling_taps

oracle = pytest.importorskip("non_decimated_wavelets_tpu.oracle")
jax_filters = pytest.importorskip("non_decimated_wavelets_tpu.filters")

F64 = W.Precision("float64")
CASES = [
    ((32,), "db1", 3, True, False),
    ((30,), "db6", 2, False, True),
    ((12, 10), "db4", 3, True, True),
    ((16, 11), ("db2", "db3"), 2, False, False),
    ((10, 9, 8), "db3", 2, False, False),
    ((9, 10, 8), "db4", 1, True, True),
    ((8, 8, 8), "db2", 3, True, False),
    ((6, 5, 4, 4), "db2", 2, True, False),
]


@pytest.mark.parametrize("p", sorted(DAUBECHIES))
def test_taps_match(p):
    np.testing.assert_allclose(scaling_taps(f"db{p}"), jax_filters.daubechies_taps(p),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("shape,wav,level,pl,cplx", CASES)
def test_dec_rec_match_oracle(shape, wav, level, pl, cplx):
    rng = np.random.default_rng(len(shape) * 100 + level)
    x = rng.standard_normal(shape) + (1j * rng.standard_normal(shape) if cplx else 0)
    bank = W.FilterBank(wav, shape, pl, F64, "cpu")
    y = W.dec(torch.from_numpy(x), bank, level)
    want = oracle.dec(x, wav, level, pl)
    np.testing.assert_allclose(np.moveaxis(y.numpy(), 0, -1), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(W.rec(y, bank).numpy(), oracle.rec(want, wav, pl), rtol=0,
                               atol=1e-12)


def test_batch_axes():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 12, 10)) + 1j * rng.standard_normal((3, 12, 10))
    bank = W.FilterBank("db2", (12, 10), True, F64, "cpu")
    y = W.dec(torch.from_numpy(x), bank, 2)
    for i in range(3):
        np.testing.assert_allclose(np.moveaxis(y[i].numpy(), 0, -1),
                                   oracle.dec(x[i], "db2", 2, True), atol=1e-12)
    np.testing.assert_allclose(W.rec(y, bank).numpy(), x, atol=1e-12)  # tight frame


def test_fista_matches_oracle_loop():
    """The reference FISTA against the same loop written on the oracle."""
    rng = np.random.default_rng(5)
    shape, level, lam, iters = (12, 10, 8), 2, 0.05, 5
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    mask = (rng.random(shape) < 0.4).astype(np.float64)
    b = mask * np.fft.fftn(x, norm="ortho")
    got = solvers.fista_cs_mri(torch.from_numpy(b), torch.from_numpy(mask),
                               W.FilterBank("db2", shape, True, F64, "cpu"), level, lam,
                               iters, 1.0).numpy()

    def prox(v):
        y = oracle.dec(v, "db2", level, True)
        d = y[..., 1:]
        mag = np.abs(d)
        y[..., 1:] = d * np.maximum(mag - lam, 0) / np.maximum(mag, 1e-300)
        return oracle.rec(y, "db2", True)

    xk = np.fft.ifftn(mask * b, norm="ortho")
    z, t = xk, 1.0
    for _ in range(iters):
        t1 = 0.5 * (1 + np.sqrt(1 + 4 * t * t))
        g = np.fft.ifftn(mask * (mask * np.fft.fftn(z, norm="ortho") - b), norm="ortho")
        xn = prox(z - g)
        z = xn + (t - 1) / t1 * (xn - xk)
        xk, t = xn, t1
    np.testing.assert_allclose(got, xk, rtol=0, atol=1e-12)


def test_bfloat16_precision_rounds():
    low = W.Precision("bfloat16")
    x = torch.randn(1000, dtype=torch.float64)
    err = (low.q(x.float()).double() - x).abs().max() / x.abs().max()
    assert 1e-4 < float(err) < 1e-2
    z = torch.complex(torch.randn(10), torch.randn(10))
    assert torch.equal(low.q(z).real, low.q(z.real))
