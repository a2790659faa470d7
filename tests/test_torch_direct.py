"""The torch port's direct path against the JAX package's direct path and
the float64 NumPy oracle, on the same seeded inputs: 1D-4D, odd extents,
mixed wavelets, both normalizations.

Tolerances are the JAX package's own: float32 atol 1e-5 for dec and 1e-4
for rec; float64 1e-12, against JAX and against the oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu as nw
from non_decimated_wavelets_tpu import oracle
from non_decimated_wavelets_tpu.ops import direct_path as jdp

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import oracle as to
from non_decimated_wavelets_tpu_torch.ops import direct_path as tdp

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)

CASES = [
    ((37,), "db3", 3),
    ((12, 10), ("db2", "db4"), 2),
    ((9, 8, 11), ("db1", "db2", "db3"), 2),
    ((16, 12, 10), "db4", 3),
    ((6, 5, 8, 7), "db2", 2),
]
TOL = {"float32": (1e-5, 1e-4), "float64": (1e-12, 1e-12)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("pl2", [False, True])
@pytest.mark.parametrize("shape,wv,level", CASES)
def test_direct_matches_jax(shape, wv, level, pl2, dtype, rng):
    jplan = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2, dtype=dtype)
    plan = tw.NDDWT(wv, shape, preserve_l2=pl2, dtype=dtype, device="cpu")
    atol_dec, atol_rec = TOL[dtype]
    x = rng.standard_normal(shape).astype(dtype)
    y_jax = np.array(jdp.dec_direct(jnp.asarray(x), jplan.taps, level))
    y = tdp.dec_direct(torch.from_numpy(x), plan.taps, level)
    assert y.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(y.numpy(), y_jax, atol=atol_dec)
    x_jax = np.asarray(jdp.rec_direct(jnp.asarray(y_jax), jplan.taps, level, pl2))
    xr = tdp.rec_direct(torch.from_numpy(y_jax), plan.taps, level, pl2)
    np.testing.assert_allclose(xr.numpy(), x_jax, atol=atol_rec)
    np.testing.assert_allclose(xr.numpy(), x, atol=atol_rec)  # round trip


@pytest.mark.parametrize("pl2", [False, True])
@pytest.mark.parametrize("shape,wv,level", CASES)
def test_direct_f64_matches_oracle(shape, wv, level, pl2, rng):
    plan = tw.NDDWT(wv, shape, preserve_l2=pl2, dtype="float64", device="cpu")
    x = rng.standard_normal(shape)
    y = tdp.dec_direct(torch.from_numpy(x), plan.taps, level)
    y_ref = oracle.dec(x, wv, level, pl2)
    np.testing.assert_allclose(np.moveaxis(y.numpy(), 0, -1), y_ref, atol=1e-12)
    xr = tdp.rec_direct(y, plan.taps, level, pl2)
    x_ref = oracle.rec(y_ref, wv, pl2)
    np.testing.assert_allclose(xr.numpy(), x_ref, atol=1e-12)


@pytest.mark.parametrize("pl2", [False, True])
@pytest.mark.parametrize("shape,wv,level", CASES)
def test_port_oracle_is_jax_oracle(shape, wv, level, pl2, rng):
    """The port's NumPy oracle (the float64 anchor ``chip_smoke.py`` uses)
    gives the JAX package's oracle bit for bit."""
    x = rng.standard_normal(shape)
    y = to.dec(x, wv, level, pl2)
    np.testing.assert_array_equal(y, oracle.dec(x, wv, level, pl2))
    np.testing.assert_array_equal(to.rec(y, wv, pl2), oracle.rec(y, wv, pl2))


def test_rec_passes_extra_dims_through(rng):
    """Extra dims between the band axis and the spatial axes ride along
    (the split-complex and batched callers of the JAX package)."""
    shape, level = (10, 12), 2
    plan = tw.NDDWT("db2", shape, dtype="float64", device="cpu")
    x = torch.from_numpy(rng.standard_normal((3,) + shape))
    y = tdp.dec_direct(x, plan.taps, level)
    assert y.shape == (7, 3) + shape
    xr = tdp.rec_direct(y, plan.taps, level, False)
    torch.testing.assert_close(xr, x, atol=1e-12, rtol=0)
    torch.testing.assert_close(y[:, 1], tdp.dec_direct(x[1], plan.taps, level))
