"""The torch port's batched transforms (``NDDWT.dec_batched``,
``rec_batched``) against the JAX package on the CPU.

* The direct and FFT paths against the JAX plan's (``plan_from_jax``
  carrying the taps across), and per item against the port's own ``dec``,
  as ``tests/test_engine.py:195-222`` holds the JAX plan: db3 L2 float64 at
  (16, 24), N = 3; complex data; the "batch" ``ValueError``.
* The kernel route (the device check stubbed, so the multilevel wrappers
  run their plain versions): one ``dec_multi`` and one ``rec_multi`` for a
  whole batch of 2D or 3D items, real or complex, against the JAX plan's
  ``path='pallas'`` batch in interpret mode (``tests/test_pallas.py:403-414``);
  item by item on ``dec``'s route where the multilevel kernels do not take
  the items.
* ``gradcheck`` of both in float64 on the direct path and on the kernel
  route.

Tolerances: float64 1e-12; float32 1e-5 (bands) and 1e-4 (reconstructions),
the JAX tests' own.
"""

from functools import partialmethod

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import non_decimated_wavelets_tpu as nw
import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import convert
from non_decimated_wavelets_tpu_torch import plan as tplan
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import flat, multi

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)


def _port(jp, device="cpu"):
    return convert.plan_from_jax(jp.to_config(), tuple(np.asarray(t) for t in jp.taps_hp),
                                 device=device)


@pytest.fixture
def routed(monkeypatch):
    """Route every tensor as if it were on a CUDA device; count the
    multilevel launches and the per-item transforms the card would run."""
    monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=True))
    counts = {"dec_multi": 0, "rec_multi": 0, "items": 0}

    def spy(module, name, key, counted=lambda a: True):
        real = getattr(module, name)

        def wrapped(*a, **k):
            counts[key] += counted(a)
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    spy(multi, "dec_multi", "dec_multi")
    spy(multi, "rec_multi", "rec_multi")
    one_item = lambda a: not (len(a) > 3 and a[-1] is True)  # noqa: E731
    spy(tplan.NDDWT, "_dec_bands", "items", one_item)
    spy(tplan.NDDWT, "_rec_bands", "items", one_item)
    return counts


@pytest.mark.parametrize("path", ["direct", "fft"])
def test_batched_matches_jax_and_per_item(path, rng):
    """db3 L2 float64 at (16, 24), N = 3: the batch equals the JAX plan's
    batch and the port's own per-item ``dec``; the synthesis inverts it."""
    shape, N, level = (16, 24), 3, 2
    jp = nw.NDDWT(wavelet="db3", shape=shape, dtype="double", path=path)
    tp = _port(jp)
    x = rng.standard_normal((N,) + shape)
    yb = tp.dec_batched(x, level)
    assert tuple(yb.shape) == (N, tp.num_bands(level)) + shape
    np.testing.assert_allclose(yb.numpy(), np.asarray(jp.dec_batched(x, level)), atol=1e-12)
    for i in range(N):
        np.testing.assert_allclose(yb[i].numpy(), tp.dec(x[i], level, band_axis=0).numpy(),
                                   atol=1e-12)
    xr = tp.rec_batched(yb)
    np.testing.assert_allclose(xr.numpy(), np.asarray(jp.rec_batched(jnp.asarray(yb.numpy()))),
                               atol=1e-12)
    np.testing.assert_allclose(xr.numpy(), x, atol=1e-12)


@pytest.mark.parametrize("path", ["fft", "direct"])
def test_batched_complex_and_errors(path, rng):
    """Complex items round-trip and equal the JAX plan's batch; a missing
    batch axis, a wrong shape or an empty batch raises a ``ValueError``
    naming the batch."""
    shape = (8, 16)
    jp = nw.NDDWT(wavelet="db2", shape=shape, dtype="double", path=path)
    tp = _port(jp)
    xc = rng.standard_normal((2,) + shape) + 1j * rng.standard_normal((2,) + shape)
    y = tp.dec_batched(xc, 2)
    assert y.dtype == torch.complex128
    np.testing.assert_allclose(y.numpy(), np.asarray(jp.dec_batched(xc, 2)), atol=1e-12)
    np.testing.assert_allclose(tp.rec_batched(y).numpy(), xc, atol=1e-12)
    for bad in (lambda: tp.dec_batched(rng.standard_normal(shape), 2),
                lambda: tp.dec_batched(np.zeros((0,) + shape), 2),
                lambda: tp.rec_batched(np.zeros((2, 7, 8, 15))),
                lambda: tp.rec_batched(np.zeros((7,) + shape))):
        with pytest.raises(ValueError, match="batch"):
            bad()
    with pytest.raises(ValueError, match="level must be >= 1"):
        tp.dec_batched(xc, 0)


@pytest.mark.parametrize("shape,wv,level,path", [
    ((16, 128), "db2", 2, "pallas"),  # tests/test_pallas.py:403-414
    ((12, 10, 16), ("db1", "db2", "db3"), 3, "direct"),
])
def test_batched_kernels_match_jax(routed, shape, wv, level, path, rng):
    """On the kernel route a batch of 2D or 3D items is one ``dec_multi``
    and one ``rec_multi``, not a transform per item, and equals the JAX
    plan's batch (``path='pallas'`` in interpret mode, or the direct path)
    in float32, and the JAX direct path's in complex64 (two real components
    an item)."""
    N = 3
    jp = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32, path=path)
    tp = _port(nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32))
    xb = rng.standard_normal((N,) + shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        yj = jp.dec_batched(jnp.asarray(xb), level)
        xj = jp.rec_batched(yj)
    yb = tp.dec_batched(xb, level)
    xr = tp.rec_batched(yb)
    assert routed == {"dec_multi": 1, "rec_multi": 1, "items": 0}
    np.testing.assert_allclose(yb.numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(xr.numpy(), np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(xr.numpy(), xb, atol=1e-4)
    jd = nw.NDDWT(wavelet=wv, shape=shape, dtype=jnp.float32, path="direct")
    xc = xb + 1j * rng.standard_normal((N,) + shape).astype(np.float32)
    yc = tp.dec_batched(xc, level)
    assert yc.dtype == torch.complex64 and routed["dec_multi"] == 2
    np.testing.assert_allclose(yc.numpy(), np.asarray(jd.dec_batched(xc, level)), atol=1e-5)
    np.testing.assert_allclose(tp.rec_batched(yc).numpy(), xc, atol=1e-4)
    assert routed == {"dec_multi": 2, "rec_multi": 2, "items": 0}


@pytest.mark.parametrize("shape,level,within", [
    ((64,), 3, True),  # 1D: the flat kernel item by item
    ((8, 6, 4, 6), 2, True),  # 4D
    ((16, 24), 1, True),  # one level
    ((16, 24), 2, False),  # items above MULTI_MAX_NUMEL: the per-level route
])
def test_batched_kernels_item_by_item(routed, monkeypatch, shape, level, within, rng):
    """Where the multilevel kernels do not take the items, the batch runs
    item by item on ``dec``'s and ``rec``'s own route and equals the
    per-item transforms."""
    if not within:
        monkeypatch.setattr(multi, "MULTI_MAX_NUMEL", 100)
        monkeypatch.setattr(flat, "FLAT_MAX_NUMEL", {None: 0})
    tp = tw.NDDWT("db2", shape, dtype="double", device="cpu")
    x = torch.from_numpy(rng.standard_normal((2,) + shape))
    yb = tp.dec_batched(x, level)
    xr = tp.rec_batched(yb)
    assert routed == {"dec_multi": 0, "rec_multi": 0, "items": 4}
    for i in range(2):
        np.testing.assert_allclose(yb[i].numpy(), tp.dec(x[i], level, band_axis=0).numpy(),
                                   atol=1e-12)
    np.testing.assert_allclose(xr.numpy(), x.numpy(), atol=1e-12)


@pytest.mark.parametrize("kernels", [False, True], ids=["direct", "kernels"])
@pytest.mark.parametrize("pl2", [False, True])
def test_batched_gradcheck(monkeypatch, kernels, pl2, rng):
    """Both are differentiable: their backward is the batched adjoint (the
    synthesis with preserve_l2, and the analysis with the per-level
    ``1/2^d`` redistributed), on the direct path and the kernel route."""
    if kernels:
        monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=True))
    tp = tw.NDDWT("db2", (6, 8), preserve_l2=pl2, dtype="double", device="cpu")
    x = torch.from_numpy(rng.standard_normal((2, 6, 8))).requires_grad_()
    y = torch.from_numpy(rng.standard_normal((2, 7, 6, 8))).requires_grad_()
    assert torch.autograd.gradcheck(lambda v: tp.dec_batched(v, 2), (x,))
    assert torch.autograd.gradcheck(tp.rec_batched, (y,))
    if kernels:
        before = dict(ck.launch_counts)
        tp.dec_batched(x, 2).sum().backward()
        assert ck.launch_counts == before  # CPU tensors: the plain versions
