"""The solvers' elementwise kernels: their plain versions against the JAX
package's Pallas kernels (TPU interpret mode on the CPU) and formulas, the
wrappers' CPU route, and — on a CUDA device only — the CUDA kernels against
their plain versions.

Tolerances: float32 atol 1e-5 against JAX (the JAX package's own for these
kernels, ``tests/test_pallas.py``); on the card 1e-5 (float32) and 1e-2
(bfloat16) relative to max|plain|, float32 sums rounded in another order.

JAX is imported by the ``jx`` fixture, not at module level, so that the
CUDA cases also run on a GPU machine without JAX:
``python -m pytest tests/test_torch_elemwise.py -m cuda --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

from non_decimated_wavelets_tpu_torch.models import soft_threshold_mag_pair
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels, elemwise, elemwise_ref

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    from non_decimated_wavelets_tpu.models.denoise import soft_threshold_mag_pair
    from non_decimated_wavelets_tpu.ops import pallas_elemwise

    return types.SimpleNamespace(jnp=jax.numpy, pltpu=pltpu,
                                 soft_threshold_mag_pair=soft_threshold_mag_pair,
                                 pallas_elemwise=pallas_elemwise)


def _fista_inputs(rng, shape, mask_shape, dtype=np.float32):
    xn, xp, b = (rng.standard_normal(shape).astype(dtype) for _ in range(3))
    mask = (rng.random(mask_shape) < 0.4).astype(dtype)
    return xn, xp, mask, b


@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_mag_shrink_pair_matches_pallas(jx, lam, rng):
    """(2, 8, 16, 16, 16): the per-band numel is a multiple of 1024, as
    the Pallas kernel needs."""
    y = rng.standard_normal((2, 8, 16, 16, 16)).astype(np.float32)
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.pallas_elemwise.mag_shrink_pair(jx.jnp.asarray(y), lam)
    got = elemwise_ref.mag_shrink_pair_ref(torch.from_numpy(y), lam)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(got[:, 0].numpy(), y[:, 0])  # band 0 as is


@pytest.mark.parametrize("split", [False, True])
def test_fista_step_matches_pallas(jx, split, rng):
    """16^3, and a (2, 16^3) split pair whose mask is broadcast over the
    pair axis (the Pallas kernel takes it broadcast out)."""
    sp = (16, 16, 16)
    shape = ((2,) if split else ()) + sp
    xn, xp, mask, b = _fista_inputs(rng, shape, sp)
    mom, step = 0.63, 0.9
    with jx.pltpu.force_tpu_interpret_mode():
        want = jx.pallas_elemwise.fista_step(
            jx.jnp.asarray(xn), jx.jnp.asarray(xp),
            jx.jnp.broadcast_to(jx.jnp.asarray(mask), shape), jx.jnp.asarray(b),
            jx.jnp.float32(mom), step)
    got = elemwise_ref.fista_step_ref(*map(torch.from_numpy, (xn, xp, mask, b)),
                                      mom, step)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_odd_counts_match_jax_formulas(jx, rng):
    """Element counts no multiple of 1024 (the Pallas kernels refuse them):
    the plain versions against the JAX package's formulas, float64."""
    y = rng.standard_normal((2, 5, 7, 9, 11))
    np.testing.assert_allclose(
        elemwise_ref.mag_shrink_pair_ref(torch.from_numpy(y), 0.4).numpy(),
        np.asarray(jx.soft_threshold_mag_pair(jx.jnp.asarray(y), 0.4)),
        atol=1e-15,
    )
    xn, xp, mask, b = _fista_inputs(rng, (2, 7, 9, 11), (7, 9, 11), np.float64)
    z = xn + 0.4 * (xn - xp)
    want = z - 0.8 * (mask * (mask * z - b))
    got = elemwise_ref.fista_step_ref(*map(torch.from_numpy, (xn, xp, mask, b)),
                                      0.4, 0.8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-15)


def test_bf16_computes_in_f32(rng):
    """bfloat16 storage, float32 compute (``_up`` on the TPU): the plain
    versions round the float32 result once."""
    y = torch.from_numpy(rng.standard_normal((2, 3, 6, 10)).astype(np.float32))
    y16 = y.bfloat16()
    got = elemwise_ref.mag_shrink_pair_ref(y16, 0.3)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got, soft_threshold_mag_pair(y16.float(), 0.3).bfloat16(), rtol=0, atol=0)
    xn, xp, mask, b = (t.bfloat16() for t in map(
        torch.from_numpy, _fista_inputs(rng, (6, 10), (6, 10))))
    got = elemwise_ref.fista_step_ref(xn, xp, mask, b, 0.5, 1.0)
    want = elemwise_ref.fista_step_ref(xn.float(), xp.float(), mask.float(),
                                       b.float(), 0.5, 1.0).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_take_the_plain_versions_on_cpu(rng):
    """A CPU tensor runs the plain version and launches nothing."""
    before = dict(cuda_kernels.launch_counts)
    y = torch.from_numpy(rng.standard_normal((2, 4, 5, 6)))
    torch.testing.assert_close(elemwise.mag_shrink_pair(y, 0.2),
                               elemwise_ref.mag_shrink_pair_ref(y, 0.2))
    xn, xp, mask, b = map(torch.from_numpy,
                          _fista_inputs(rng, (2, 5, 6), (5, 6), np.float64))
    torch.testing.assert_close(elemwise.fista_step(xn, xp, mask, b, 0.3, 1.0),
                               elemwise_ref.fista_step_ref(xn, xp, mask, b, 0.3, 1.0))
    assert cuda_kernels.launch_counts == before


# ------------------------------------------------------------- on the card
CARD_CASES = [
    ("float32", (2, 22, 32, 32, 32)),
    ("float32", (2, 15, 24, 40, 72)),
    ("float32", (2, 15, 23, 41, 73)),  # odd count: element-wise accesses
    ("bfloat16", (2, 15, 24, 40, 72)),
    ("bfloat16", (2, 7, 9, 11, 13)),
]


def _card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    return dt, (1e-5 if dt == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", CARD_CASES)
def test_cuda_mag_shrink_pair_matches_plain(dtype, shape):
    dt, tol = _card(dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    y = torch.randn(shape, generator=g, device="cuda").to(dt)
    for lam in (0.0, 0.3):
        before = cuda_kernels.launch_counts["nddwt_mag_shrink_pair"]
        k = elemwise.mag_shrink_pair(y, lam)
        r = elemwise_ref.mag_shrink_pair_ref(y, lam)
        assert cuda_kernels.launch_counts["nddwt_mag_shrink_pair"] == before + 1
        assert k.dtype == dt and k.shape == y.shape
        assert (k.float() - r.float()).abs().max() <= tol * r.float().abs().max()
        assert torch.equal(k[:, 0], y[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", CARD_CASES)
def test_cuda_fista_step_matches_plain(dtype, shape):
    """Same-shape mask, a mask broadcast over the pair axis, and operands
    offset by one element from an aligned base (element-wise accesses)."""
    dt, tol = _card(dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    shape = shape[:1] + shape[2:]
    buf = torch.randn((4,) + shape, generator=g, device="cuda").to(dt)
    xn, xp, b = buf[0], buf[1], buf[2]
    mask = (torch.rand(shape[1:], generator=g, device="cuda") < 0.4).to(dt)
    flat = buf.flatten()[1 : 1 + xn.numel()].view(shape)
    for args in ((xn, xp, mask, b), (xn, xp, mask.expand(shape).contiguous(), b),
                 (flat, xp, mask, b), (xn[0], xp[0], mask, b[0])):
        k = elemwise.fista_step(*args, 0.6, 0.9)
        r = elemwise_ref.fista_step_ref(*args, 0.6, 0.9)
        assert k.dtype == dt and k.shape == args[0].shape
        assert (k.float() - r.float()).abs().max() <= tol * r.float().abs().max()
