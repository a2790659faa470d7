"""The per-level kernels' plain versions and level loops of the torch port
against the JAX package's per-level Pallas chain (TPU interpret mode on the
CPU), and — on a CUDA device only — the CUDA kernels against their plain
versions.

The JAX chain is driven as ``tests/test_pallas.py::test_dec_level_knob_variants``
drives it: ``_fused_dec_level`` / ``_fused_rec_level`` called level by level,
as the tails of ``_dec_dispatch`` / ``_rec_dispatch`` do at shapes above the
one-launch kernels' limit. (48, 48, 128) gives a 3x3 tile grid, so the JAX
side runs interior tiles as well as wrapping ones. Tolerance: float32 atol
1e-5, the JAX kernel tests' own for dec.

JAX is imported by the ``jx`` fixture, not at module level, so that the
CUDA case also runs on a GPU machine without JAX:
``python -m pytest tests/test_torch_level_kernels.py -m cuda --noconftest``.
"""

import types

import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels, flat, level_ref, multi

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)

CASES = [((48, 48, 128), "db4"), ((32, 256), ("db2", "db6"))]
LEVEL = 3


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    import non_decimated_wavelets_tpu as nw
    from non_decimated_wavelets_tpu.ops import direct_path, pallas_kernels

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, pltpu=pltpu, nw=nw, direct_path=direct_path,
        pallas_kernels=pallas_kernels,
    )


def _jax_dec_chain(jx, x, taps_np, lam):
    shape, nb = x.shape, 2 ** x.ndim
    B = nb + (nb - 1) * (LEVEL - 1)
    big = jx.jnp.empty((B,) + shape, x.dtype)
    approx, off = x, B
    for lvl in range(LEVEL):
        off -= nb - 1
        final = lvl == LEVEL - 1
        out = jx.pallas_kernels._fused_dec_level(
            approx, big, off, taps_np, approx_to_big=final, lam=lam
        )
        if final:
            return out
        big, approx = out


def _jax_rec_chain(jx, y, taps_np):
    nb = 2 ** (y.ndim - 1)
    scale = 1.0 / nb
    acc = jx.pallas_kernels._fused_rec_level(
        y, None, [("y", b) for b in range(nb)], taps_np, scale
    )
    pos = nb
    for _ in range(1, LEVEL):
        src = [("a", 0)] + [("y", pos + b - 1) for b in range(1, nb)]
        acc = jx.pallas_kernels._fused_rec_level(y, acc, src, taps_np, scale)
        pos += nb - 1
    return acc


@pytest.mark.parametrize("lam", [0.0, 0.1])
@pytest.mark.parametrize("shape,wv", CASES)
def test_dec_levels_match_jax_chain(jx, shape, wv, lam, rng):
    jplan = jx.nw.NDDWT(wavelet=wv, shape=shape, dtype=jx.jnp.float32)
    taps_np = tuple(np.asarray(t) for t in jplan.taps_hp)
    x = rng.standard_normal(shape).astype(np.float32)
    with jx.pltpu.force_tpu_interpret_mode():
        y_jax = np.asarray(
            jx.jax.jit(lambda v: _jax_dec_chain(jx, v, taps_np, lam))(x)
        )
    plan = tw.NDDWT(wv, shape, device="cpu")
    y = cuda_kernels.dec_levels(torch.from_numpy(x), plan.taps_hp, LEVEL, lam, stages=False)
    assert y.shape == y_jax.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_jax, atol=1e-5)


@pytest.mark.parametrize("shape,wv", CASES)
def test_rec_levels_match_jax_chain(jx, shape, wv, rng):
    jplan = jx.nw.NDDWT(wavelet=wv, shape=shape, dtype=jx.jnp.float32)
    taps_np = tuple(np.asarray(t) for t in jplan.taps_hp)
    x = rng.standard_normal(shape).astype(np.float32)
    y = np.array(jx.direct_path.dec_direct(jx.jnp.asarray(x), jplan.taps, LEVEL))
    with jx.pltpu.force_tpu_interpret_mode():
        x_jax = np.asarray(jx.jax.jit(lambda v: _jax_rec_chain(jx, v, taps_np))(y))
    plan = tw.NDDWT(wv, shape, device="cpu")
    xr = cuda_kernels.rec_levels(torch.from_numpy(y), plan.taps_hp, LEVEL, False,
                                 stages=False)
    np.testing.assert_allclose(xr.numpy(), x_jax, atol=1e-5)
    np.testing.assert_allclose(xr.numpy(), x, atol=1e-4)  # the round trip


def test_level_refs_contract():
    """dec_level_ref writes only its own detail slots (and band 0 when
    final); rec_level_ref reads band 0 from ``approx`` for ("a", 0)."""
    shape, nb = (6, 8, 10), 8
    plan = tw.NDDWT("db2", shape, device="cpu")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    big = torch.full((15,) + shape, 7.0)
    a = level_ref.dec_level_ref(x, big, 8, plan.taps_hp, 0.0, final=False)
    assert a.shape == shape
    assert torch.all(big[:8] == 7.0) and not torch.any(big[8:] == 7.0)
    assert level_ref.dec_level_ref(a, big, 1, plan.taps_hp, 0.0, final=True) is None
    assert not torch.any(big == 7.0)
    y = big
    src = [("a", 0)] + [("y", b) for b in range(1, nb)]
    via_a = level_ref.rec_level_ref(y, y[0] * 2, src, plan.taps_hp, 1.0)
    doubled = y.clone()
    doubled[0] *= 2
    via_y = level_ref.rec_level_ref(
        doubled, None, [("y", b) for b in range(nb)], plan.taps_hp, 1.0
    )
    torch.testing.assert_close(via_a, via_y, rtol=0, atol=0)


@pytest.mark.parametrize(
    "shape,wv",
    [((256, 256, 256), "db4"), ((8, 8, 8), "db4"), ((32, 256), ("db2", "db6")),
     ((64, 64, 64), "db12"), ((40, 40, 40), ("db1", "db3", "sym10"))],
)
@pytest.mark.parametrize("rec", [False, True])
def test_kernel_geometry(shape, wv, rec):
    """The launch geometry the wrappers hand the kernels: the streamed plan
    that ``nddwt_rec_level`` and ``nddwt_dec_level`` take: slot 0 streamed
    ((n0, 1, n1) in 2D), the synthesis's taps reversed with a halo of
    ``K // 2``, the analysis's as given with ``K // 2 - 1``, a plane tile of
    ``256 * items`` and shared memory inside the stream budget (for the
    analysis with the in-plane bands a walk keeps); and the multilevel
    kernels' geometry of one item, which is the same launch's (their units
    are its CTA tiles)."""
    plan = tw.NDDWT(wv, shape, device="cpu")
    n, k, left, bit, pad, arr = cuda_kernels._level_stream_view(
        shape, plan.taps_hp, torch.float32, None, rec)
    t = cuda_kernels._stream_plan(n, k, torch.float32, "rec" if rec else "dec")
    K = list(plan.filter_lengths)
    assert n == (list(shape) if len(shape) == 3 else [shape[0], 1, shape[1]])
    assert k == (K if len(shape) == 3 else [K[0], 1, K[1]])
    assert left == [0 if x == 1 else (x // 2 if rec else x // 2 - 1) for x in k]
    assert not any(pad)
    assert bit == ([0, 1, 2] if len(shape) == 3 else [0, 0, 1])
    for a, x in enumerate(k):
        if x > 1:
            want = plan.taps_hp[a if len(shape) == 3 else a // 2]
            want = want[:, ::-1] if rec else want
            np.testing.assert_array_equal(arr[a, :, :x], want.astype(np.float32))
    items = (cuda_kernels._stream_items(k) if rec
             else cuda_kernels._ana_items(k, torch.float32))
    assert t[1] * t[2] == 256 * items and t[2] & (t[2] - 1) == 0
    assert 1 <= t[0] <= n[0]
    bands = 1 if rec else cuda_kernels._walk_bands(k, t, torch.float32)
    assert (cuda_kernels._stream_smem(k, t, torch.float32, bands=bands)
            <= cuda_kernels._STREAM_SMEM_BUDGET)
    one = multi._multi_geometry(shape, plan.taps_hp, rec, torch.float32, 1)
    assert [list(v) for v in one[:5]] == [n, k, list(t), left, bit]
    np.testing.assert_array_equal(one[5], arr)
    assert one[6] == bands


def test_long_filters_raise_in_3d():
    """Filters longer than an axis of the item: the multilevel kernels take
    no level of it."""
    plan = tw.NDDWT("db15", (32, 32, 32), device="cpu")
    with pytest.raises(NotImplementedError, match="take no level"):
        multi._multi_geometry((32, 32, 28), plan.taps_hp, False, torch.float32, 1)


@pytest.fixture
def per_level(monkeypatch):
    """Hold a plan on the card to the per-level route at a shape within the
    one-launch flat and multilevel kernels' sizes (tests/test_torch_flat.py
    and tests/test_torch_multi.py hold those)."""
    monkeypatch.setattr(flat, "FLAT_MAX_NUMEL", {None: 0})
    monkeypatch.setattr(multi, "MULTI_MAX_NUMEL", 0)
    monkeypatch.setattr(flat, "ITER_MAX_NUMEL", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    tol = 1e-5 if dt == torch.float32 else 1e-2  # relative to max|ref|
    shape, nb, B = (24, 40, 72), 8, 22
    plan = tw.NDDWT("db4", shape, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda").to(dt)
    for lam in (0.0, 0.1):
        for final in (False, True):
            bk = torch.zeros((B,) + shape, dtype=dt, device="cuda")
            br = bk.clone()
            ak = cuda_kernels.dec_level(x, bk, B - 7, plan.taps_hp, lam, final)
            ar = level_ref.dec_level_ref(x, br, B - 7, plan.taps_hp, lam, final)
            scale = br.float().abs().max()
            assert (bk.float() - br.float()).abs().max() <= tol * scale
            if not final:
                assert (ak.float() - ar.float()).abs().max() <= tol * scale
    y = torch.randn((B,) + shape, generator=g, device="cuda").to(dt)
    for src in ([("y", b) for b in range(nb)],
                [("a", 0)] + [("y", 7 + b) for b in range(1, nb)]):
        for s in (1.0, 1.0 / nb):
            k = cuda_kernels.rec_level(y, x, src, plan.taps_hp, s)
            r = level_ref.rec_level_ref(y, x, src, plan.taps_hp, s)
            assert (k.float() - r.float()).abs().max() <= tol * r.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("pl2", [False, True])
def test_cuda_plan_matches_cpu_plan(per_level, pl2):
    """The plan on the kernels against the plan on the CPU direct path:
    ``dec_rec`` with the fused shrink, and the autograd adjoints (the
    backward passes run the kernels too). float32, atol 1e-5 / 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    shape, level = (24, 40, 72), 3
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(shape)).float()
    gpu = tw.NDDWT("db4", shape, preserve_l2=pl2, device="cuda")
    cpu = tw.NDDWT("db4", shape, preserve_l2=pl2, device="cpu")
    counts = dict(cuda_kernels.launch_counts)
    for a, b in zip(gpu.dec_rec(x.cuda(), level, 0.1), cpu.dec_rec(x, level, 0.1)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
    assert cuda_kernels.launch_counts["nddwt_dec_level"] == counts["nddwt_dec_level"] + level
    assert cuda_kernels.launch_counts["nddwt_rec_level"] == counts["nddwt_rec_level"] + level
    # A tensor on the card never runs on a CPU plan, nor the reverse.
    with pytest.raises(ValueError, match="given to a plan on"):
        cpu.dec_rec(x.cuda(), level, 0.1)
    with pytest.raises(ValueError, match="given to a plan on"):
        gpu.dec(x, level)
    grads = []
    for plan, dev in ((gpu, "cuda"), (cpu, "cpu")):
        xg = x.to(dev).requires_grad_()
        y = plan.dec(xg, level, band_axis=0)
        (plan.rec(y * y, band_axis=0) ** 2).sum().backward()
        grads.append(xg.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], atol=1e-4, rtol=1e-4)
