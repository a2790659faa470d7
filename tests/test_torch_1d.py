"""The 1D route of the torch port against the JAX package on the CPU, and —
on a CUDA device only — the two 1D level kernels against their plain
versions.

* The port's 1D level loops (``cuda_kernels.dec_levels``/``rec_levels``,
  one ``dec1_level``/``rec1_level`` per level, run on their plain
  versions here) against the JAX package's chunked 1D kernels
  ``pallas_padded.dec_padded1``/``rec_padded1`` in TPU interpret mode, at
  two of ``tests/test_padded.py``'s cases.
* The 1D plan on its kernel route (the device check stubbed) against the
  JAX plan and the float64 oracle at N = K, odd N, bfloat16, float64 and
  complex data; the launch count per level; the autograd adjoints.
* The wrappers' CUDA branches against a stub library.

Tolerances: float32 atol 1e-5 (bands) and 1e-4 (reconstructions), the JAX
kernel tests' own; float64 1e-12; bfloat16 a few bf16 ulps.

JAX is imported by the ``jx`` fixture, not at module level, so that the
CUDA cases also run on a GPU machine without JAX:
``python -m pytest tests/test_torch_1d.py -m cuda --noconftest``.
"""

import contextlib
import ctypes
import types
from functools import partialmethod

import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import oracle
from non_decimated_wavelets_tpu_torch import plan as tplan
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import level_ref
from non_decimated_wavelets_tpu_torch.ops import flat, multi

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    import non_decimated_wavelets_tpu as nw
    from non_decimated_wavelets_tpu.ops import pallas_padded

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, pltpu=pltpu, nw=nw,
                                 pallas_padded=pallas_padded)


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
    """Count the 1D wrappers' calls (what the card launches)."""
    counts = {"dec1_level": 0, "rec1_level": 0, "dec_level": 0, "rec_level": 0}
    for name in counts:
        real = getattr(ck, name)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ck, name, spy)
    return counts


@pytest.mark.parametrize("N,wv,level,pl2", [(5000, "db4", 3, False),
                                            (4096, "db2", 2, True)])
def test_levels_match_padded1(jx, calls, N, wv, level, pl2, rng):
    """``dec_levels``/``rec_levels`` in 1D against ``dec_padded1`` /
    ``rec_padded1``: one ``dec1_level`` and one ``rec1_level`` per level."""
    jp = jx.nw.NDDWT(wavelet=wv, shape=(N,), dtype=jx.jnp.float32, preserve_l2=pl2)
    taps = tuple(np.asarray(t) for t in jp.taps_hp)
    x = rng.standard_normal(N).astype(np.float32)
    with jx.pltpu.force_tpu_interpret_mode():
        y_j = np.asarray(jx.jax.jit(
            lambda v: jx.pallas_padded.dec_padded1(v, taps, level))(x))
        xr_j = np.asarray(jx.jax.jit(
            lambda v: jx.pallas_padded.rec_padded1(v, taps, level, pl2))(y_j))
    y = ck.dec_levels(torch.from_numpy(x), taps, level, stages=False)
    np.testing.assert_allclose(y.numpy(), y_j, atol=1e-5)
    xr = ck.rec_levels(torch.from_numpy(y_j), taps, level, pl2, stages=False)
    np.testing.assert_allclose(xr.numpy(), xr_j, atol=1e-4)
    np.testing.assert_allclose(xr.numpy(), x, atol=1e-4)
    assert calls == {"dec1_level": level, "rec1_level": level, "dec_level": 0,
                     "rec_level": 0}


@pytest.mark.parametrize("N,wv", [(8, "db4"), (77, "db3"), (1031, ("sym4",))])
@pytest.mark.parametrize("pl2", [False, True])
def test_plan_1d_matches_jax_and_oracle(jx, as_cuda, calls, N, wv, pl2, rng):
    """N = K, odd N: the kernel route's ``dec_rec`` with the fused shrink
    against the JAX plan, ``dec`` against the float64 oracle, the round
    trip."""
    level = 3
    jp = jx.nw.NDDWT(wavelet=wv, shape=(N,), preserve_l2=pl2, dtype=jx.jnp.float32)
    tp = tw.NDDWT(wv, (N,), preserve_l2=pl2, device="cpu")
    x = rng.standard_normal(N).astype(np.float32)
    y_j, xr_j = jp.dec_rec(jx.jnp.asarray(x), level, threshold=0.1)
    y_t, xr_t = tp.dec_rec(x, level, threshold=0.1)
    assert calls["dec1_level"] == calls["rec1_level"] == level
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(xr_t.numpy(), np.asarray(xr_j), atol=1e-4)
    y = tp.dec(x, level)
    np.testing.assert_allclose(
        y.numpy(), oracle.dec(x.astype(np.float64), wv, level, pl2), atol=1e-5)
    np.testing.assert_allclose(tp.rec(y).numpy(), x, atol=1e-4)


def test_plan_1d_f64_and_complex(jx, as_cuda, calls, rng):
    """float64 and complex128 on the kernel route to 1e-12 of the JAX plan
    and the oracle; each re/im component through its own chain."""
    N, wv, level = 1000, "db6", 4
    jp = jx.nw.NDDWT(wavelet=wv, shape=(N,), dtype=jx.jnp.float64)
    tp = tw.NDDWT(wv, (N,), dtype="double", device="cpu")
    z = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    for x in (z.real, z):
        y = tp.dec(x, level)
        assert y.dtype == (torch.complex128 if np.iscomplexobj(x) else torch.float64)
        np.testing.assert_allclose(y.numpy(), np.asarray(jp.dec(jx.jnp.asarray(x), level)),
                                   atol=1e-12)
        np.testing.assert_allclose(y.numpy(), oracle.dec(x, wv, level), atol=1e-12)
        np.testing.assert_allclose(tp.rec(y).numpy(), x, atol=1e-12)
    assert calls["dec1_level"] == 3 * level and calls["rec1_level"] == 3 * level


def test_plan_1d_bf16(jx, as_cuda, rng):
    """bfloat16 storage, float32 compute with full-precision taps: within a
    few bf16 ulps of the JAX plan's bands, and a bf16-accurate round trip."""
    N, level = 600, 2
    jp = jx.nw.NDDWT(wavelet="db4", shape=(N,), dtype=jx.jnp.bfloat16)
    tp = tw.NDDWT("db4", (N,), dtype="bf16", device="cpu")
    x = rng.standard_normal(N).astype(np.float32)
    y_j = np.asarray(jp.dec(jx.jnp.asarray(x), level, band_axis=0)).astype(np.float32)
    y_t = tp.dec(x, level, band_axis=0)
    assert y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(y_t.float().numpy(), y_j, atol=4 * 2**-8 * np.abs(y_j).max())
    xr = tp.rec(y_t, band_axis=0)
    assert xr.dtype == torch.bfloat16
    np.testing.assert_allclose(xr.float().numpy(), x, atol=8 * 2**-8 * np.abs(x).max())


@pytest.mark.parametrize("pl2", [False, True])
def test_gradcheck_1d_f64(as_cuda, pl2, rng):
    """Exact adjoints through the 1D level chain (the wrappers' plain
    versions): the backward of dec is the preserve_l2 synthesis, the
    backward of rec the analysis with the transpose scales."""
    N, level = 24, 3
    plan = tw.NDDWT("db2", (N,), preserve_l2=pl2, dtype="float64", device="cpu")
    x = torch.from_numpy(rng.standard_normal(N)).requires_grad_()
    assert torch.autograd.gradcheck(lambda v: plan.dec(v, level, band_axis=0), (x,))
    y = torch.from_numpy(rng.standard_normal((level + 1, N))).requires_grad_()
    assert torch.autograd.gradcheck(lambda v: plan.rec(v, band_axis=0), (y,))


def test_1d_wrappers_check_their_operands():
    taps = tw.NDDWT("db2", (16,), device="cpu").taps_hp
    x, big = torch.zeros(16), torch.zeros(3, 16)
    with pytest.raises(NotImplementedError, match="1D arrays"):
        ck.dec1_level(torch.zeros(4, 4), big, 1, taps)
    with pytest.raises(NotImplementedError, match="1D arrays"):
        ck.rec1_level(torch.zeros(3, 4, 4), None, [("y", 0), ("y", 1)], taps, 0.5)
    with pytest.raises(ValueError, match="needs an approx"):
        ck.rec1_level(big, None, [("a", 0), ("y", 1)], taps, 0.5)
    with pytest.raises(ValueError, match="expected 2 band sources"):
        ck.rec1_level(big, x, [("a", 0)], taps, 0.5)
    a = ck.dec1_level(x, big, 2, taps)  # the plain version's contract
    assert a.shape == (16,) and not big[2].any()


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype,code,ctype", [(torch.float32, 0, ctypes.c_float),
                                              (torch.bfloat16, 1, ctypes.c_float),
                                              (torch.float64, 2, ctypes.c_double)])
def test_1d_cuda_branches_against_a_stub_library(monkeypatch, dtype, code, ctype):
    """The 1D wrappers' CUDA branches, run here against a library stub that
    records each launch: the dtype code, the band pointers, the halo and
    the taps in the compute type (reversed for the synthesis)."""
    launched = []

    class Stub:
        def __getattr__(self, name):
            return lambda *args: launched.append((name, args)) or 0

    monkeypatch.setattr(ck, "load1", lambda: Stub())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    on_card = lambda t: t.as_subclass(_OnCard)  # noqa: E731
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: on_card(empty(*a, **k)))
    before = dict(ck.launch_counts)
    N, level = 40, 3
    taps = tw.NDDWT("db3", (N,), device="cpu").taps_hp
    y = ck.dec_levels(on_card(torch.zeros(N, dtype=dtype)), taps, level, stages=False)
    assert y.shape == (level + 1, N) and y.dtype == dtype
    ck.rec_levels(on_card(y), taps, level, False, stages=False)
    assert [name for name, _ in launched] == (
        ["nddwt_dec1_level"] * level + ["nddwt_rec1_level"] * level)
    item = y.element_size() * N
    for lvl, (_, args) in enumerate(launched[:level]):
        x, detail, out, dt, n, K, left, ptr, lam, _ = args
        assert (dt, n, K, left, lam) == (code, N, 6, 2, 0.0)
        assert detail == y.data_ptr() + (level - lvl) * item
        assert (out == y.data_ptr()) == (lvl == level - 1)
        assert isinstance(ptr, ctypes.POINTER(ctype))
        assert [ptr[i] for i in range(6)] == list(taps[0][0].astype(
            np.float64 if code == 2 else np.float32))
    a, d, out, dt, n, K, left, ptr, scale, _ = launched[level][1]
    assert (a, d) == (y.data_ptr(), y.data_ptr() + item)
    assert (dt, n, K, left, scale) == (code, N, 6, 3, 0.5)
    assert [ptr[i] for i in range(6)] == list(taps[0][0][::-1].astype(
        np.float64 if code == 2 else np.float32))
    assert launched[level + 1][1][1] == y.data_ptr() + 2 * item  # band 2
    for name in ("nddwt_dec1_level", "nddwt_rec1_level"):
        assert ck.launch_counts[name] == before[name] + level


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("N,wv", [(8, "db4"), (54321, "db4"), (4099, "db38")])
def test_cuda_1d_kernels_match_plain_versions(N, wv, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float64: 1e-12}[dt]
    taps = tw.NDDWT(wv, (N,), device="cuda").taps_hp
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N, generator=g, device="cuda").to(dt)

    def close(k, r):
        assert (k.double() - r.double()).abs().max() <= tol * r.double().abs().max()

    for lam in (0.0, 0.1):
        for final in (False, True):
            bk = torch.zeros((3, N), dtype=dt, device="cuda")
            br = bk.clone()
            ak = ck.dec1_level(x, bk, 2, taps, lam, final)
            ar = level_ref.dec_level_ref(x, br, 2, taps, lam, final)
            close(bk, br)
            if not final:
                close(ak, ar)
    y = torch.randn((3, N), generator=g, device="cuda").to(dt)
    for src in ([("y", 0), ("y", 1)], [("a", 0), ("y", 2)]):
        for s in (1.0, 0.5):
            close(ck.rec1_level(y, x, src, taps, s), level_ref.rec_level_ref(y, x, src, taps, s))


@pytest.mark.cuda
def test_cuda_1d_plan_matches_cpu_plan(per_level):
    """The 1D plan on the kernels against the plan on the CPU direct path,
    float32 and float64, with one launch of each 1D kernel per level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    N, level = 54321, 3
    x = np.random.default_rng(2).standard_normal(N)
    for dtype, tol in (("float32", 1e-4), ("float64", 1e-12)):
        gpu = tw.NDDWT("db4", (N,), dtype=dtype, device="cuda")
        cpu = tw.NDDWT("db4", (N,), dtype=dtype, device="cpu")
        before = dict(ck.launch_counts)
        for a, b in zip(gpu.dec_rec(x, level, 0.1), cpu.dec_rec(x, level, 0.1)):
            torch.testing.assert_close(a.cpu(), b, atol=tol, rtol=0)
        for name in ("nddwt_dec1_level", "nddwt_rec1_level"):
            assert ck.launch_counts[name] == before[name] + level
