"""float64 and the FFT path of the torch port against the JAX package on the
CPU, the closure of the TPU's ragged kernels, and — on a CUDA device only —
the float64 kernels against their plain versions.

* The float64 level loops (``cuda_kernels.dec_levels``/``rec_levels`` on
  the per-level kernels' plain versions) against the JAX package's
  double-f32 kernels ``pallas_df32.dec64``/``rec64`` in TPU interpret mode,
  at float32 tolerance: XLA:CPU folds those kernels' compensation terms
  (``tests/test_df32.py``), so interpret mode holds their structure only;
  the 1e-12 contract is held against the oracle.
* The float64 plan on its kernel route (the device check stubbed, so the
  wrappers run their plain versions) against the JAX float64 plan and the
  oracle at 1e-12: 2D, 3D, complex128, 4D and the 3D db20 stage route.
* ``path='fft'`` against the JAX FFT path: float64 1e-12, float32 1e-5.
* The per-level and stage routes at the shapes of ``tests/test_ragged.py``
  against ``pallas_ragged.dec_ragged``/``rec_ragged`` in interpret mode:
  the port's wrapping kernels serve the ragged kernels' shape class.
* The wrappers' CUDA branches against a stub library: the float64 dtype
  code and taps of the compute type.

JAX is imported by the ``jx`` fixture, not at module level, so that the
CUDA cases also run on a GPU machine without JAX:
``python -m pytest tests/test_torch_f64.py -m cuda --noconftest``.
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
from non_decimated_wavelets_tpu_torch.ops import elemwise, elemwise_ref, level4_ref
from non_decimated_wavelets_tpu_torch.ops import level_ref
from non_decimated_wavelets_tpu_torch.ops import flat, multi

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)

LEVEL_NAMES = ("dec_level", "rec_level", "lane_dec", "lead_dec", "lead_adj",
               "lane_adj")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    import non_decimated_wavelets_tpu as nw
    from non_decimated_wavelets_tpu.ops import pallas_df32, pallas_ragged

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, pltpu=pltpu, nw=nw,
                                 pallas_df32=pallas_df32,
                                 pallas_ragged=pallas_ragged)


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
def calls(monkeypatch):
    """Count the level and stage wrappers' calls (what the card launches)."""
    counts = dict.fromkeys(LEVEL_NAMES, 0)
    for name in LEVEL_NAMES:
        real = getattr(ck, name)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ck, name, spy)
    return counts


def _interpret(jx, fn, *args, jit=True):
    with jx.pltpu.force_tpu_interpret_mode():
        return np.asarray((jx.jax.jit(fn) if jit else fn)(*args))


@pytest.mark.parametrize("shape,wv,level,pl2",
                         [((8, 8, 128), "db2", 1, False), ((16, 128), "db6", 2, True)])
def test_f64_levels_match_df32(jx, shape, wv, level, pl2, rng):
    """``dec_levels``/``rec_levels`` in float64 against ``dec64``/``rec64``
    (float32 tolerance, see the module docstring) and the oracle (1e-12)."""
    jp = jx.nw.NDDWT(wavelet=wv, shape=shape, dtype=jx.jnp.float64, path="direct",
                     preserve_l2=pl2)
    x = rng.standard_normal(shape)
    # dec64/rec64 ride linear_call, whose ordered-io effect cannot be jitted
    # in interpret mode (tests/test_df32.py calls them eagerly too).
    y_j = _interpret(jx, lambda v: jx.pallas_df32.dec64(v, jp.taps_hp, level), x, jit=False)
    xr_j = _interpret(jx, lambda v: jx.pallas_df32.rec64(v, jp.taps_hp, level, pl2), y_j,
                      jit=False)
    y = ck.dec_levels(torch.from_numpy(x), jp.taps_hp, level, stages=False)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), y_j, atol=1e-5)
    xr = ck.rec_levels(y, jp.taps_hp, level, pl2, stages=False)
    np.testing.assert_allclose(xr.numpy(), xr_j, atol=1e-5)
    gold = np.moveaxis(oracle.dec(x, wv, level, pl2), -1, 0)
    np.testing.assert_allclose(y.numpy(), gold, atol=1e-12)
    np.testing.assert_allclose(xr.numpy(), x, atol=1e-12)


@pytest.mark.parametrize(
    "shape,wv,level,stages",
    [((12, 10, 9), ("db1", "db2", "db3"), 2, False), ((24, 18), ("db2", "db6"), 3, False),
     ((6, 6, 5, 7), "db2", 2, True), ((40, 41, 42), "db20", 1, True)],
)
@pytest.mark.parametrize("pl2", [False, True])
def test_f64_plan_matches_jax_and_oracle(jx, as_cuda, calls, shape, wv, level,
                                         stages, pl2, rng):
    """The float64 kernel route (per-level kernels in 2D and 3D, stage
    kernels in 4D and for 3D db20) against the JAX float64 plan and the
    oracle at 1e-12: real and complex128 data, ``dec_rec`` with the fused
    shrink (the joint shrink on complex data)."""
    jp = jx.nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2, dtype=jx.jnp.float64)
    tp = tw.NDDWT(wv, shape, preserve_l2=pl2, dtype="double", device="cpu")
    assert ck.stage_route(shape, tp.taps_hp, torch.float64) is stages
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    for x in (z.real.copy(), z):
        y = tp.dec(x, level)
        assert y.dtype == (torch.complex128 if np.iscomplexobj(x) else torch.float64)
        np.testing.assert_allclose(y.numpy(), oracle.dec(x, wv, level, pl2), atol=1e-12)
        # the oracle's synthesis, not x: db20's taps reconstruct to ~1e-7
        np.testing.assert_allclose(tp.rec(y).numpy(), oracle.rec(y.numpy(), wv, pl2),
                                   atol=1e-12)
        y_j, xr_j = jp.dec_rec(jx.jnp.asarray(x), level, threshold=0.3)
        y_t, xr_t = tp.dec_rec(x, level, threshold=0.3)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-12)
        np.testing.assert_allclose(xr_t.numpy(), np.asarray(xr_j), atol=1e-12)
    per_pass = {n: 0 for n in LEVEL_NAMES}
    for name in (LEVEL_NAMES[2:] if stages else LEVEL_NAMES[:2]):
        per_pass[name] = 6 * level  # real: 2 passes; complex: 2 x 2 passes
    assert calls == per_pass


@pytest.mark.parametrize("dtype,tol,rec_tol", [("float64", 1e-12, 1e-12),
                                               ("float32", 1e-5, 1e-4)])
@pytest.mark.parametrize("shape,wv", [((54,), "db4"), ((20, 18), ("db1", "db3")),
                                      ((10, 12, 8), "db2"), ((8, 8, 6, 6), "db2")])
def test_fft_path_matches_jax(jx, as_cuda, calls, shape, wv, dtype, tol, rec_tol, rng):
    """``path='fft'`` takes the FFT path on any device (here with the device
    check stubbed: no kernel runs) and matches the JAX FFT path: real,
    complex and split data."""
    level = 2
    jp = jx.nw.NDDWT(wavelet=wv, shape=shape, dtype=dtype, path="fft", preserve_l2=True)
    tp = tw.NDDWT(wv, shape, dtype=dtype, path="fft", preserve_l2=True, device="cpu")
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    cdt = np.complex128 if dtype == "float64" else np.complex64
    for x in (z.real.astype(dtype), z.astype(cdt)):
        y = tp.dec(x, level)
        y_j = np.asarray(jp.dec(jx.jnp.asarray(x), level))
        assert y.numpy().dtype == y_j.dtype
        np.testing.assert_allclose(y.numpy(), y_j, atol=tol)
        np.testing.assert_allclose(tp.rec(y).numpy(), np.asarray(jp.rec(y_j)), atol=rec_tol)
    pair = np.stack([z.real, z.imag]).astype(dtype)
    yp = tp.dec_split(pair, level)
    np.testing.assert_allclose(yp.numpy(), np.asarray(jp.dec_split(jx.jnp.asarray(pair), level)),
                               atol=tol)
    np.testing.assert_allclose(tp.rec_split(yp).numpy(), pair, atol=rec_tol)
    assert not any(calls.values())


@pytest.mark.parametrize("shape,wv,level", [((41, 16, 10), "db2", 2), ((19, 257), "db4", 1),
                                            ((20, 12, 10), ("db1", "db2", "db3"), 2),
                                            ((10, 6, 4, 6), "db2", 2)])
def test_levels_serve_the_ragged_shapes(jx, calls, shape, wv, level, rng):
    """The TPU's ragged kernels exist for odd mid-size 2D/3D shapes
    (``pallas_ragged``, the cases of ``tests/test_ragged.py``); the port's
    per-level kernels (stage kernels in 4D) wrap every index and serve the
    same class: their level loops match ``dec_ragged`` (with the fused
    shrink) and ``rec_ragged`` in interpret mode. (The multilevel kernels,
    which run the same tiles, are held in tests/test_torch_multi.py.)"""
    jp = jx.nw.NDDWT(wavelet=wv, shape=shape, dtype=jx.jnp.float32)
    taps = tuple(np.asarray(t) for t in jp.taps_hp)
    x = rng.standard_normal(shape).astype(np.float32)
    y_j = _interpret(jx, lambda v: jx.pallas_ragged.dec_ragged(v, taps, level, 0.1), x)
    y = ck.dec_levels(torch.from_numpy(x), taps, level, 0.1, stages=len(shape) == 4)
    np.testing.assert_allclose(y.numpy(), y_j, atol=1e-5)
    pl2 = len(shape) % 2 == 0
    xr_j = _interpret(jx, lambda v: jx.pallas_ragged.rec_ragged(v, taps, level, pl2), y_j)
    xr = ck.rec_levels(torch.from_numpy(y_j.copy()), taps, level, pl2,
                       stages=len(shape) == 4).numpy()
    np.testing.assert_allclose(xr, xr_j, atol=1e-5 * np.abs(xr_j).max())
    kernels = LEVEL_NAMES[2:] if len(shape) == 4 else LEVEL_NAMES[:2]
    assert all(calls[n] == (level if n in kernels else 0) for n in LEVEL_NAMES)


def test_f64_tiles_and_stage_route():
    """A float64 level picks its route at 8 bytes a word: shorter 3D filters
    take the stage kernels; the streamed analysis keeps a ring of 8-byte words, so it
    takes one plane element a thread at db4 (two in float32) and all four
    in-plane bands a walk, within the stream budget."""
    shape = (256, 256, 256)
    taps = tw.NDDWT("db4", shape, device="cpu").taps_hp
    n, k, left, bit, pad, arr = ck._level_stream_view(shape, taps, torch.float64, None, False)
    t, t32 = (ck._stream_plan(n, k, dt, "dec") for dt in (torch.float64, torch.float32))
    assert arr.dtype == np.float64 and left == [3, 3, 3]
    assert t[1] * t[2] == 256 and t32[1] * t32[2] == 512
    assert ck._walk_bands(k, t, torch.float64) == 4
    assert ck._stream_smem(k, t, torch.float64, bands=4) <= ck._STREAM_SMEM_BUDGET
    long = tw.NDDWT("db12", (64, 64, 64), device="cpu").taps_hp
    assert not ck.stage_route((64, 64, 64), long, torch.float32)
    assert ck.stage_route((64, 64, 64), long, torch.float64)
    for lane, adj in ((True, False), (False, True)):
        (n, k, t, left, arr), _ = ck._stage_geometry((16, 16, 8, 16), taps + taps[:1], lane,
                                                     adj, torch.float64)
        assert arr.dtype == np.float64
        if adj:  # the lead adjoint streams X; its windows are 8-byte words
            assert ck._stream_smem(list(k), list(t), torch.float64) <= ck._STREAM_SMEM_BUDGET
            assert (ck._stream_smem(list(k), list(t), torch.float64)
                    > ck._stream_smem(list(k), list(t), torch.float32))
            continue
        # the lane body's windows (whole slabs, 3 x 2 doubles of slack) and
        # Q are 8-byte words, within the two-CTA budget
        e = t[0] * n[1] * n[2]
        smem = ck._lane_smem(tuple(n), tuple(k), tuple(t), torch.float64)
        assert t[1] >= n[1] and smem == t[2] * (e + 6) * 8 + 2 * e * 8
        assert smem <= ck._LANE_TWO_PER_SM


def test_f64_elementwise_plain_versions(rng):
    """The float64 elementwise kernels' plain versions compute in float64."""
    y = torch.from_numpy(rng.standard_normal((2, 7, 5, 6)))
    got = elemwise.mag_shrink_pair(y, 0.3)
    mag = np.hypot(y[0].numpy(), y[1].numpy())
    fac = np.maximum(mag - 0.3, 0) / np.maximum(mag, 1e-30)
    want = y.numpy() * np.concatenate([np.ones((1, 5, 6)), fac[1:]])[None]
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-15)
    a, b, c = (torch.from_numpy(rng.standard_normal((2, 5, 6))) for _ in range(3))
    m = torch.from_numpy((rng.random((5, 6)) < 0.4).astype(np.float64))
    z = a + 0.6 * (a - b)
    np.testing.assert_allclose(elemwise.fista_step(a, b, m, c, 0.6, 1.0).numpy(),
                               (z - m * (m * z - c)).numpy(), atol=1e-15)


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


def test_f64_cuda_branches_against_a_stub_library(monkeypatch):
    """The wrappers' CUDA branches on float64 arrays, against a library
    stub that records each launch: dtype code 2, double taps (reversed for
    a synthesis) and float64 scalars, for the per-level, stage and
    elementwise kernels."""
    launched = []

    class Stub:
        def __getattr__(self, name):
            return lambda *args: launched.append((name, args)) or 0

    monkeypatch.setattr(ck, "load", lambda: Stub())
    monkeypatch.setattr(ck, "load4", lambda: Stub())
    monkeypatch.setattr(elemwise, "load", lambda: Stub())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    on_card = lambda t: t.as_subclass(_OnCard)  # noqa: E731
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: on_card(empty(*a, **k)))
    dbl = ctypes.POINTER(ctypes.c_double)
    shape = (8, 8, 6)
    taps = tw.NDDWT(("db2", "db3", "db1"), shape, device="cpu").taps_hp
    y = ck.dec_levels(on_card(torch.zeros(shape, dtype=torch.float64)), taps, 1, lam=0.25,
                      stages=False)
    ck.rec_levels(on_card(y), taps, 1, False, stages=False)
    (_, dec), (_, rec) = launched
    assert dec[3] == rec[3] == 2 and isinstance(dec[9], dbl) and isinstance(rec[9], dbl)
    # slot 1 (axis 1, db3), lo row: (1 * 2 + 0) * kMaxTaps onwards
    assert [dec[9][2 * 76 + j] for j in range(6)] == list(taps[1][0])
    assert [rec[9][2 * 76 + j] for j in range(6)] == list(taps[1][0][::-1])
    assert dec[11] == 0.25 and rec[11] == 0.125
    assert dec[14] == rec[13] == 0  # mixed filters: the window body, named by the wrapper
    launched.clear()
    shape4 = (8, 8, 6, 6)
    y4 = ck.dec_levels(on_card(torch.zeros(shape4, dtype=torch.float64)),
                       taps[:2] + taps[1:], 1, stages=True)
    ck.rec_levels(on_card(y4), taps[:2] + taps[1:], 1, True, stages=True)
    assert [name for name, _ in launched] == ["nddwt_lane_dec", "nddwt_lead_dec",
                                              "nddwt_lead_adj", "nddwt_lane_adj"]
    for name, args in launched:
        code, ptr = (args[2], args[7]) if "lane" in name else (args[3], args[8])
        assert code == 2 and isinstance(ptr, dbl), name
    launched.clear()
    pair = on_card(torch.zeros((2, 15) + shape, dtype=torch.float64))
    monkeypatch.setattr(torch, "empty_like", lambda t: on_card(torch.zeros_like(t)))
    elemwise.mag_shrink_pair(pair, 0.1)
    v = on_card(torch.zeros((2,) + shape, dtype=torch.float64))
    elemwise.fista_step(v, v, on_card(torch.zeros(shape, dtype=torch.float64)), v, 0.6, 1.0)
    (_, shrink), (_, step) = launched
    assert shrink[2] == 2 and shrink[5] == 0.1
    assert step[5] == 2 and (step[7], step[8], step[9]) == (2, 0.6, 1.0)


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wv", [((24, 40, 72), "db4"), ((32, 256), ("db2", "db6")),
                                      ((20, 21, 22), ("db1", "db3", "db9"))])
def test_cuda_f64_level_kernels_match_plain_versions(shape, wv):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    plan = tw.NDDWT(wv, shape, dtype="double", device="cuda")
    nb = 2 ** len(shape)
    B = 2 * nb - 1
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)

    def close(k, r):
        assert (k - r).abs().max() <= 1e-12 * r.abs().max()

    for lam in (0.0, 0.1):
        for final in (False, True):
            bk = torch.zeros((B,) + shape, dtype=torch.float64, device="cuda")
            br = bk.clone()
            ak = ck.dec_level(x, bk, nb, plan.taps_hp, lam, final)
            ar = level_ref.dec_level_ref(x, br, nb, plan.taps_hp, lam, final)
            close(bk, br)
            if not final:
                close(ak, ar)
    y = torch.randn((B,) + shape, generator=g, device="cuda", dtype=torch.float64)
    for src in ([("y", b) for b in range(nb)],
                [("a", 0)] + [("y", nb + b - 1) for b in range(1, nb)]):
        close(ck.rec_level(y, x, src, plan.taps_hp, 1 / nb),
              level_ref.rec_level_ref(y, x, src, plan.taps_hp, 1 / nb))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,wv", [((12, 10, 9, 7), "db2"), ((40, 41, 45), "db20")])
def test_cuda_f64_stage_and_elementwise_kernels(shape, wv):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    taps = tw.NDDWT(wv, shape, device="cuda").taps_hp
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)

    def close(k, r):
        assert (k - r).abs().max() <= 1e-12 * r.abs().max()

    temp = level4_ref.lane_dec_ref(x, taps)
    close(ck.lane_dec(x, taps), temp)
    nb = 4 * temp.shape[0]
    bk = torch.zeros((nb,) + shape, dtype=torch.float64, device="cuda")
    br = bk.clone()
    close(ck.lead_dec(temp, bk, 1, taps, 0.1), level4_ref.lead_dec_ref(temp, br, 1, taps, 0.1))
    close(bk, br)
    y = torch.randn((2 * nb - 1,) + shape, generator=g, device="cuda", dtype=torch.float64)
    src = [("a", 0)] + [("y", nb + b - 1) for b in range(1, nb)]
    close(ck.lead_adj(y, x, src, taps), level4_ref.lead_adj_ref(y, x, src, taps))
    close(ck.lane_adj(temp, taps, 1 / nb), level4_ref.lane_adj_ref(temp, taps, 1 / nb))
    pair = torch.randn((2, 7) + shape, generator=g, device="cuda", dtype=torch.float64)
    close(elemwise.mag_shrink_pair(pair, 0.1), elemwise_ref.mag_shrink_pair_ref(pair, 0.1))
    m = (torch.rand(shape, generator=g, device="cuda") < 0.4).double()
    close(elemwise.fista_step(y[:2], y[2:4], m, y[4:6], 0.6, 1.0),
          elemwise_ref.fista_step_ref(y[:2], y[2:4], m, y[4:6], 0.6, 1.0))
