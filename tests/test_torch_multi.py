"""The one-launch multilevel kernels of the torch port against the JAX
package on the CPU, and — on a CUDA device only — against their plain
versions.

* The kernels' plain versions (``ops/multi_ref.py``) and the wrappers of
  ``ops/multi.py`` on CPU tensors (which run them) against the JAX
  package's one-launch multilevel kernels ``_fused_dec_multi`` and
  ``_fused_rec_multi`` in TPU interpret mode, at ``tests/test_pallas.py``'s
  ``MULTI_CASES``, with and without the fused shrink and in both
  normalizations. Each JAX result is computed once, in a module fixture.
* In float64, at odd extents and a batch of three, against the JAX direct
  path and the NumPy oracle; in bfloat16, against the per-level chain.
* ``multi_supported``'s gates, the plan's routes onto the kernels (the
  device check stubbed), and the wrappers' CUDA branches against a stub
  library.

Tolerances: float32 atol 1e-5 (bands) and 1e-4 (reconstructions), the JAX
tests' own (``tests/test_pallas.py:66-70``); float64 1e-12.

JAX is imported by the ``jx`` fixture, not at module level, so that the
CUDA cases also run on a GPU machine without JAX:
``python -m pytest tests/test_torch_multi.py -m cuda --noconftest``.
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
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import elemwise, flat, multi, multi_ref

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)

MULTI_CASES = [  # tests/test_pallas.py:45-50
    ((64, 128), "db2", 3, False),
    ((32, 16, 128), "db4", 3, True),
    ((16, 16, 256), ("db1", "db3", "db2"), 2, False),
    ((24, 8, 128), ("db6", "db2", "db4"), 4, True),
]
LAM = 0.1


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    import non_decimated_wavelets_tpu as nw
    from non_decimated_wavelets_tpu import oracle
    from non_decimated_wavelets_tpu.ops import direct_path, pallas_kernels

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, pltpu=pltpu, nw=nw,
                                 oracle=oracle, direct_path=direct_path,
                                 pallas_kernels=pallas_kernels)


@pytest.fixture(scope="module")
def jax_multi(jx):
    """Per case and normalization: the input, the taps, the direct path's
    bands, and the JAX multilevel kernels' analysis (lam 0 and 0.1, the
    case's normalization) and synthesis of those bands (each
    normalization), computed once in interpret mode."""
    rng = np.random.default_rng(7)
    out = []
    for shape, wv, level, case_pl2 in MULTI_CASES:
        x = rng.standard_normal(shape).astype(np.float32)
        xj = jx.jnp.asarray(x)
        taps, bands, res = {}, {}, {}
        for pl2 in (False, True):
            plan = jx.nw.NDDWT(wavelet=wv, shape=shape, dtype=jx.jnp.float32,
                               preserve_l2=pl2)
            taps[pl2] = tuple(np.asarray(t) for t in plan.taps_hp)
            yd = jx.direct_path.dec_direct(xj, plan.taps, level)
            bands[pl2] = np.array(yd)
            with jx.pltpu.force_tpu_interpret_mode():
                res["rec", pl2] = jx.pallas_kernels._fused_rec_multi(
                    yd, taps[pl2], level, pl2)
                if pl2 == case_pl2:
                    for lam in (0.0, LAM):
                        res["dec", lam] = jx.pallas_kernels._fused_dec_multi(
                            xj, taps[pl2], level, lam=lam)
        out.append(types.SimpleNamespace(
            x=x, taps=taps, bands=bands, pl2=case_pl2,
            res={k: np.asarray(v) for k, v in res.items()}))
    return out


@pytest.mark.parametrize("op", [("dec", 0.0), ("dec", LAM), ("rec", False), ("rec", True)],
                         ids=["dec", "dec-lam", "rec", "rec-l2"])
@pytest.mark.parametrize("case", range(len(MULTI_CASES)))
def test_multi_matches_pallas_multi(jax_multi, case, op):
    """The plain versions and the wrappers on CPU tensors (a batch of one)
    equal the JAX one-launch kernels: the analysis with and without the
    fused shrink within 1e-5, the synthesis in both normalizations within
    1e-4."""
    c = jax_multi[case]
    level = MULTI_CASES[case][2]
    want = c.res[op]
    kind, arg = op
    if kind == "dec":
        x = torch.from_numpy(c.x)[None]
        taps = c.taps[c.pl2]
        got = (multi_ref.dec_multi_ref(x, taps, level, arg),
               multi.dec_multi(x, taps, level, arg))
        tol = 1e-5
    else:
        y = torch.from_numpy(c.bands[arg])[None]
        scale = 1.0 if arg else 1.0 / 2 ** len(c.x.shape)
        got = (multi_ref.rec_multi_ref(y, c.taps[arg], level, scale),
               multi.rec_multi(y, c.taps[arg], level, arg))
        tol = 1e-4
    for g in got:
        assert g.dtype == torch.float32 and tuple(g.shape) == (1,) + want.shape
        np.testing.assert_allclose(g[0].numpy(), want, atol=tol)


@pytest.mark.parametrize("shape,wv,level", [((37, 29, 41), "db4", 3),
                                            ((50, 33), ("db2", "db3"), 2)])
@pytest.mark.parametrize("pl2", [False, True])
def test_multi_ref_f64_batch_matches_jax_and_oracle(jx, shape, wv, level, pl2, rng):
    """float64 at odd extents, a batch of three: the analysis (with the
    shrink) against the JAX direct path and the oracle, the synthesis
    against the JAX direct path and the round trip, within 1e-12."""
    jp = jx.nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2, dtype="double",
                     path="direct")
    taps = tuple(np.asarray(t) for t in jp.taps_hp)
    x = rng.standard_normal((3,) + shape)
    xt = torch.from_numpy(x)
    y = multi_ref.dec_multi_ref(xt, taps, level)
    ys = multi_ref.dec_multi_ref(xt, taps, level, LAM)
    scale = 1.0 if pl2 else 1.0 / 2 ** len(shape)
    xr = multi_ref.rec_multi_ref(y, taps, level, scale)
    for i in range(3):
        want = np.asarray(jp.dec(x[i], level, band_axis=0))
        np.testing.assert_allclose(y[i].numpy(), want, atol=1e-12)
        gold = np.moveaxis(jx.oracle.dec(x[i], wv, level, preserve_l2=pl2), -1, 0)
        np.testing.assert_allclose(y[i].numpy(), gold, atol=1e-12)
        d = gold[1:]
        gold[1:] = d * np.maximum(np.abs(d) - LAM, 0) / np.maximum(np.abs(d), 1e-30)
        np.testing.assert_allclose(ys[i].numpy(), gold, atol=1e-12)
        np.testing.assert_allclose(xr[i].numpy(), np.asarray(jp.rec(want, band_axis=0)),
                                   atol=1e-12)
        np.testing.assert_allclose(xr[i].numpy(), x[i], atol=1e-12)


@pytest.mark.parametrize("shape,wv", [((24, 40, 36), "db4"), ((32, 48), ("db1", "db3"))])
def test_multi_ref_bf16_equals_level_chain(shape, wv, rng):
    """In bfloat16 the approximation between levels is stored in bfloat16,
    as the per-level chain stores it: a batch of two equals each item's
    per-level chain exactly."""
    taps = tw.NDDWT(wv, shape, device="cpu").taps_hp
    x = torch.from_numpy(rng.standard_normal((2,) + shape)).to(torch.bfloat16)
    y = multi.dec_multi(x, taps, 3, LAM)
    for pl2 in (True, False):
        xr = multi.rec_multi(y, taps, 3, pl2)
        assert xr.dtype == torch.bfloat16
        for i in range(2):
            assert torch.equal(xr[i], ck.rec_levels(y[i], taps, 3, pl2, stages=False))
    for i in range(2):
        assert torch.equal(y[i], ck.dec_levels(x[i], taps, 3, LAM, stages=False))


@pytest.mark.parametrize("shape,wv,dtype,level,want", [
    ((64, 128), "db2", torch.float32, 3, True),
    ((32, 16, 128), "db4", torch.float64, 2, True),
    ((16, 16, 256), "db4", torch.bfloat16, 4, True),
    ((64, 128), "db2", torch.float32, 1, False),  # one level: the per-level kernel
    ((1024,), "db2", torch.float32, 3, False),  # 1D
    ((8, 8, 8, 8), "db2", torch.float32, 2, False),  # 4D
    ((64, 64, 64), "db20", torch.float32, 2, "stage"),  # the stage kernels' filters
    ((64, 64, 64), "db12", torch.float64, 2, "stage"),  # the same in float64
    ((64, 64, 64), "db4", torch.float16, 2, False),  # no float16 kernels
])
def test_multi_supported_gates(monkeypatch, shape, wv, dtype, level, want):
    """``multi_supported`` (JAX ``multi_feasible``, ``test_multilevel_gates``)
    takes 2D and 3D items of at least two levels whose filters fit the tile
    in both directions, up to ``MULTI_MAX_NUMEL`` elements an item. A 3D
    level of the stage route ("stage") is such an item, and ``NDDWT.route``
    keeps it on the stage kernels, beyond the flat kernel's size too."""
    plan = tw.NDDWT(wv, shape, device="cpu")
    assert multi.multi_supported(shape, plan.taps_hp, dtype, level) is (want is not False)
    if want == "stage":
        monkeypatch.setattr(flat, "FLAT_MAX_NUMEL", {None: 0})
        assert plan.route(dtype, level, on_card=True) == "stage"


@pytest.mark.parametrize("ndim", [2, 3])
def test_multi_supported_limit(ndim):
    """An item of ``MULTI_MAX_NUMEL`` elements takes the multilevel
    kernels, one more does not."""
    taps = tw.NDDWT("db4", (8,) * ndim, device="cpu").taps_hp
    lead = multi.MULTI_MAX_NUMEL // 8 ** (ndim - 1)
    at = (lead,) + (8,) * (ndim - 1)
    assert multi.multi_supported(at, taps, torch.float32, 3) == bool(
        np.prod(at) <= multi.MULTI_MAX_NUMEL)
    assert not multi.multi_supported((lead + 1,) + at[1:], taps, torch.float32, 3)


# ------------------------------------------------------- the plan's routes


@pytest.fixture
def routed(monkeypatch):
    """Route every tensor as if it were on a CUDA device, beyond the flat
    kernel's size; count what the card would launch."""
    monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=True))
    monkeypatch.setattr(flat, "FLAT_MAX_NUMEL", {None: 0})
    counts = dict.fromkeys(("dec_multi", "rec_multi", "levels", "mag_shrink_pair"), 0)

    def spy(module, name, key):
        real = getattr(module, name)

        def wrapped(*a, **k):
            counts[key] += 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    spy(multi, "dec_multi", "dec_multi")
    spy(multi, "rec_multi", "rec_multi")
    for name in ("dec_level", "rec_level", "lane_dec", "lead_dec", "lead_adj", "lane_adj"):
        spy(ck, name, "levels")
    spy(elemwise, "mag_shrink_pair", "mag_shrink_pair")
    return counts


@pytest.mark.parametrize("dtype,tol", [("float32", (1e-5, 1e-4)), ("float64", (1e-12, 1e-12))])
def test_plan_routes_onto_multi(jx, routed, dtype, tol, rng):
    """Beyond the flat kernel: a real ``dec_rec`` is one analysis and one
    synthesis launch; a complex one with a threshold adds one joint shrink
    between them; ``dec_rec_split`` the same; all equal the JAX plan."""
    shape, level = (20, 12, 16), 3
    jp = jx.nw.NDDWT(wavelet="db2", shape=shape, dtype=getattr(jx.jnp, dtype))
    tp = convert.plan_from_jax(jp.to_config(), tuple(np.asarray(t) for t in jp.taps_hp),
                               device="cpu")
    x = rng.standard_normal(shape)
    xc = x + 1j * rng.standard_normal(shape)
    for data, want in ((x, {"dec_multi": 1, "rec_multi": 1, "levels": 0,
                            "mag_shrink_pair": 0}),
                       (xc, {"dec_multi": 1, "rec_multi": 1, "levels": 0,
                             "mag_shrink_pair": 1})):
        routed.update(dict.fromkeys(routed, 0))
        y, xr = tp.dec_rec(data, level, threshold=LAM, band_axis=0)
        assert routed == want
        yj, xj = jp.dec_rec(jx.jnp.asarray(data), level, threshold=LAM, band_axis=0)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=tol[0])
        np.testing.assert_allclose(xr.numpy(), np.asarray(xj), atol=tol[1])
    routed.update(dict.fromkeys(routed, 0))
    pair = np.stack([xc.real, xc.imag])
    yp, xp = tp.dec_rec_split(pair, level, LAM)
    assert routed == {"dec_multi": 1, "rec_multi": 1, "levels": 0, "mag_shrink_pair": 1}
    yj, xj = jp.dec_rec_split(jx.jnp.asarray(pair), level, threshold=LAM)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), atol=tol[0])
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=tol[1])


def test_plan_keeps_the_per_level_route_elsewhere(routed, monkeypatch, rng):
    """One level, and items above ``MULTI_MAX_NUMEL``, stay on the
    per-level kernels."""
    tp = tw.NDDWT("db2", (16, 12), device="cpu")
    x = torch.from_numpy(rng.standard_normal((16, 12))).float()
    tp.dec_rec(x, 1, threshold=LAM)
    assert routed == {"dec_multi": 0, "rec_multi": 0, "levels": 2, "mag_shrink_pair": 0}
    monkeypatch.setattr(multi, "MULTI_MAX_NUMEL", 100)
    tp.dec_rec(x, 2, threshold=LAM)
    assert routed == {"dec_multi": 0, "rec_multi": 0, "levels": 6, "mag_shrink_pair": 0}


# ------------------------------------------------ the CUDA branches, stubbed


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype,code,ctype", [(torch.float32, 0, ctypes.c_float),
                                              (torch.bfloat16, 1, ctypes.c_float),
                                              (torch.float64, 2, ctypes.c_double)])
def test_multi_cuda_branches_against_a_stub_library(monkeypatch, dtype, code, ctype):
    """The wrappers' CUDA branches against a library stub that records each
    call: pointers, dtype code, ndim, batch, level, the streamed view of the
    per-level kernels (a 2D batch folded into its pass-through slot 1,
    (n0, N, n1)) with the batch's plan, the taps in the compute type
    (reversed for the synthesis), the analysis's bands a walk, lam or scale,
    the ping slots, the launch counts; a failed launch raises."""
    launched = []  # (name, arguments, the taps as the library read them)
    fail = []

    class Stub:
        def __getattr__(self, name):
            if name == "nddwt_error_string":
                return lambda code: b"stub error"

            def launch(*args):
                taps = np.ctypeslib.as_array(
                    ctypes.cast(args[13], ctypes.POINTER(ctype)), (3, 2, 76)).copy()
                launched.append((name, args, taps))
                return fail[-1] if fail else 0

            return launch

    monkeypatch.setattr(multi, "load", lambda: Stub())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    on_card = lambda t: t.as_subclass(_OnCard)  # noqa: E731
    empty = torch.empty
    pings = []

    def fake_empty(*a, **k):
        t = on_card(empty(*a, **k))
        pings.append(t)
        return t

    monkeypatch.setattr(torch, "empty", fake_empty)
    before = dict(ck.launch_counts)
    shape, level = (12, 20), 3
    taps = tw.NDDWT(("db2", "db3"), shape, device="cpu").taps_hp
    x = on_card(torch.zeros((3,) + shape, dtype=dtype))
    y = multi.dec_multi(x, taps, level, 0.25)
    assert tuple(y.shape) == (3, 10) + shape
    name, args, got = launched[-1]
    px, pb, pp, pc, dt, nd, items, lvl, n, k, t, left, bit, _, gw, lam, _ = args
    assert name == "nddwt_dec_multi" and (dt, nd, items, lvl, lam) == (code, 2, 3, 3, 0.25)
    assert (px, pb) == (x.data_ptr(), y.data_ptr())
    assert tuple(pings[-1].shape) == (6,) + shape and pp == pings[-1].data_ptr()
    assert pc is not None and pc not in (px, pb, pp)  # the per-level unit counters
    assert list(n) == [12, 3, 20] and list(k) == [4, 1, 6] and list(bit) == [0, 0, 1]
    assert list(left) == [1, 0, 2]
    plan = multi._plan(shape, (4, 6), dtype, False, 3)
    assert list(t) == list(plan[2]) and gw == plan[3] == ck._walk_bands([4, 1, 6], plan[2], dtype)
    assert np.array_equal(got[0, :, :4], taps[0].astype(got.dtype))
    assert np.array_equal(got[2, :, :6], taps[1].astype(got.dtype))
    assert np.array_equal(got[1, :, :2], [[1, 0], [1, 0]])  # the pass-through slot
    out = multi.rec_multi(y, taps, level, False)
    name, args, got = launched[-1]
    assert name == "nddwt_rec_multi" and tuple(out.shape) == (3,) + shape
    assert (args[0], args[1]) == (y.data_ptr(), out.data_ptr()) and args[-2] == 0.25
    assert list(args[11]) == [2, 0, 3]  # the mirrored halo
    assert len(args) == 16  # no bands a walk
    assert np.array_equal(got[2, :, :6], taps[1][:, ::-1].astype(got.dtype))
    multi.dec_multi(on_card(torch.zeros((1,) + shape, dtype=dtype)), taps, 2)
    assert launched[-1][1][2] == pings[-1].data_ptr() and pings[-1].shape[0] == 1
    multi.rec_multi(on_card(torch.zeros((1, 4) + shape, dtype=dtype)), taps, 1, True)
    assert launched[-1][1][2] is None and launched[-1][1][-2] == 1.0  # no ping at L = 1
    assert ck.launch_counts["nddwt_dec_multi"] == before["nddwt_dec_multi"] + 2
    assert ck.launch_counts["nddwt_rec_multi"] == before["nddwt_rec_multi"] + 2
    fail.append(2)
    with pytest.raises(RuntimeError, match="nddwt_dec_multi launch failed: stub error"):
        multi.dec_multi(x, taps, level)
    assert ck.launch_counts["nddwt_dec_multi"] == before["nddwt_dec_multi"] + 2


def test_multi_wrappers_check_their_operands():
    taps = tw.NDDWT("db2", (8, 8), device="cpu").taps_hp
    with pytest.raises(NotImplementedError, match="2D and 3D items"):
        multi.dec_multi(torch.zeros(2, 8), taps[:1], 2)
    with pytest.raises(ValueError, match="at least one item"):
        multi.dec_multi(torch.zeros(0, 8, 8), taps, 2)
    with pytest.raises(ValueError, match="not 3 levels"):
        multi.rec_multi(torch.zeros(1, 7, 8, 8), taps, 3, False)
    with pytest.raises(ValueError, match="out must be"):
        multi.dec_multi(torch.zeros(1, 8, 8), taps, 2, out=torch.zeros(1, 4, 8, 8))


# --------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("shape,wv,level,batch", [((37, 29, 41), "db4", 3, 2),
                                                  ((50, 33), ("db2", "db6"), 4, 3),
                                                  ((16, 16, 256), ("db1", "db3", "db2"), 2, 1),
                                                  # the stage route's filters, which the
                                                  # kernels take (no route sends them)
                                                  ((40, 36, 33), "db15", 2, 1)])
def test_cuda_multi_kernels_match_plain_versions(shape, wv, level, batch, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float64: 1e-12}[dt]
    taps = tw.NDDWT(wv, shape, device="cuda").taps_hp
    g = torch.Generator(device="cuda").manual_seed(0)
    draw = torch.float64 if dt == torch.float64 else torch.float32
    x = torch.randn((batch,) + shape, generator=g, device="cuda", dtype=draw).to(dt)
    for lam in (0.0, LAM):
        k = multi.dec_multi(x, taps, level, lam)
        r = multi_ref.dec_multi_ref(x, taps, level, lam)
        assert (k.double() - r.double()).abs().max() <= tol * r.double().abs().max()
    for pl2 in (False, True):
        k = multi.rec_multi(r, taps, level, pl2)
        ref = multi_ref.rec_multi_ref(r, taps, level, 1.0 if pl2 else 0.5 ** len(shape))
        assert (k.double() - ref.double()).abs().max() <= tol * ref.double().abs().max()
