"""The halo-padded ("valid") mode of the level and lead-stage kernels: the
plain versions against the JAX package's concat 'valid' mode in TPU
interpret mode, and — on a CUDA device only — the CUDA kernels against
their plain versions.

The JAX side is ``pallas_kernels._fused_dec_level``/``_fused_rec_level``
with ``shape=``/``padded=`` and ``pallas_4d._lead_dec_call``/
``_lead_adj_call`` with ``shape_xy=``/``padded=``, called on one device,
outside ``shard_map``, on one rank's block of a seeded global array (the
last block on each padded axis, so the right halo wraps to the array's
start), padded from the global array by the JAX kernels' own halo widths
(``_dec_halos``, ``_rec_halos``, ``_lead_halos``: 8-row-rounded on the
sublane axis). The port's side gets the same block padded by its own
widths (``cuda_kernels.halo_widths``). The cases are the JAX sharded
kernel tests' (``tests/test_sharded.py:155-181, 209-220``) cut to one
rank's block: one and two padded axes, per-axis wavelets, db10, several
tiles per block, an unpadded axis beside a padded one.

Tolerances, relative to max|reference|: float32 1e-5 for the analysis and
1e-4 for the synthesis (the JAX kernel tests' own); float64 1e-12 against
the JAX direct path and the float64 oracle on the global array, cut to
the block.

JAX is imported by the ``jx`` fixture, not at module level, so that the
CUDA cases also run on a GPU machine without JAX:
``python -m pytest tests/test_torch_sharded_kernels.py -m cuda --noconftest``.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import oracle
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import level4_ref as r4
from non_decimated_wavelets_tpu_torch.ops import level_ref

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)

# (global shape, wavelet, mesh size per axis (1: unsharded), level): the
# JAX sharded kernel cases, each cut to the last rank's block.
LEVEL_CASES = [
    ((64, 256), "db4", (4, 1)),
    ((32, 32, 128), ("db2", "db3", "db4"), (2, 2, 1)),
    ((16, 16, 128), "db1", (2, 1, 1)),
    ((16, 32, 128), "db4", (1, 2, 1)),
    ((64, 32, 128), "db4", (2, 1, 1)),  # several tiles per block
    ((64, 64, 128), "db2", (2, 2, 1)),  # two axes, corners, several tiles
    ((48, 32, 128), "db10", (2, 1, 1)),  # a halo of 9 and 10 rows
    ((32, 32, 128), "db2", (2, 1, 1)),  # {"x": 2, "y": 1}
]
LEAD_CASES = [
    ((16, 16, 8, 16), "db2", (2, 2)),
    ((32, 16, 4, 32), "db1", (4, 1)),
    ((64, 16, 4, 32), "db2", (2, 1)),  # several lead tiles per block
]


def _case_id(case):
    shape, wv, mesh = case
    return f"{'x'.join(map(str, shape))}-{wv if isinstance(wv, str) else '-'.join(wv)}-{mesh}"


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    import non_decimated_wavelets_tpu as nw
    from non_decimated_wavelets_tpu.ops import direct_path, pallas_4d, pallas_kernels

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, pltpu=pltpu, nw=nw,
                                 direct_path=direct_path, pk=pallas_kernels,
                                 p4=pallas_4d)


def _interpret(jx, fn, *args):
    with jx.pltpu.force_tpu_interpret_mode():
        return jx.jax.jit(fn)(*args)


def _block(a, mesh, lead, widths):
    """The last rank's block of the global array ``a`` on every sharded
    axis (spatial axis ``k`` at ``lead + k``), padded periodically from the
    global array by ``widths[k]`` = (left, right) on those axes."""
    for ax, p in enumerate(mesh):
        if p == 1:
            continue
        axis, n = lead + ax, a.shape[lead + ax]
        w = n // p
        start = n - w
        left, right = widths[ax]
        idx = np.arange(start - left, start + w + right) % n
        a = np.take(a, idx, axis=axis)
    return np.ascontiguousarray(a)


def _cut(a, mesh, lead):
    return _block(a, mesh, lead, [(0, 0)] * len(mesh))


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max())


def _taps(jx, wv, shape):
    jplan = jx.nw.NDDWT(wavelet=wv, shape=shape, dtype=jx.jnp.float32)
    return tuple(np.asarray(t) for t in jplan.taps_hp)


def _jax_halos(halos):
    return [(h[0], h[1]) for h in halos]


# ------------------------------------------------------------ halo widths


@pytest.mark.parametrize("wv", ["db1", "db2", "db4", "db10", "sym4", "db38"])
def test_halo_widths(jx, wv):
    """The analysis reads K//2 - 1 rows in front and K//2 behind, the
    synthesis the mirror; the JAX kernels' widths agree on every leading
    axis but the sublane one, which they round up to 8 rows a side."""
    taps = tw.NDDWT(wv, (80, 80, 80), device="cpu").taps_hp
    K = taps[0].shape[1]
    assert ck.halo_widths(taps, False) == ((K // 2 - 1, K // 2),) * 3
    assert ck.halo_widths(taps, True) == ((K // 2, K // 2 - 1),) * 3
    jt = tuple(np.asarray(t) for t in taps)
    assert _jax_halos(jx.pk._dec_halos(3, jt))[0] == ck.halo_widths(taps, False)[0]
    assert _jax_halos(jx.pk._rec_halos(3, jt))[0] == ck.halo_widths(taps, True)[0]
    h0 = jx.p4._lead_halos(K, K, adjoint=False)[0]
    assert tuple(h0) == ck.halo_widths(taps, False)[0]


# -------------------------------------------- level kernels' plain versions


@pytest.mark.parametrize(
    "case,lam,final",
    [(c, 0.1, False) for c in LEVEL_CASES]
    + [(c, 0.0, False) for c in LEVEL_CASES[:3]]
    + [(LEVEL_CASES[1], 0.1, True), (LEVEL_CASES[6], 0.0, True)],
    ids=lambda v: _case_id(v) if isinstance(v, tuple) else str(v))
def test_dec_level_padded_matches_jax(jx, case, lam, final, rng):
    """``dec_level_ref`` with ``padded=`` against ``_fused_dec_level`` with
    ``shape=``/``padded=``: the details in place at ``band_off``, the
    approximation returned or, at the final level, in band 0; and against
    the unpadded level of the global array, cut to the block."""
    shape, wv, mesh = case
    nd = len(shape)
    taps = _taps(jx, wv, shape)
    local = tuple(n // p for n, p in zip(shape, mesh))
    nb, B = 2**nd, 2 * 2**nd - 1
    off = B - (nb - 1)
    x = rng.standard_normal(shape).astype(np.float32)
    jh = _jax_halos(jx.pk._dec_halos(nd, taps)) + [(0, 0)]
    xj = _block(x, mesh, 0, jh)
    big0 = rng.standard_normal((B,) + local).astype(np.float32)
    padded_j = tuple(p > 1 for p in mesh[:-1])

    def run(v, b):
        return jx.pk._fused_dec_level(v, b, off, taps, shape=local, padded=padded_j,
                                      approx_to_big=final, lam=lam)

    out = _interpret(jx, run, xj, big0)
    big_j, app_j = (out, None) if final else out
    padded = tuple(p > 1 for p in mesh)
    xt = torch.from_numpy(_block(x, mesh, 0, ck.halo_widths(taps, False)))
    big_t = torch.from_numpy(big0.copy())
    app_t = level_ref.dec_level_ref(xt, big_t, off, taps, lam, final, padded)
    _close(big_t.numpy(), big_j, 1e-5)
    # The unsharded level of the whole array, cut to the block.
    big_g = torch.zeros((B,) + shape)
    app_g = level_ref.dec_level_ref(torch.from_numpy(x), big_g, off, taps, lam, final)
    _close(big_t[off:].numpy(), _cut(big_g.numpy(), mesh, 1)[off:], 1e-5)
    if final:
        assert app_t is None
        _close(big_t[0].numpy(), _cut(big_g[0].numpy(), mesh, 0), 1e-5)
    else:
        _close(app_t.numpy(), app_j, 1e-5)
        _close(app_t.numpy(), _cut(app_g.numpy(), mesh, 0), 1e-5)


@pytest.mark.parametrize(
    "case,band0",
    [(c, "a") for c in LEVEL_CASES] + [(c, "y") for c in LEVEL_CASES[:3]],
    ids=lambda v: _case_id(v) if isinstance(v, tuple) else str(v))
def test_rec_level_padded_matches_jax(jx, case, band0, rng):
    """``rec_level_ref`` with ``padded=`` against ``_fused_rec_level`` with
    ``shape=``/``padded=``, every band from ``y`` or band 0 from the
    (padded) running approximation; and against the unpadded level."""
    shape, wv, mesh = case
    nd = len(shape)
    taps = _taps(jx, wv, shape)
    local = tuple(n // p for n, p in zip(shape, mesh))
    nb = 2**nd
    B = 2 * nb - 1
    y = rng.standard_normal((B,) + shape).astype(np.float32)
    acc = rng.standard_normal(shape).astype(np.float32)
    src = ([("y", b) for b in range(nb)] if band0 == "y"
           else [("a", 0)] + [("y", nb + b - 1) for b in range(1, nb)])
    scale = 1.0 / nb
    jh = _jax_halos(jx.pk._rec_halos(nd, taps)) + [(0, 0)]
    padded_j = tuple(p > 1 for p in mesh[:-1])
    yj, aj = _block(y, mesh, 1, jh), _block(acc, mesh, 0, jh)
    if band0 == "y":
        want = _interpret(jx, lambda v: jx.pk._fused_rec_level(
            v, None, src, taps, scale, shape=local, padded=padded_j), yj)
    else:
        want = _interpret(jx, lambda v, a: jx.pk._fused_rec_level(
            v, a, src, taps, scale, shape=local, padded=padded_j), yj, aj)
    widths = ck.halo_widths(taps, True)
    got = level_ref.rec_level_ref(
        torch.from_numpy(_block(y, mesh, 1, widths)),
        torch.from_numpy(_block(acc, mesh, 0, widths)), src, taps, scale,
        tuple(p > 1 for p in mesh))
    assert tuple(got.shape) == local
    _close(got.numpy(), want, 1e-4)
    whole = level_ref.rec_level_ref(torch.from_numpy(y), torch.from_numpy(acc), src,
                                    taps, scale)
    _close(got.numpy(), _cut(whole.numpy(), mesh, 0), 1e-4)


F64_CASES = [
    ((32, 24), "db4", (4, 1)),
    ((16, 16, 12), ("db2", "db3", "db4"), (2, 2, 1)),
    ((24, 16, 12), "db2", (2, 2, 1)),
    ((48, 12, 12), "db6", (2, 1, 1)),
]


@pytest.mark.parametrize("case", F64_CASES, ids=_case_id)
def test_level_padded_float64(jx, case, rng):
    """Float64 levels in the padded mode against the JAX direct path's
    level and the float64 oracle on the global array, cut to the block
    (1e-12)."""
    shape, wv, mesh = case
    nd = len(shape)
    plan = tw.NDDWT(wv, shape, dtype="float64", device="cpu")
    taps = plan.taps_hp
    nb = 2**nd
    x = rng.standard_normal(shape)
    big = torch.zeros((nb,) + tuple(n // p for n, p in zip(shape, mesh)),
                      dtype=torch.float64)
    level_ref.dec_level_ref(
        torch.from_numpy(_block(x, mesh, 0, ck.halo_widths(taps, False))), big, 1,
        taps, final=True, padded=tuple(p > 1 for p in mesh))
    jplan = jx.nw.NDDWT(wavelet=wv, shape=shape, dtype="double")
    want = np.asarray(jx.direct_path._level1_dec(jx.jnp.asarray(x), jplan.taps))
    _close(big.numpy(), _cut(want, mesh, 1), 1e-12)
    gold = np.moveaxis(oracle.dec(x, wv, 1), -1, 0)
    _close(big.numpy(), _cut(gold, mesh, 1), 1e-12)
    xr = level_ref.rec_level_ref(
        torch.from_numpy(_block(gold, mesh, 1, ck.halo_widths(taps, True))), None,
        [("y", b) for b in range(nb)], taps, 1.0 / nb, tuple(p > 1 for p in mesh))
    _close(xr.numpy(), _cut(x, mesh, 0), 1e-12)


# --------------------------------------- lead-stage kernels' plain versions


def _lead_geometry(jx, local, taps):
    X, Y, Z, T = local
    zct = jx.p4._chunk(Z, T) * T
    tiles = jx.p4._lead_tiles(X, Y, zct, taps[0].shape[1], taps[1].shape[1])
    return zct, tiles


def _view5(a, lead, zct):
    """(lead..., X, Y, Z, T) -> the JAX lead stage's (lead..., X, Y, Zcnt, zct)."""
    s = a.shape
    return a.reshape(s[:lead + 2] + (s[lead + 2] * s[lead + 3] // zct, zct))


@pytest.mark.parametrize(
    "case,lam,final",
    [(c, lam, False) for c in LEAD_CASES for lam in (0.0, 0.1)]
    + [(LEAD_CASES[0], 0.1, True)],
    ids=lambda v: _case_id(v) if isinstance(v, tuple) else str(v))
def test_lead_dec_padded_matches_jax(jx, case, lam, final, rng):
    """``lead_dec_ref`` with ``padded=`` against ``_lead_dec_call`` with
    ``shape_xy=``/``padded=`` on the lane bands of one block; and against
    the unpadded lead stage of the global lane bands, cut to the block."""
    shape, wv, mesh = case
    taps = _taps(jx, wv, shape)
    local = (shape[0] // mesh[0], shape[1] // mesh[1]) + shape[2:]
    m4 = mesh + (1, 1)
    zct, tiles = _lead_geometry(jx, local, taps)
    B, off = 31, 16
    temp = rng.standard_normal((4,) + shape).astype(np.float32)
    big0 = rng.standard_normal((B,) + local).astype(np.float32)
    jh = [tuple(h) for h in jx.p4._lead_halos(taps[0].shape[1], taps[1].shape[1],
                                               adjoint=False)] + [(0, 0)] * 2
    tj = _view5(_block(temp, m4, 1, jh), 1, zct)
    padded = (mesh[0] > 1, mesh[1] > 1)

    def run(t5, b5):
        return jx.p4._lead_dec_call(t5, b5, off, taps, tiles, zct,
                                    shape_xy=local[:2], padded=padded,
                                    approx_to_big=final, lam=lam)

    out = _interpret(jx, run, tj, _view5(big0, 1, zct))
    big_j, app_j = (out, None) if final else out
    tt = torch.from_numpy(_block(temp, m4, 1, ck.halo_widths(taps, False)[:2] + ((0, 0),) * 2))
    big_t = torch.from_numpy(big0.copy())
    app_t = r4.lead_dec_ref(tt, big_t, off, taps, lam, final, padded)
    _close(big_t.numpy(), np.asarray(big_j).reshape(big0.shape), 1e-5)
    big_g = torch.zeros((B,) + shape)
    app_g = r4.lead_dec_ref(torch.from_numpy(temp), big_g, off, taps, lam, final)
    _close(big_t[off:].numpy(), _cut(big_g.numpy(), m4, 1)[off:], 1e-5)
    if not final:
        _close(app_t.numpy(), np.asarray(app_j).reshape(local), 1e-5)
        _close(app_t.numpy(), _cut(app_g.numpy(), m4, 0), 1e-5)


@pytest.mark.parametrize("band0", ["y", "a"])
@pytest.mark.parametrize("case", LEAD_CASES, ids=_case_id)
def test_lead_adj_padded_matches_jax(jx, case, band0, rng):
    """``lead_adj_ref`` with ``padded=`` against ``_lead_adj_call`` with
    ``shape_xy=``/``padded=``, both kinds of band source; and against the
    unpadded lead adjoint."""
    shape, wv, mesh = case
    taps = _taps(jx, wv, shape)
    local = (shape[0] // mesh[0], shape[1] // mesh[1]) + shape[2:]
    m4 = mesh + (1, 1)
    zct, tiles = _lead_geometry(jx, local, taps)
    B = 31
    y = rng.standard_normal((B,) + shape).astype(np.float32)
    acc = rng.standard_normal(shape).astype(np.float32)
    src = ([("y", b) for b in range(16)] if band0 == "y"
           else [("a", 0)] + [("y", 16 + b - 1) for b in range(1, 16)])
    jh = [tuple(h) for h in jx.p4._lead_halos(taps[0].shape[1], taps[1].shape[1],
                                               adjoint=True)] + [(0, 0)] * 2
    padded = (mesh[0] > 1, mesh[1] > 1)
    yj = _view5(_block(y, m4, 1, jh), 1, zct)
    aj = _view5(_block(acc, m4, 0, jh)[None], 1, zct)
    if band0 == "y":
        want = _interpret(jx, lambda v: jx.p4._lead_adj_call(
            v, None, src, taps, tiles, zct, shape_xy=local[:2], padded=padded), yj)
    else:
        want = _interpret(jx, lambda v, a: jx.p4._lead_adj_call(
            v, a, src, taps, tiles, zct, shape_xy=local[:2], padded=padded), yj, aj)
    widths = ck.halo_widths(taps, True)[:2] + ((0, 0),) * 2
    got = r4.lead_adj_ref(torch.from_numpy(_block(y, m4, 1, widths)),
                          torch.from_numpy(_block(acc, m4, 0, widths)), src, taps,
                          padded)
    assert tuple(got.shape) == (4,) + local
    _close(got.numpy(), np.asarray(want).reshape((4,) + local), 1e-4)
    whole = r4.lead_adj_ref(torch.from_numpy(y), torch.from_numpy(acc), src, taps)
    _close(got.numpy(), _cut(whole.numpy(), m4, 1), 1e-4)


def test_lead_padded_float64(rng):
    """Float64 lead stages in the padded mode against the unpadded stages
    on the global array, cut to the block, and the float64 oracle through
    the lane stage (1e-12)."""
    shape, wv, mesh = (16, 12, 6, 5), "db2", (2, 2, 1, 1)
    plan = tw.NDDWT(wv, shape, dtype="float64", device="cpu")
    taps = plan.taps_hp
    x = rng.standard_normal(shape)
    temp = r4.lane_dec_ref(torch.from_numpy(x), taps).numpy()
    local = tuple(n // p for n, p in zip(shape, mesh))
    big = torch.zeros((16,) + local, dtype=torch.float64)
    r4.lead_dec_ref(torch.from_numpy(_block(temp, mesh, 1, ck.halo_widths(taps, False))),
                    big, 1, taps, final=True, padded=(True, True))
    gold = np.moveaxis(oracle.dec(x, wv, 1), -1, 0)
    _close(big.numpy(), _cut(gold, mesh, 1), 1e-12)
    partial = r4.lead_adj_ref(
        torch.from_numpy(_block(gold, mesh, 1, ck.halo_widths(taps, True))), None,
        [("y", b) for b in range(16)], taps, (True, True))
    xr = r4.lane_adj_ref(partial, taps, 1.0 / 16)
    _close(xr.numpy(), _cut(x, mesh, 0), 1e-12)


# ------------------------------------------------------- the CUDA branches


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def stub(monkeypatch):
    """The wrappers' CUDA branches against a library stub that records
    each launch (the card runs the real library)."""
    launched = []

    class Stub:
        def __getattr__(self, name):
            return lambda *args: launched.append((name, args)) or 0

    monkeypatch.setattr(ck, "load", lambda: Stub())
    monkeypatch.setattr(ck, "load4", lambda: Stub())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: _on_card(empty(*a, **k)))
    return launched


def _on_card(t):
    return t.as_subclass(_OnCard)


def test_cuda_branches_against_a_stub_library(stub):
    """The padded flags go last before the stream (the older arguments keep
    their places; ``nddwt_dec_level``'s and ``nddwt_rec_level``'s pointers
    to the body they took come after the stream), the outputs take the
    block's extent, and each padded
    launch counts in ``launch_counts`` and ``padded_launch_counts``; an
    unpadded launch passes zero flags and counts once."""
    before = dict(ck.launch_counts)
    before_p = dict(ck.padded_launch_counts)
    taps = tw.NDDWT("db4", (16, 16, 16), device="cpu").taps_hp
    local = (8, 16, 16)
    big = _on_card(torch.zeros((8,) + local))
    out = ck.dec_level(_on_card(torch.zeros((15, 16, 16))), big, 1, taps,
                       padded=(True, False, False))
    assert tuple(out.shape) == local
    ck.rec_level(_on_card(torch.zeros((8, 8, 23, 16))), None,
                 [("y", b) for b in range(8)], taps, 1.0, (False, True, False))
    ck.dec_level(_on_card(torch.zeros(local)), big, 1, taps)
    names = [name for name, _ in stub]
    assert names == ["nddwt_dec_level", "nddwt_rec_level", "nddwt_dec_level"]
    assert list(stub[0][1][-3]) == [1, 0, 0] and list(stub[0][1][4]) == [8, 16, 16]
    assert list(stub[1][1][-3]) == [0, 1, 0] and list(stub[1][1][4]) == [8, 16, 16]
    assert list(stub[2][1][-3]) == [0, 0, 0]
    taps4 = tw.NDDWT("db2", (8, 8, 4, 6), device="cpu").taps_hp
    big4 = _on_card(torch.zeros((16, 4, 8, 4, 6)))
    ck.lead_dec(_on_card(torch.zeros((4, 7, 8, 4, 6))), big4, 1, taps4,
                padded=(True, False))
    part = ck.lead_adj(_on_card(torch.zeros((16, 7, 11, 4, 6))), None,
                       [("y", b) for b in range(16)], taps4, (True, True))
    assert tuple(part.shape) == (4, 4, 8, 4, 6)
    assert [name for name, _ in stub[3:]] == ["nddwt_lead_dec", "nddwt_lead_adj"]
    assert list(stub[3][1][-2]) == [1, 0, 0] and list(stub[3][1][4]) == [4, 8, 24]
    assert list(stub[4][1][-2]) == [1, 1, 0] and list(stub[4][1][4]) == [4, 8, 24]
    for name, n, p in (("nddwt_dec_level", 2, 1), ("nddwt_rec_level", 1, 1),
                       ("nddwt_lead_dec", 1, 1), ("nddwt_lead_adj", 1, 1)):
        assert ck.launch_counts[name] == before[name] + n
        assert ck.padded_launch_counts[name] == before_p[name] + p


def test_padded_wrappers_check_their_operands():
    """A padded input whose extents do not match the output's plus the
    halo, or a flag list of the wrong length, raises."""
    taps = tw.NDDWT("db4", (16, 16, 16), device="cpu").taps_hp
    big = torch.zeros((8, 8, 16, 16))
    with pytest.raises(ValueError, match="cannot take"):
        ck.dec_level(_on_card(torch.zeros((14, 16, 16))), _on_card(big), 1, taps,
                     padded=(True, False, False))
    with pytest.raises(ValueError, match="one flag per axis"):
        ck.dec_level(_on_card(torch.zeros((15, 16, 16))), _on_card(big), 1, taps,
                     padded=(True, False))
    with pytest.raises(ValueError, match="too short"):
        ck.rec_level(_on_card(torch.zeros((8, 7, 16, 16))), None,
                     [("y", b) for b in range(8)], taps, 1.0, (True, False, False))
    taps4 = tw.NDDWT("db2", (8, 8, 4, 6), device="cpu").taps_hp
    with pytest.raises(ValueError, match="cannot take"):
        ck.lead_dec(torch.zeros((4, 8, 8, 4, 6)), torch.zeros((16, 4, 8, 4, 6)), 1,
                    taps4, padded=(True, False))
    with pytest.raises(ValueError, match="needs an approx"):
        ck.lead_adj(torch.zeros((16, 7, 8, 4, 6)), torch.zeros((4, 8, 4, 6)),
                    [("a", 0)] + [("y", b) for b in range(1, 16)], taps4, (True, False))


# ------------------------------------------------------------ on the card


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_cuda_padded_kernels_match_plain_versions(dtype):
    """The four kernels' padded mode against their plain versions on the
    card, and against the wrapped level of the whole array cut to the
    block."""
    _need_cuda()
    dt = getattr(torch, dtype)
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}.get(dt, 1e-2)

    def close(k, r):
        assert (k.double() - r.double()).abs().max() <= tol * r.double().abs().max()

    shape, mesh = (48, 40, 24), (2, 2, 1)
    taps = tw.NDDWT("db4", shape, device="cuda").taps_hp
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda", dtype=torch.float64).to(dt)
    xp = torch.from_numpy(_block(x.cpu().double().numpy(), mesh, 0,
                                 ck.halo_widths(taps, False))).to(dt).cuda()
    local = (24, 20, 24)
    padded = (True, True, False)
    for lam in (0.0, 0.1):
        bk = torch.zeros((15,) + local, dtype=dt, device="cuda")
        br = bk.clone()
        ak = ck.dec_level(xp, bk, 8, taps, lam, False, padded)
        ar = level_ref.dec_level_ref(xp, br, 8, taps, lam, False, padded)
        close(bk, br)
        close(ak, ar)
    y = torch.randn((15,) + shape, generator=g, device="cuda", dtype=torch.float64).to(dt)
    yp = torch.from_numpy(_block(y.cpu().double().numpy(), mesh, 1,
                                 ck.halo_widths(taps, True))).to(dt).cuda()
    ap = yp[0].contiguous()
    for src in ([("y", b) for b in range(8)],
                [("a", 0)] + [("y", 8 + b - 1) for b in range(1, 8)]):
        close(ck.rec_level(yp, ap, src, taps, 0.125, padded),
              level_ref.rec_level_ref(yp, ap, src, taps, 0.125, padded))
    shape4, mesh4 = (16, 12, 6, 5), (2, 2, 1, 1)
    taps4 = tw.NDDWT("db2", shape4, device="cuda").taps_hp
    t = torch.randn((4,) + shape4, generator=g, device="cuda", dtype=torch.float64).to(dt)
    tp = torch.from_numpy(_block(t.cpu().double().numpy(), mesh4, 1,
                                 ck.halo_widths(taps4, False))).to(dt).cuda()
    local4 = (8, 6, 6, 5)
    bk = torch.zeros((31,) + local4, dtype=dt, device="cuda")
    br = bk.clone()
    close(ck.lead_dec(tp, bk, 16, taps4, 0.1, False, (True, True)),
          r4.lead_dec_ref(tp, br, 16, taps4, 0.1, False, (True, True)))
    close(bk, br)
    y4 = torch.randn((31,) + shape4, generator=g, device="cuda", dtype=torch.float64).to(dt)
    y4p = torch.from_numpy(_block(y4.cpu().double().numpy(), mesh4, 1,
                                  ck.halo_widths(taps4, True))).to(dt).cuda()
    src = [("a", 0)] + [("y", 16 + b - 1) for b in range(1, 16)]
    close(ck.lead_adj(y4p, y4p[0].contiguous(), src, taps4, (True, True)),
          r4.lead_adj_ref(y4p, y4p[0].contiguous(), src, taps4, (True, True)))
