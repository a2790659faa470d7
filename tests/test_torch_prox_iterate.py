"""The reconstruction-only iterate ``NDDWT._iterate`` and the synthesis's
``out=`` (``cuda_kernels.rec_levels``), on the CPU.

* The plan on its kernel routes with the device check stubbed, so that the
  wrappers run their plain versions: on every route, 1D to 4D, in
  complex64 and complex128, the iterate equals ``dec_rec(x, level, thr,
  band_axis=0)[1]`` exactly; real data, a zero threshold and an input that
  needs a gradient run ``dec_rec``'s own path (the same spans, counters,
  values and gradients, or the same error).
* Its copies: the split of ``x`` and the join of the reconstruction, 32 B
  an element in complex64, on every route, and so in each iteration of the
  solvers that call it.
* ``rec_levels(out=...)`` against ``out=None`` on the plain versions in
  1D-3D and on the stage route, and on the wrappers' CUDA branches against
  a stub library: the last launch writes the given buffer.

Nothing here imports JAX.
"""

import contextlib
import types
from functools import partialmethod

import pytest
import torch

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import plan as tplan
from non_decimated_wavelets_tpu_torch import tracing
from non_decimated_wavelets_tpu_torch.models import cs_recon
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import flat, multi

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture
def on_card(monkeypatch):
    """The plan takes every tensor for a CUDA one; the wrappers, seeing a
    CPU tensor, run their plain versions."""
    monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=True))
    return monkeypatch


def _routes(monkeypatch, route):
    """Hold small shapes to ``route`` by the kernels' size limits."""
    if route in ("multi", "level", "stage"):
        monkeypatch.setattr(flat, "FLAT_MAX_NUMEL", {None: 0})
        monkeypatch.setattr(flat, "ITER_MAX_NUMEL", 0)
    if route in ("level", "stage"):
        monkeypatch.setattr(multi, "MULTI_MAX_NUMEL", 0)


def _x(shape, dtype=torch.float32):
    g = torch.Generator().manual_seed(11)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    if dtype.is_complex:
        x = torch.complex(x, torch.randn(shape, generator=g, dtype=torch.float64))
    return x.to(dtype)


def _plan(shape, dtype, **kw):
    real = {torch.complex128: "float64", torch.float64: "float64"}.get(dtype, "float32")
    return tw.NDDWT("db2", shape, dtype=real, device="cpu", **kw)


def _recorded():
    got = tracing.summary()
    tracing.reset()
    return {k: v["calls"] for k, v in got["spans"].items()}, got["counters"]


# (route, shape, level, preserve_l2, threshold); the flat route takes the
# one-launch pair at any threshold, the others only above zero.
ITERATE_CASES = [
    ("level", (64,), 3, False, 0.1),
    ("level", (16, 12), 2, True, 0.1),
    ("level", (10, 8, 12), 3, False, 0.1),
    ("multi", (16, 12), 3, False, 0.1),
    ("multi", (12, 10, 8), 2, True, 0.1),
    ("flat", (16, 12), 2, False, 0.1),
    ("flat", (8, 6, 10), 2, True, 0.1),
    ("flat", (16, 12), 2, True, 0.0),
    ("stage", (8, 8, 4, 6), 2, False, 0.1),
]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128],
                         ids=["c64", "c128"])
@pytest.mark.parametrize("route,shape,level,l2,thr", ITERATE_CASES,
                         ids=[f"{c[0]}-{len(c[1])}d-L{c[2]}-{c[4]}" for c in ITERATE_CASES])
def test_iterate_equals_the_reconstruction_of_dec_rec(on_card, route, shape, level,
                                                      l2, thr, dtype):
    _routes(on_card, route)
    plan = _plan(shape, dtype, preserve_l2=l2)
    assert plan.route(dtype, level) == route
    x = _x(shape, dtype)
    got = plan._iterate(x, level, thr)
    want = plan.dec_rec(x, level, thr, band_axis=0)[1]
    assert got.dtype == dtype and tuple(got.shape) == shape
    assert torch.equal(got, want)


# (what, route); each on a complex64 (16, 12) array at L2 unless named.
FALLBACK_CASES = [
    ("real", "level"),
    ("real", "multi"),
    ("real", "flat"),
    ("real", "stage"),
    ("zero threshold", "level"),
    ("zero threshold", "multi"),
    ("gradient", "direct"),
    ("gradient", "fft"),
    ("gradient", "level"),
    ("gradient", "flat"),
]


@pytest.mark.parametrize("what,route", FALLBACK_CASES,
                         ids=[f"{w.replace(' ', '_')}-{r}" for w, r in FALLBACK_CASES])
def test_iterate_runs_dec_rec_s_own_path(monkeypatch, what, route):
    shape = (8, 8, 4, 6) if route == "stage" else (16, 12)
    dtype = torch.float32 if what == "real" else torch.complex64
    thr = 0.0 if what == "zero threshold" else 0.1
    if route not in ("direct", "fft"):
        monkeypatch.setattr(tplan.NDDWT, "route",
                            partialmethod(tplan.NDDWT.route, on_card=True))
        _routes(monkeypatch, route)
    plan = _plan(shape, dtype, path="fft" if route == "fft" else "auto")
    assert plan.route(dtype, 2) == route
    x = _x(shape, dtype)
    if what == "gradient":
        x.requires_grad_()
    if what == "gradient" and route not in ("direct", "fft"):
        for call in (lambda: plan._iterate(x, 2, thr),
                     lambda: plan.dec_rec(x, 2, thr, band_axis=0)):
            with pytest.raises(RuntimeError, match="no adjoint"):
                call()
        return
    tracing.enable()
    got = plan._iterate(x, 2, thr)
    got_trace = _recorded()
    want = plan.dec_rec(x, 2, thr, band_axis=0)[1]
    assert got_trace == _recorded()
    assert torch.equal(got, want)
    if what == "gradient":
        (g_got,) = torch.autograd.grad(got.abs().sum(), x)
        (g_want,) = torch.autograd.grad(want.abs().sum(), x)
        assert torch.equal(g_got, g_want)


# -------------------------------------------------------------- the copies


# (route, shape, level); complex64.
COPY_CASES = [
    ("level", (10, 8, 12), 3),
    ("multi", (12, 10, 8), 2),
    ("flat", (8, 6, 10), 2),
    ("stage", (8, 8, 4, 6), 2),
]


@pytest.mark.parametrize("route,shape,level", COPY_CASES,
                         ids=[f"{c[0]}-{len(c[1])}d-L{c[2]}" for c in COPY_CASES])
def test_split_join_bytes_of_the_iterate(on_card, route, shape, level):
    """32 B an element in complex64: the split of ``x`` (8 read, 8 written)
    and the join of the reconstruction (the same); no band is joined."""
    _routes(on_card, route)
    plan = _plan(shape, torch.complex64)
    tracing.enable()
    plan._iterate(_x(shape, torch.complex64), level, 0.05)
    calls, counters = _recorded()
    n = torch.Size(shape).numel()
    assert counters == {"split_join_bytes": 32 * n}
    assert calls["nddwt.split"] == 1 and calls["nddwt.join"] == 1
    assert calls[f"nddwt.dec_rec.{route}.L{level}"] == 1


def _solve(solver, plan, shape, iters):
    b = torch.fft.fftn(_x(shape, torch.complex64), norm="ortho")
    mask = (_x(shape) > -0.5).float()
    if solver == "fista_cs_mri":
        return cs_recon.fista_cs_mri(plan, b, mask, 0.01, level=3, iters=iters)
    if solver == "ista_step":
        return cs_recon.ista_step(plan, b, b, mask, 0.01, 1.0, 3)
    return cs_recon.fista_inpaint(plan, mask * b, mask, 0.01, level=3, iters=iters)


@pytest.mark.parametrize("solver,iters", [("fista_cs_mri", 3), ("ista_step", 1),
                                          ("fista_inpaint", 3)])
def test_solvers_copy_32_bytes_an_element_an_iteration(on_card, solver, iters):
    """Each iteration's prox is the iterate: 32 B an element, one split and
    one join, in ``fista_cs_mri``, ``ista_step`` and the generic loop of
    ``fista_inpaint`` on complex data; the result equals a solve whose prox
    keeps the bands and drops them."""
    _routes(on_card, "level")
    shape = (10, 8, 12)
    plan = _plan(shape, torch.complex64, preserve_l2=True)
    tracing.enable()
    got = _solve(solver, plan, shape, iters)
    calls, counters = _recorded()
    tracing.disable()
    assert counters == {"split_join_bytes": iters * 32 * shape[0] * shape[1] * shape[2]}
    assert calls["nddwt.split"] == iters and calls["nddwt.join"] == iters
    on_card.setattr(tplan.NDDWT, "_iterate",
                    lambda self, x, level, thr: self.dec_rec(x, level, thr, band_axis=0)[1])
    assert torch.equal(got, _solve(solver, plan, shape, iters))


# ---------------------------------------------------- rec_levels(out=...)


# (shape, level, stages)
OUT_CASES = [
    ((64,), 3, False),
    ((16, 12), 2, False),
    ((10, 8, 12), 3, False),
    ((8, 8, 4, 6), 2, True),
]


def _bands(shape, level, stages, dtype=torch.float32):
    taps = _plan(shape, dtype).taps_hp
    return ck.dec_levels(_x(shape, dtype), taps, level, stages=stages), taps


@pytest.mark.parametrize("preserve_l2", [False, True], ids=["scaled", "l2"])
@pytest.mark.parametrize("shape,level,stages", OUT_CASES,
                         ids=[f"{len(c[0])}d-L{c[1]}" for c in OUT_CASES])
def test_rec_levels_into_out(shape, level, stages, preserve_l2):
    y, taps = _bands(shape, level, stages)
    want = ck.rec_levels(y, taps, level, preserve_l2, stages=stages)
    pair = torch.full((2,) + shape, float("nan"))
    for c in range(2):
        got = ck.rec_levels(y, taps, level, preserve_l2, pair[c], stages=stages)
        assert got.data_ptr() == pair[c].data_ptr()
        assert torch.equal(got, want)
    assert torch.equal(pair[0], pair[1])


def test_rec_levels_refuses_an_out_of_another_shape_or_dtype():
    shape = (16, 12)
    y, taps = _bands(shape, 2, False)
    for out in (torch.empty(12, 16), torch.empty(shape, dtype=torch.float64)):
        with pytest.raises(ValueError, match="out is"):
            ck.rec_levels(y, taps, 2, True, out, stages=False)


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


def _stub_launches(monkeypatch):
    """The level libraries stubbed: each launch is recorded with its
    arguments and returns 0; every new tensor is taken for a CUDA one."""
    launched = []

    class Stub:
        def __getattr__(self, name):
            return lambda *args: launched.append((name, args)) or 0

    for name in ("load", "load4", "load1"):
        monkeypatch.setattr(ck, name, lambda: Stub())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: empty(*a, **k).as_subclass(_OnCard))
    return launched


@pytest.mark.parametrize("shape,level,stages", OUT_CASES,
                         ids=[f"{len(c[0])}d-L{c[1]}" for c in OUT_CASES])
def test_the_last_launch_writes_out(monkeypatch, shape, level, stages):
    """On the wrappers' CUDA branches the last level's launch is handed the
    given buffer and no other launch is; the result is that buffer."""
    y, taps = _bands(shape, level, stages)
    launched = _stub_launches(monkeypatch)
    pair = torch.zeros((2,) + shape).as_subclass(_OnCard)
    got = ck.rec_levels(y.as_subclass(_OnCard), taps, level, True, pair[1],
                        stages=stages)
    assert got.data_ptr() == pair[1].data_ptr()
    writes = [name for name, args in launched if pair[1].data_ptr() in args]
    last = {1: "nddwt_rec1_level", 2: "nddwt_rec_level", 3: "nddwt_rec_level",
            4: "nddwt_lane_adj"}[len(shape)]
    assert writes == [last] and launched[-1][0] == last
    assert len(launched) == level * (2 if stages else 1)
