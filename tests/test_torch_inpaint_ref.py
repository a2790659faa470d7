"""The port's inpainting solve against the benchmark's plain reference
(``nddwt_bench/reference/inpaint.py``), and its span and the flat kernels'
counters (CPU).

* ``models.fista_inpaint`` on a CPU plan (the generic loop) and
  ``flat.fista_flat`` on CPU tensors (its plain version,
  ``flat_iter_ref``) against the float64 reference, on seeded random
  images and masks. Tolerances, relative to max|reference|: float64 1e-10,
  as the solvers' tests (the same iteration, transforms convolved here and
  multiplied in the frequency domain there, measured ~1e-14); float32 1e-5,
  the solvers' float32 tolerance (tests/test_torch_cs_recon.py: twenty
  iterations of float32 transforms against float64 ones, measured ~1e-6).
* The counters ``flat_passes`` and ``flat_window_bytes`` of a launch (the
  wrappers' CUDA branch against a stub library) against a count from the
  plan's tile and axis groups made here.
* The solve's span ``nddwt.fista_inpaint.<route>.L<level>`` with tracing
  on, and nothing recorded with it off.

Nothing here imports JAX.
"""

import contextlib
import math
import sys
import types
from functools import partialmethod
from pathlib import Path

import pytest
import torch

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import plan as tplan
from non_decimated_wavelets_tpu_torch import tracing
from non_decimated_wavelets_tpu_torch.models import cs_recon
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import flat

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from nddwt_bench.reference import inpaint, nddwt_fft  # noqa: E402

sys.path.pop(0)

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)

# (shape, wavelet, level, preserve_l2)
CASES = [((33, 24), ("db1", "db3"), 3, True), ((20, 18), "db4", 2, False)]
LAM, ITERS, STEP = 0.05, 20, 1.0
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


@pytest.fixture(autouse=True)
def clean():
    """Every test starts and ends with tracing off and nothing recorded."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _problem(shape, seed=7):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    mask = (torch.rand(shape, generator=g, dtype=torch.float64) < 0.5).double()
    return mask * x, mask


def _reference(shape, wv, level, pl2, b, mask):
    bank = nddwt_fft.FilterBank(wv, shape, pl2, nddwt_fft.Precision("float64"), "cpu")
    return inpaint.fista_inpaint(b, mask, bank, level, LAM, ITERS, STEP)


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("shape,wv,level,pl2", CASES, ids=["db1-db3", "db4"])
def test_solvers_match_the_reference(shape, wv, level, pl2, dtype):
    b, mask = _problem(shape)
    want = _reference(shape, wv, level, pl2, b, mask)
    plan = tw.NDDWT(wv, shape, preserve_l2=pl2, dtype=dtype, device="cpu")
    bd, md = b.to(dtype), mask.to(dtype)
    loop = cs_recon.fista_inpaint(plan, bd, md, LAM, level=level, iters=ITERS, step=STEP)
    lams, moms = cs_recon._fista_schedule(ITERS, LAM, STEP)
    fused = flat.fista_flat(bd, md, plan.taps_hp, level, pl2, lams, moms, STEP)
    assert loop.dtype == fused.dtype == dtype
    assert _rel(loop, want) <= TOL[dtype]
    assert _rel(fused, want) <= TOL[dtype]


def test_the_reference_is_not_the_start():
    """Twenty iterations move far from ``M b``, and one fewer is off by
    more than the float32 tolerance: the comparison sees the solve."""
    shape, wv, level, pl2 = CASES[0]
    b, mask = _problem(shape)
    bank = nddwt_fft.FilterBank(wv, shape, pl2, nddwt_fft.Precision("float64"), "cpu")
    want = inpaint.fista_inpaint(b, mask, bank, level, LAM, ITERS, STEP)
    short = inpaint.fista_inpaint(b, mask, bank, level, LAM, ITERS - 1, STEP)
    assert _rel(mask * b, want) > 0.1
    assert _rel(short, want) > 10 * TOL[torch.float32]


# ---------------------------------------------------------- the counters


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def stub_library(monkeypatch):
    """The flat kernels' library stubbed: a launch returns 0; plans route
    as on the card."""
    class Stub:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(flat, "load", lambda: Stub())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: empty(*a, **k).as_subclass(_OnCard))
    monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=True))
    return monkeypatch


def _hand_count(shape, k, plan, word):
    """One level's passes (one an axis group and direction) and the bytes
    its analysis and synthesis passes copy, from the tile and the groups:
    an analysis unit is a tile and a parent node of the group's first axis
    (``2^a0`` a tile), its window the tile and ``K - 1`` halo on the
    group's axes; a synthesis unit is a tile and an output node
    (``2^(d - a1)`` a tile), with ``2^m`` such windows."""
    d, tiles = len(shape), math.prod(-(-n // t) for n, t in zip(shape, plan.tile))
    ana = syn = 0
    a0 = 0
    for a1 in plan.ends:
        win = math.prod(t + (kk - 1 if a0 <= ax < a1 else 0)
                        for ax, (t, kk) in enumerate(zip(plan.tile, k)))
        ana += tiles * 2**a0 * win * word
        syn += tiles * 2 ** (d - a1) * win * 2 ** (a1 - a0) * word
        a0 = a1
    return len(plan.ends), ana, syn


# (call, shape, wavelet, level, dtype): each one launch of a flat kernel.
COUNT_CASES = [
    ("fista", (33, 24), ("db1", "db3"), 3, torch.float32),
    ("fista", (20, 18, 6), "db2", 2, torch.float64),
    ("pair", (33, 24), ("db1", "db3"), 3, torch.float32),
    ("dec", (20, 18), "db4", 2, torch.float32),
    ("rec", (20, 18), "db4", 2, torch.float32),
]


@pytest.mark.parametrize("call,shape,wv,level,dtype", COUNT_CASES,
                         ids=[f"{c[0]}-{len(c[1])}d-{c[4]}" for c in COUNT_CASES])
def test_counters_of_a_launch(stub_library, call, shape, wv, level, dtype):
    plan = tw.NDDWT(wv, shape, preserve_l2=True, dtype=dtype, device="cpu")
    b, mask = (t.to(dtype).as_subclass(_OnCard) for t in _problem(shape))
    tracing.enable()
    before = dict(ck.launch_counts)
    if call == "fista":
        cs_recon.fista_inpaint(plan, b, mask, LAM, level=level, iters=7)
    elif call == "pair":
        plan.dec_rec(b, level, 0.1)
    elif call == "dec":
        plan.dec(b, level)
    else:
        plan.rec(torch.zeros((plan.num_bands(level),) + shape, dtype=dtype)
                 .as_subclass(_OnCard), band_axis=0)
    kernel = "nddwt_flat_iter" if call == "fista" else "nddwt_flat_pair"
    launched = {k: v - before[k] for k, v in ck.launch_counts.items() if v != before[k]}
    assert launched == {kernel: 1}
    k = tuple(int(t.shape[1]) for t in plan.taps_hp)
    word = 8 if dtype == torch.float64 else 4
    fp = flat._flat_plan(shape, k, dtype, 0)
    groups, ana, syn = _hand_count(shape, k, fp, word)
    lg = level * groups
    want = {"fista": (2 * lg * 7, 7 * level * (ana + syn)),
            "pair": (2 * lg, level * (ana + syn)),
            "dec": (1 + lg, level * ana),
            "rec": (lg - 1, level * syn)}[call]
    counters = tracing.summary()["counters"]
    assert (counters["flat_passes"], counters["flat_window_bytes"]) == want
    # The plan's own layout counts the same windows.
    lay = flat.flat_layout(shape, k, fp.tile, fp.ends, 1, word)
    assert word * sum(p["window"] * p["units"] for p in lay["passes"]) == ana + syn


def test_img2d_counts_at_its_shape():
    """The benchmark's img2d solve: (264, 264), db1 and db3, L3, float32 in
    one axis group of (17, 17) tiles; 6 passes an iteration, 2.03 MB of
    windows a level."""
    k = (2, 6)
    plan = flat._flat_plan((264, 264), k, torch.float32, 0)
    assert (plan.ends, plan.tile) == ((2,), (17, 17))
    groups, ana, syn = _hand_count((264, 264), k, plan, 4)
    assert (groups, ana, syn) == flat._level_work((264, 264), k, torch.float32, 0)
    assert (2 * 3 * groups * 100, 300 * (ana + syn)) == (600, 608_256_000)


def test_no_counts_with_tracing_off(stub_library):
    plan = tw.NDDWT(("db1", "db3"), (33, 24), device="cpu")
    b, mask = (t.float().as_subclass(_OnCard) for t in _problem((33, 24)))
    cs_recon.fista_inpaint(plan, b, mask, LAM, level=3, iters=3)
    assert tracing.summary() == {"spans": {}, "paths": {}, "counters": {}}


# --------------------------------------------------------------- the span


def _solve_spans():
    return {name: v["calls"] for name, v in tracing.summary()["spans"].items()
            if name.startswith("nddwt.fista_inpaint")}


@pytest.mark.parametrize("route", ["flat", "stepped", "direct", "split"])
def test_the_solve_span_names_its_route(monkeypatch, route):
    shape, level = (33, 24), 3
    plan = tw.NDDWT(("db1", "db3"), shape, preserve_l2=True, device="cpu")
    b, mask = (t.float() for t in _problem(shape))
    if route != "direct":
        monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=True))
    if route == "stepped":
        monkeypatch.setattr(flat, "ITER_MAX_NUMEL", 0)
    tracing.enable()
    if route == "split":
        cs_recon.fista_inpaint_split(plan, torch.stack([b, b]), mask, LAM, level, 3)
        assert _solve_spans() == {f"nddwt.fista_inpaint_split.flat.L{level}": 1}
        return
    cs_recon.fista_inpaint(plan, b, mask, LAM, level, 3)
    name = f"nddwt.fista_inpaint.{route}.L{level}"
    assert _solve_spans() == {name: 1}
    inner = {path[1:] for path in tracing.summary()["paths"] if path[0] == name}
    if route == "flat":  # one launch (its plain version here), no plan call
        assert inner == {()}
    else:  # the iterates' own spans, nested in the solve's
        assert (f"nddwt.dec_rec.{'flat' if route == 'stepped' else 'direct'}.L{level}",) \
            in inner
    tracing.disable()
    tracing.reset()
    cs_recon.fista_inpaint(plan, b, mask, LAM, level, 3)
    assert tracing.summary()["spans"] == {}


def test_a_tensor_lam_names_the_transforms_route():
    plan = tw.NDDWT("db4", (20, 18), device="cpu")
    b, mask = (t.float() for t in _problem((20, 18)))
    tracing.enable()
    cs_recon.fista_inpaint(plan, b, mask, torch.tensor(LAM), 2, 2)
    assert _solve_spans() == {"nddwt.fista_inpaint.direct.L2": 1}
