"""The port's spans and counters (``non_decimated_wavelets_tpu_torch/
tracing.py``) on the CPU, and the benchmark's readers of them.

* Off: one shared null context, nothing recorded, no clock read.
* On through ``enable()``: calls, totals and self times of nested spans
  on a fake clock; the counters; on inside a ``torch.profiler`` window
  only, where each span is a host operation of the profile and no user
  annotation.
* The plan on its kernel route with the device check stubbed, so that the
  wrappers run their plain versions: each public call's span names its
  route and level, and ``split_join_bytes`` matches the bytes counted by
  hand; ``NDDWT.route`` of the benchmark's configurations from shapes
  alone.
* The wrappers' CUDA branches against a stub library: each
  ``nddwt.launch.<kernel>`` span runs once per count in ``launch_counts``.
* The readers of ``plan_host_ms``, ``launch_host_us`` and
  ``split_join_gb`` (``nddwt_bench/metrics/``), and their None for a
  program without spans.

Nothing here imports JAX.
"""

import contextlib
import sys
import types
from functools import partialmethod
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import plan as tplan
from non_decimated_wavelets_tpu_torch import tracing
from non_decimated_wavelets_tpu_torch.models import cs_recon
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck
from non_decimated_wavelets_tpu_torch.ops import elemwise, flat, multi

ROOT = Path(__file__).resolve().parents[1]
# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean():
    """Every test starts and ends with tracing off and nothing recorded."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture
def traced():
    tracing.enable()
    return tracing


@pytest.fixture
def fake_clock(monkeypatch):
    """``perf_counter_ns`` of the tracing module read from a list."""
    ticks = []
    monkeypatch.setattr(tracing, "time",
                        types.SimpleNamespace(perf_counter_ns=lambda: ticks.pop(0)))
    return ticks


def _span_calls(prefix=""):
    return {name: v["calls"] for name, v in tracing.summary()["spans"].items()
            if name.startswith(prefix)}


# ------------------------------------------------------------- the module


def test_off_is_one_shared_null_context(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read with tracing off")

    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter_ns=no_clock))
    a, b = tracing.span("nddwt.a"), tracing.span("nddwt.b")
    assert a is b
    with a as s:
        assert s is None
        tracing.count("split_join_bytes", 7)
    assert tracing.summary() == {"spans": {}, "paths": {}, "counters": {}}


def test_nested_spans_on_a_fake_clock(traced, fake_clock):
    fake_clock += [0, 10, 40, 50, 55, 100, 200, 230]
    with tracing.span("outer") as s:
        assert s is not None
        with tracing.span("inner"):
            pass
        with tracing.span("inner"):
            pass
    with tracing.span("inner"):
        pass
    got = tracing.summary()
    assert got["spans"]["outer"] == {"calls": 1, "total_ns": 100, "self_ns": 65}
    assert got["spans"]["inner"] == {"calls": 3, "total_ns": 65, "self_ns": 65}
    assert got["paths"][("outer", "inner")] == {"calls": 2, "total_ns": 35, "self_ns": 35}
    assert got["paths"][("inner",)] == {"calls": 1, "total_ns": 30, "self_ns": 30}
    assert not fake_clock


def test_a_span_closes_when_its_body_raises(traced, fake_clock):
    fake_clock += [0, 1, 5, 9]
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("inner"):
                raise ValueError("body")
    assert tracing.summary()["spans"]["outer"] == {"calls": 1, "total_ns": 9, "self_ns": 5}
    assert not tracing._local.stack


def test_counters_and_reset(traced):
    tracing.count("split_join_bytes", 3)
    tracing.count("split_join_bytes", 4)
    assert tracing.summary()["counters"] == {"split_join_bytes": 7}
    tracing.reset()
    assert tracing.summary()["counters"] == {}
    tracing.disable()
    tracing.count("split_join_bytes", 4)
    assert tracing.summary()["counters"] == {}


def test_on_inside_a_profiler_window_only():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("nddwt.outer") as outer:
            with tracing.span("nddwt.inner"):
                torch.ones(4).add_(1)
    assert outer is not None
    with tracing.span("nddwt.after") as after:
        assert after is None
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("nddwt.")]
    assert sorted(e.name() for e in events) == ["nddwt.inner", "nddwt.outer"]
    assert not any(e.is_user_annotation() for e in events)
    assert all(e.device_type() == torch.autograd.DeviceType.CPU for e in events)
    assert set(tracing.summary()["spans"]) == {"nddwt.outer", "nddwt.inner"}


# ------------------------------------------------ the plan's entry spans


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


def _x(shape, complex_=False, lead=()):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(lead + shape, generator=g)
    return torch.complex(x, torch.randn(lead + shape, generator=g)) if complex_ else x


# (op, shape, complex data, route); each runs on the kernel route.
ENTRY_CASES = [
    ("dec", (16, 12), False, "flat"),
    ("dec", (16, 12), True, "multi"),
    ("rec", (16, 12, 10), False, "level"),
    ("dec_rec", (8, 8, 4, 6), True, "stage"),
    ("dec_rec", (64,), False, "level"),
    ("dec_rec_n", (16, 12), False, "flat"),
    ("dec_batched", (16, 12), True, "multi"),
    ("rec_batched", (8, 8, 6), False, "level"),
    ("dec_split", (16, 12), False, "flat"),
    ("rec_split", (16, 12), False, "multi"),
    ("dec_rec_split", (12, 8, 10), False, "level"),
]


def _call(plan, op, shape, complex_, level):
    if op in ("dec", "dec_rec"):
        x = _x(shape, complex_)
        return plan.dec(x, level) if op == "dec" else plan.dec_rec(x, level, 0.1)
    if op == "rec":
        return plan.rec(plan.dec(_x(shape, complex_), level, band_axis=0), band_axis=0)
    if op == "dec_rec_n":
        return plan.dec_rec_n(_x(shape), level, [0.2, 0.1])
    if op in ("dec_batched", "rec_batched"):
        y = plan.dec_batched(_x(shape, complex_, (3,)), level)
        return y if op == "dec_batched" else plan.rec_batched(y)
    if op in ("dec_split", "rec_split"):
        y = plan.dec_split(_x(shape, lead=(2,)), level)
        return y if op == "dec_split" else plan.rec_split(y)
    return plan.dec_rec_split(_x(shape, lead=(2,)), level, 0.1)


@pytest.mark.parametrize("op,shape,complex_,route", ENTRY_CASES,
                         ids=[f"{c[0]}-{c[3]}-{len(c[1])}d" for c in ENTRY_CASES])
def test_entry_span_names_its_route(on_card, traced, op, shape, complex_, route):
    _routes(on_card, route)
    level = 2
    plan = tw.NDDWT("db2", shape, device="cpu")
    dtype = torch.complex64 if complex_ else torch.float32
    assert plan.route(dtype, level, pair=op.endswith("split"),
                      batch=3 if op.endswith("batched") else 0, on_card=True) == route
    _call(plan, op, shape, complex_, level)
    entries = {name for name in _span_calls("nddwt.")
               if name.count(".") == 3 and not name.startswith("nddwt.launch")}
    assert f"nddwt.{op}.{route}.L{level}" in entries
    assert {name.split(".")[2] for name in entries} == {route}


@pytest.mark.parametrize("path", ["fft", "direct"])
def test_entry_span_on_the_torch_paths(traced, path):
    plan = tw.NDDWT("db2", (16, 12), device="cpu", path=path)
    plan.dec_rec(_x((16, 12), True), 3, 0.1)
    assert _span_calls("nddwt.dec_rec") == {f"nddwt.dec_rec.{path}.L3": 1}
    assert tw.NDDWT("db2", (16, 12), device="cpu").route(torch.float32, 3) == "direct"


def test_nested_entries_and_the_solver_phases(on_card, traced):
    _routes(on_card, "level")
    plan = tw.NDDWT("db2", (16, 12), device="cpu", preserve_l2=True)
    plan.dec_rec_n(_x((16, 12)), 2, [0.3, 0.2, 0.1])
    paths = tracing.summary()["paths"]
    assert paths[("nddwt.dec_rec_n.level.L2",)]["calls"] == 1
    assert paths[("nddwt.dec_rec_n.level.L2", "nddwt.dec_rec.level.L2")]["calls"] == 3
    tracing.reset()
    b = torch.fft.fftn(_x((16, 12), True), norm="ortho")
    cs_recon.fista_cs_mri(plan, b, torch.ones(16, 12), 0.01, level=2, iters=3)
    calls = _span_calls("nddwt.solve")
    assert calls == dict.fromkeys(["nddwt.solve.iter", "nddwt.solve.data",
                                   "nddwt.solve.prox", "nddwt.solve.momentum"], 3)
    prox = ("nddwt.solve.iter", "nddwt.solve.prox", "nddwt.dec_rec.level.L2")
    assert tracing.summary()["paths"][prox]["calls"] == 3


# -------------------------------------------------- the split and join count


def test_split_join_bytes_of_a_complex_dec_rec_on_the_level_route(on_card, traced):
    """384 B an element at 3D L3 in complex64 (22 bands): the split (8 read,
    8 written), the join of the bands (22 x 16) and the join of the result
    (16); the two components' syntheses write the pair in place."""
    _routes(on_card, "level")
    shape = (10, 8, 12)
    plan = tw.NDDWT("db2", shape, device="cpu")
    plan.dec_rec(_x(shape, True), 3, 0.05)
    n = 10 * 8 * 12
    assert tracing.summary()["counters"] == {"split_join_bytes": 384 * n}
    assert _span_calls("nddwt.split") == {"nddwt.split": 1}
    assert _span_calls("nddwt.join") == {"nddwt.join": 2}


def test_split_join_bytes_of_a_complex_batch_on_the_multilevel_route(on_card, traced):
    """5,280 B an element of one item for 15 complex64 items at 2D L3 (10
    bands): the batch split (15 x 16), the join of the bands (15 x 160), the
    split of the bands (the same) and the join of the result (15 x 16)."""
    shape, items = (16, 12), 15
    plan = tw.NDDWT("db4", shape, device="cpu")
    y = plan.dec_batched(_x(shape, True, (items,)), 3)
    plan.rec_batched(y)
    assert set(_span_calls("nddwt.")) == {
        "nddwt.dec_batched.multi.L3", "nddwt.rec_batched.multi.L3",
        "nddwt.split", "nddwt.join"}
    assert tracing.summary()["counters"] == {"split_join_bytes": 5280 * 16 * 12}


def test_routes_of_the_benchmark_configurations(monkeypatch):
    """From shapes alone: the (320, 320, 256) complex db4 L3 knee volume
    takes the per-level kernels, a batch of 15 complex (640, 368) coil
    images the multilevel ones; nothing of those sizes is allocated."""
    for name in ("empty", "zeros", "ones"):
        real = getattr(torch, name)

        def small(*a, _real=real, **k):
            t = _real(*a, **k)
            assert t.numel() < 2**20, "a route is decided from shapes"
            return t

        monkeypatch.setattr(torch, name, small)
    knee3d = tw.NDDWT("db4", (320, 320, 256), preserve_l2=True, device="cpu")
    assert knee3d.route(torch.complex64, 3, on_card=True) == "level"
    assert knee3d.route(torch.float32, 3, on_card=True) == "level"
    knee2d = tw.NDDWT("db4", (640, 368), preserve_l2=True, device="cpu")
    assert knee2d.route(torch.complex64, 3, batch=15, on_card=True) == "multi"
    assert knee2d.route(torch.complex64, 3, on_card=False) == "direct"


# ------------------------------------------------ launches, stub library


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def stub_library(monkeypatch):
    """Every kernel library stubbed: a launch is recorded and returns 0;
    plans route as on the card."""
    launched = []

    class Stub:
        def __getattr__(self, name):
            return lambda *args: launched.append(name) or 0

    for module, name in ((ck, "load"), (ck, "load4"), (ck, "load1"), (flat, "load"),
                         (multi, "load"), (elemwise, "load")):
        monkeypatch.setattr(module, name, lambda: Stub())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: empty(*a, **k).as_subclass(_OnCard))
    monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=True))
    return monkeypatch


def _launch_case(case):
    """The calls of one case on ``_OnCard`` tensors, real or complex."""
    def card(t):
        return t.as_subclass(_OnCard)

    if case == "flat":
        p = tw.NDDWT("db2", (16, 12), device="cpu")
        p.dec_rec(card(_x((16, 12), True)), 2, 0.1)
        p.dec_rec_n(card(_x((16, 12))), 2, [0.2, 0.1])
    elif case == "multi":
        p = tw.NDDWT("db2", (16, 12), device="cpu")
        p.dec_rec(card(_x((16, 12), True)), 3, 0.1)
    elif case == "level":
        p = tw.NDDWT("db2", (8, 8, 8), device="cpu")
        p.dec_rec(card(_x((8, 8, 8), True)), 2, 0.1)
    elif case == "stage":
        p = tw.NDDWT("db2", (8, 8, 4, 6), device="cpu")
        p.rec(p.dec(card(_x((8, 8, 4, 6))), 2))
    elif case == "1d":
        p = tw.NDDWT("db2", (64,), device="cpu")
        p.dec_rec(card(_x((64,))), 2, 0.1)
    else:  # the stepped inpainting solve: the flat pair and the glue pass
        p = tw.NDDWT("db2", (16, 12), device="cpu")
        m = card((_x((16, 12)) > 0).float())
        cs_recon.fista_inpaint(p, card(_x((16, 12))) * m, m, 0.01, 2, iters=3)


LAUNCH_CASES = {
    "flat": {"nddwt_flat_pair", "nddwt_flat_iter"},
    "multi": {"nddwt_dec_multi", "nddwt_mag_shrink_pair", "nddwt_rec_multi"},
    "level": {"nddwt_dec_level", "nddwt_mag_shrink_pair", "nddwt_rec_level"},
    "stage": {"nddwt_lane_dec", "nddwt_lead_dec", "nddwt_lead_adj", "nddwt_lane_adj"},
    "1d": {"nddwt_dec1_level", "nddwt_rec1_level"},
    "stepped": {"nddwt_flat_pair", "nddwt_fista_step"},
}


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_launch_spans_equal_launch_counts(stub_library, traced, case):
    if case in ("multi", "level", "stage", "1d"):
        _routes(stub_library, "multi" if case == "multi" else "level")
    if case == "stepped":
        stub_library.setattr(flat, "ITER_MAX_NUMEL", 0)
    before = dict(ck.launch_counts)
    _launch_case(case)
    counted = {k: v - before[k] for k, v in ck.launch_counts.items() if v != before[k]}
    spans = {name.removeprefix("nddwt.launch."): calls
             for name, calls in _span_calls("nddwt.launch.").items()}
    assert set(counted) == LAUNCH_CASES[case]
    assert spans == counted


def test_every_kernel_has_a_launch_span():
    assert set().union(*LAUNCH_CASES.values()) == set(ck.launch_counts)


# ------------------------------------------------ the benchmark's readers


def _reader(metric):
    sys.path.insert(0, str(ROOT))
    try:
        from nddwt_bench import harness
    finally:
        sys.path.remove(str(ROOT))
    return harness.reader(ROOT / "nddwt_bench", metric)


def _rec(metric, steps):
    return types.SimpleNamespace(steps=steps, notes={}, metric=metric)


def test_readers_of_a_traced_coil_step(stub_library, traced):
    shape, items, steps = (16, 12), 15, 2
    plan = tw.NDDWT("db4", shape, device="cpu")
    for _ in range(steps):
        y = plan.dec_batched(_x(shape, True, (items,)).as_subclass(_OnCard), 3)
        plan.rec_batched(y)
    rec = _rec("plan_host_ms.coil", steps)
    got = tracing.summary()
    outer = sum(got["spans"][f"nddwt.{op}.multi.L3"]["total_ns"]
                for op in ("dec_batched", "rec_batched"))
    assert _reader("plan_host_ms.coil")(rec) == pytest.approx(1e-6 * outer / steps)
    spans = rec.notes["plan_host_ms.coil spans a step"]
    assert spans["nddwt.dec_batched.multi.L3"]["calls"] == 1
    assert spans["nddwt.split"]["calls"] == 2 and spans["nddwt.join"]["calls"] == 2
    rec = _rec("launch_host_us.coil", steps)
    launches = [got["spans"][f"nddwt.launch.nddwt_{d}_multi"] for d in ("dec", "rec")]
    want = 1e-3 * sum(v["total_ns"] for v in launches) / 4
    assert _reader("launch_host_us.coil")(rec) == pytest.approx(want)
    assert rec.notes["launch_host_us.coil launches a step"] == 2
    split = _reader("split_join_gb.coil")(_rec("split_join_gb.coil", steps))
    assert split == pytest.approx(5280 * 16 * 12 / 1e9, rel=1e-12)


def test_plan_host_ms_counts_outermost_entries_only(on_card, traced):
    _routes(on_card, "level")
    plan = tw.NDDWT("db2", (16, 12), device="cpu")
    plan.dec_rec_n(_x((16, 12)), 2, [0.2, 0.1])
    outer = tracing.summary()["spans"]["nddwt.dec_rec_n.level.L2"]["total_ns"]
    assert _reader("plan_host_ms.cs")(_rec("plan_host_ms.cs", 1)) == pytest.approx(1e-6 * outer)


@pytest.mark.parametrize("metric", ["plan_host_ms.coil", "launch_host_us.coil",
                                    "split_join_gb.cs", "plan_host_ms.inpaint",
                                    "flat_passes.inpaint", "flat_window_mb.inpaint"])
def test_readers_find_nothing_without_spans(monkeypatch, metric):
    assert _reader(metric)(_rec(metric, 4)) is None  # nothing recorded
    # A program without the tracing module, as before it existed.
    monkeypatch.delattr(tw, "tracing")
    monkeypatch.setitem(sys.modules, "non_decimated_wavelets_tpu_torch.tracing", None)
    assert _reader(metric)(_rec(metric, 4)) is None
