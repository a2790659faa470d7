"""Every route and kernel body the port picks, held to a table recorded
before one router decided them (``tests/data/torch_route_table.json``).

The table was recorded on the CPU from the port as it stood before
``NDDWT.route`` became the only place a route is chosen and the level
wrappers the only place a level body is chosen; this module asks the same
questions of the port as it is:

* ``NDDWT.route`` on the card, on 1D-5D shapes on both sides of
  ``ITER_MAX_NUMEL``, ``FLAT_MAX_NUMEL`` and ``MULTI_MAX_NUMEL``, db1, db4,
  db12, db15, db20 and mixed filters, float32, bfloat16, float64, complex64
  and complex128 data, split pairs, batches of 0, 2 and 15, levels 1 and 3;
  the route of a whole ``dec_rec_n`` chain (``iter`` where one
  ``nddwt_flat_iter`` launch runs it); and the route of ``fista_inpaint``
  and ``fista_inpaint_split`` solves (``cs_recon._solve_route``) with a
  scalar and a tensor ``lam``. A value ``!<Error>`` is the error raised.
* ``path`` ``fft``, ``direct`` and ``pallas``, on and off the card.
* The body and geometry of ``nddwt_dec_level`` and ``nddwt_rec_level``
  launches (``dec_stream_args``, ``rec_stream_args``; ``_dec_body``,
  ``_rec_body``) at knee3d's (320, 320, 256), 256^3, (24, 40, 72) and a 2D
  slice, db1-db5, each dtype, inputs on 16 bytes and one element off them.
* The lane stages' body (``lane`` or ``tile``) and plan
  (``_stage_geometry``).

A solve beyond the flat kernel in 5D, which no route serves, was named
``stepped`` and raised at its first iterate; it now raises before.
"""

import json
from functools import partialmethod
from pathlib import Path

import pytest
import torch

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import plan as tplan
from non_decimated_wavelets_tpu_torch.models import cs_recon
from non_decimated_wavelets_tpu_torch.ops import cuda_kernels as ck

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)

TABLE = json.loads((Path(__file__).parent / "data" / "torch_route_table.json").read_text())
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64,
          "c64": torch.complex64, "c128": torch.complex128}


def _attempt(fn):
    try:
        return fn()
    except (NotImplementedError, ValueError) as e:
        return "!" + type(e).__name__


def _wavelet(w):
    return w if isinstance(w, str) else tuple(w)


def _id(entry):
    return f"{entry['shape']}-{entry['wavelet']}".replace(" ", "")


@pytest.fixture
def on_card(monkeypatch):
    """Plans route every tensor as one on the card."""
    monkeypatch.setattr(tplan.NDDWT, "route", partialmethod(tplan.NDDWT.route, on_card=True))


@pytest.mark.parametrize("entry", TABLE["routes"], ids=_id)
def test_routes_are_the_recorded_ones(on_card, entry):
    shape = tuple(entry["shape"])
    plan = tw.NDDWT(_wavelet(entry["wavelet"]), shape, device="cpu")
    got = []
    for key in TABLE["route_keys"]:
        name, b, lvl = key.split("/")
        dt, level = DTYPES[name], int(lvl[1:])
        if b == "pair":
            got.append(_attempt(lambda: plan.route(dt, level, pair=True)))
        else:
            got.append(_attempt(lambda: plan.route(dt, level, batch=int(b[1:]))))
    assert dict(zip(TABLE["route_keys"], got)) == dict(zip(TABLE["route_keys"], entry["route"]))
    chains = [_attempt(lambda: plan.route(DTYPES[key.split("/")[0]], int(key[-1]), whole=True))
              for key in TABLE["dec_rec_n_keys"]]
    assert chains == entry["dec_rec_n"]
    for key, want in zip(TABLE["solve_keys"], entry["solve"]):
        name, kind, lam, lvl = key.split("/")
        split, level = kind == "split", int(lvl[1:])
        b = torch.empty(((2,) if split else ()) + shape, dtype=DTYPES[name], device="meta")
        lam = 0.1 if lam == "scalar" else torch.tensor(0.1)
        got = _attempt(lambda: cs_recon._solve_route(plan, b, lam, level, split))
        if want == "stepped" and got == "!NotImplementedError":  # no route serves it
            assert _attempt(lambda: plan.route(b.dtype, level, pair=split)) == got, key
            continue
        assert got == want, key
    assert plan.route(torch.float32, 3, on_card=False) == "direct"


@pytest.mark.parametrize("entry", TABLE["paths"],
                         ids=lambda e: f"{e['shape']}-{e['path']}-{e['on_card']}".replace(" ", ""))
def test_paths_are_the_recorded_ones(entry):
    plan = tw.NDDWT(entry["wavelet"], tuple(entry["shape"]), path=entry["path"], device="cpu")
    on = entry["on_card"]
    assert _attempt(lambda: plan.route(torch.float32, 3, on_card=on)) == entry["route"]
    assert _attempt(lambda: plan.route(torch.float32, 3, pair=True, on_card=on)) == entry["pair"]


def _geometry(geo):
    n, k, t, left, bit, vpad, _ = geo
    return [list(map(int, v)) for v in (n, k, t, left, bit)] + [list(map(bool, vpad))]


@pytest.mark.parametrize("entry", TABLE["bodies"], ids=lambda e: "-".join(
    str(e.get(k)) for k in ("kind", "band0", "shape", "wavelet", "dtype", "shift")).replace(" ", ""))
def test_level_bodies_are_the_recorded_ones(entry):
    """The body a level launch runs and the plan it is given; stride-0 views
    stand in for the arrays, whose addresses and dtypes alone matter."""
    shape, dt, shift = tuple(entry["shape"]), DTYPES[entry["dtype"]], entry["shift"]
    taps = tw.NDDWT(entry["wavelet"], shape, device="cpu").taps_hp
    approx = torch.empty(2, dtype=dt)[shift:shift + 1].reshape((1,) * len(shape)).expand(shape)
    if entry["kind"] == "dec":
        geo, body = ck.dec_stream_args(approx, shape, taps)
        n, k, _, _, _, vpad, _ = geo
        ask = ck._dec_body(n, k, vpad, dt, [approx.data_ptr()])
    else:
        nb = 2 ** len(shape)
        y = torch.empty(2, dtype=dt)[:1].reshape((1,) * (len(shape) + 1)).expand(
            (2 * nb - 1,) + shape)
        src = ([("y", b) for b in range(nb)] if entry["band0"] == "y"
               else [("a", 0)] + [("y", nb + b - 1) for b in range(1, nb)])
        _, _, geo, body = ck.rec_stream_args(y, approx, src, taps)
        n, k, _, _, _, vpad, _ = geo
        ptrs = [y.data_ptr()] + ([approx.data_ptr()] if entry["band0"] == "a" else [])
        ask = ck._rec_body(n, k, vpad, dt, ptrs)
    assert (body, ask, _geometry(geo)) == (entry["body"], entry["ask"], entry["geometry"])


@pytest.mark.parametrize("entry", TABLE["lanes"],
                         ids=lambda e: f"{e['shape']}-{e['wavelet']}-{e['dtype']}-{e['adj']}"
                         .replace(" ", ""))
def test_lane_bodies_are_the_recorded_ones(entry):
    shape = tuple(entry["shape"])
    taps = tw.NDDWT(entry["wavelet"], (80,) * len(shape), device="cpu").taps_hp
    got = _attempt(lambda: ck._stage_geometry(shape, taps, True, entry["adj"],
                                              DTYPES[entry["dtype"]]))
    if isinstance(got, str):
        assert got == entry["body"]
        return
    (_, _, t, _, _), body = got
    assert (body, list(t)) == (entry["body"], entry["plan"])
