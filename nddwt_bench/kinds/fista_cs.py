"""A unit is one whole FISTA CS-MRI solve (``models.fista_cs_mri``) of a
complex volume from its undersampled k-space; the inputs cycle through
``problems`` independent phantoms, masks and noise draws."""

from __future__ import annotations

import math
from types import SimpleNamespace

from non_decimated_wavelets_tpu_torch.models import fista_cs_mri

from .. import counts, data
from ..reference import solvers
from . import port_plan, reference_bank


def setup(ctx):
    problems = [data.cs_problem(tuple(ctx.cfg["shape"]), ctx.traffic, ctx.seed, p, ctx.device)
                for p in range(ctx.traffic["problems"])]
    return SimpleNamespace(ctx=ctx, plan=port_plan(ctx.cfg, ctx.device), problems=problems)


def unit(state, i, span):
    t, p = state.ctx.traffic, i % len(state.problems)
    b, mask = state.problems[p]
    with span("bench.solve"):
        x = fista_cs_mri(state.plan, b, mask, t["lam"], level=state.ctx.cfg["level"],
                         iters=t["iters"], step=t["step"])
    return x, p


def steps_per_unit(ctx) -> int:
    return ctx.traffic["iters"]


def voxels_per_unit(ctx) -> int:
    return math.prod(ctx.cfg["shape"])


def work(ctx) -> counts.Work:
    """The solve: ``x_0 = F^H M b`` once, then per iteration two FFTs, the
    masked residual (reads ``F z``, ``b`` and ``M``, writes ``r``), the
    gradient step (reads ``z`` and ``F^H r``, writes ``v``), the analysis and
    synthesis of both components of ``v``, and the momentum (reads two
    iterates, writes ``z``)."""
    n = math.prod(ctx.cfg["shape"])
    real = counts.WORD[ctx.cfg["dtype"]]
    c = 2 * real
    level = ctx.cfg["level"]
    per_iter = (2 * counts.fft(n, c) + counts.elementwise(n, [c, c, real, c])
                + counts.elementwise(n, [c, c, c]) + 2 * counts.transform(ctx.cfg, 2, level)
                + counts.elementwise(n, [c, c, c]))
    first = counts.elementwise(n, [c, real, c]) + counts.fft(n, c)
    return first + ctx.traffic["iters"] * per_iter


def release(state) -> None:
    state.plan = None


def reference(state, index: int, precision: str):
    ctx, t = state.ctx, state.ctx.traffic
    b, mask = state.problems[index]
    bank = reference_bank(ctx.cfg, precision, ctx.device)
    return solvers.fista_cs_mri(b, mask, bank, ctx.cfg["level"], t["lam"], t["iters"], t["step"])
