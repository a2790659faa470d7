"""A unit is one whole FISTA inpainting solve (``models.fista_inpaint``) of
a real image from a random share of its pixels; the inputs alternate
between ``problems`` independent images, masks and noise draws."""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch
from non_decimated_wavelets_tpu_torch.models import fista_inpaint

from .. import counts, data
from ..reference import inpaint
from . import port_plan, reference_bank


def problem(shape, traffic: dict, seed: int, index: int, device):
    """One inpainting problem: the observation ``b = M (x + noise)`` of the
    real magnitude of a phantom ``x`` (max 1) with Gaussian noise
    (``data.magnitude_volume``), and its i.i.d. Bernoulli(``mask_density``)
    pixel mask ``M`` (float32), drawn from a stream of its own."""
    x, _ = data.magnitude_volume(shape, traffic, seed, index, device)
    g = data.generator(seed, 400 + index, device)
    mask = (torch.rand(shape, generator=g, device=device)
            < traffic["mask_density"]).to(torch.float32)
    return mask * x, mask


def setup(ctx):
    problems = [problem(tuple(ctx.cfg["shape"]), ctx.traffic, ctx.seed, p, ctx.device)
                for p in range(ctx.traffic["problems"])]
    return SimpleNamespace(ctx=ctx, plan=port_plan(ctx.cfg, ctx.device), problems=problems)


def unit(state, i, span):
    t, p = state.ctx.traffic, i % len(state.problems)
    b, mask = state.problems[p]
    with span("bench.solve"):
        x = fista_inpaint(state.plan, b, mask, t["lam"], level=state.ctx.cfg["level"],
                          iters=t["iters"], step=t["step"])
    return x, p


def steps_per_unit(ctx) -> int:
    return 1


def voxels_per_unit(ctx) -> int:
    return math.prod(ctx.cfg["shape"])


def work(ctx) -> counts.Work:
    """The solve: ``x_0 = M b`` once (reads ``M`` and ``b``, writes ``x``),
    then per iteration the gradient step (reads ``z``, ``M`` and ``b``,
    writes ``v``), the analysis and synthesis of ``v``, and the momentum
    (reads two iterates, writes ``z``)."""
    n = math.prod(ctx.cfg["shape"])
    w = counts.WORD[ctx.cfg["dtype"]]
    per_iter = (counts.elementwise(n, [w] * 4)
                + 2 * counts.transform(ctx.cfg, 1, ctx.cfg["level"])
                + counts.elementwise(n, [w] * 3))
    return counts.elementwise(n, [w] * 3) + ctx.traffic["iters"] * per_iter


def release(state) -> None:
    state.plan = None


def reference(state, index: int, precision: str):
    ctx, t = state.ctx, state.ctx.traffic
    b, mask = state.problems[index]
    bank = reference_bank(ctx.cfg, precision, ctx.device)
    return inpaint.fista_inpaint(b, mask, bank, ctx.cfg["level"], t["lam"], t["iters"],
                                 t["step"])
