"""A unit is one fused denoising iterate of a real volume, ``dec_rec``
with its soft threshold of the detail bands; calls are issued back to
back, and the inputs cycle through ``problems`` independent volumes."""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from .. import counts, data
from ..reference import solvers
from . import port_plan, reference_bank


def setup(ctx):
    vols, sigma = [], 0.0
    for p in range(ctx.traffic["problems"]):
        x, sigma = data.magnitude_volume(tuple(ctx.cfg["shape"]), ctx.traffic, ctx.seed, p,
                                         ctx.device)
        vols.append(x)
    return SimpleNamespace(ctx=ctx, plan=port_plan(ctx.cfg, ctx.device), vols=vols,
                           tau=ctx.traffic["threshold_sigma"] * sigma)


def unit(state, i, span):
    p = i % len(state.vols)
    with span("bench.dec_rec"):
        _, x = state.plan.dec_rec(state.vols[p], state.ctx.cfg["level"], threshold=state.tau,
                                  band_axis=0)
    return x, p


def steps_per_unit(ctx) -> int:
    return 1


def voxels_per_unit(ctx) -> int:
    return math.prod(ctx.cfg["shape"])


def work(ctx) -> counts.Work:
    """One analysis (the shrink is part of its band write) and one
    synthesis of the real volume."""
    return 2 * counts.transform(ctx.cfg, 1, ctx.cfg["level"])


def release(state) -> None:
    state.plan = None


def reference(state, index: int, precision: str):
    bank = reference_bank(state.ctx.cfg, precision, state.ctx.device)
    return solvers.denoise(state.vols[index], bank, state.ctx.cfg["level"], state.tau)


def control(state, index: int):
    """The program's own bfloat16 path: a bfloat16 plan on the volume
    rounded to bfloat16."""
    plan = port_plan(state.ctx.cfg, state.ctx.device, dtype="bfloat16")
    _, x = plan.dec_rec(state.vols[index].to(torch.bfloat16), state.ctx.cfg["level"],
                        threshold=state.tau, band_axis=0)
    return x.to(torch.float32)
