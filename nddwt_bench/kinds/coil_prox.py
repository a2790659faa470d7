"""A unit is the coil-wise prox of one multi-coil slice: ``dec_batched``
of the coil images, the soft threshold of every detail band
(``models.denoise.soft_threshold``) and ``rec_batched``; the slices cycle
through a ring large enough to keep them out of the card's L2 cache."""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch
from non_decimated_wavelets_tpu_torch.models import soft_threshold

from .. import counts, data
from ..reference import solvers
from . import port_plan, reference_bank


def setup(ctx):
    ring, sigma = data.coil_ring(tuple(ctx.cfg["shape"]), ctx.cfg["coils"], ctx.traffic,
                                 ctx.seed, ctx.device)
    return SimpleNamespace(ctx=ctx, plan=port_plan(ctx.cfg, ctx.device), ring=ring,
                           tau=ctx.traffic["threshold_sigma"] * sigma)


def unit(state, i, span):
    p = i % state.ring.shape[0]
    plan, level = state.plan, state.ctx.cfg["level"]
    with span("bench.dec_batched"):
        y = plan.dec_batched(state.ring[p], level)
    with span("bench.shrink"):
        y = torch.cat([y[:, :1], soft_threshold(y[:, 1:], state.tau)], dim=1)
    with span("bench.rec_batched"):
        x = plan.rec_batched(y)
    return x, p


def steps_per_unit(ctx) -> int:
    return 1


def voxels_per_unit(ctx) -> int:
    return ctx.cfg["coils"] * math.prod(ctx.cfg["shape"])


def work(ctx) -> counts.Work:
    """The analysis and the synthesis of both components of every coil
    image (the shrink is part of the band write)."""
    return 2 * counts.transform(ctx.cfg, 2 * ctx.cfg["coils"], ctx.cfg["level"])


def release(state) -> None:
    state.plan = None


def reference(state, index: int, precision: str):
    bank = reference_bank(state.ctx.cfg, precision, state.ctx.device)
    return solvers.denoise(state.ring[index], bank, state.ctx.cfg["level"], state.tau)
