"""Carry a JAX plan's state across to the port.

The transform has no weights beyond its filter bank, so a JAX ``NDDWT`` is
carried over by its ``to_config()`` and its full-precision taps; the port
derives its own taps from the config and must reproduce the JAX plan's bit
for bit. A JAX ``ShardedNDDWT`` is carried over by its plan and its
partitioning (``spec``, ``batch_spec``) onto a ``DeviceMesh`` with the same
named dimensions. This module takes plain dicts and NumPy arrays and
imports no JAX.
"""

from __future__ import annotations

import numpy as np

from .plan import NDDWT


def plan_from_jax(config: dict, taps_hp, device="cuda") -> NDDWT:
    """Port plan from a JAX plan's ``to_config()`` and
    ``tuple(np.asarray(t) for t in jax_plan.taps_hp)``.

    Raises ``ValueError`` if the port's derived taps differ from the given
    ones in any bit.
    """
    plan = NDDWT.from_config(config, device=device)
    taps_hp = tuple(np.asarray(t) for t in taps_hp)
    if len(taps_hp) != plan.ndim or not all(
        a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
        for a, b in zip(plan.taps_hp, taps_hp)
    ):
        raise ValueError(
            f"taps derived for {config} differ from the JAX plan's taps_hp"
        )
    return plan


def sharded_from_jax(config: dict, taps_hp, spec, batch_spec, mesh,
                     device="cuda"):
    """Port ``ShardedNDDWT`` from a JAX ``ShardedNDDWT``'s plan
    (``sh.plan.to_config()`` and its ``taps_hp``, as :func:`plan_from_jax`)
    and partitioning (``sh.spec``, ``sh.batch_spec``), on ``mesh``, a
    ``DeviceMesh`` (``parallel.make_mesh``) whose dimensions the specs
    name."""
    from .parallel import ShardedNDDWT

    return ShardedNDDWT(plan_from_jax(config, taps_hp, device), mesh, spec,
                        batch_spec)
