"""Compressed-sensing MRI reconstruction with an NDDWT sparsifier, in torch.

Port of ``non_decimated_wavelets_tpu/models/cs_recon.py``: FISTA for

    min_x  0.5 || M ⊙ F x - b ||^2 + lam || W x ||_1

with ``F`` the orthonormal FFT, ``M`` a sampling mask and ``W`` the
non-decimated DWT, and its image-domain variants (inpainting, real and
split-complex). The loop the reference library was built for: the same
transform applied hundreds of times (``README.md:2``).

``transform`` is a single-device ``NDDWT`` or a ``ShardedNDDWT``
(``parallel/sharded.py``; band-first blocks, every array one rank's block),
as in the JAX package. The masked-Fourier solver needs a sharded FFT, which
is not ported yet: ``fista_cs_mri`` and ``ista_step`` refuse a sharded
transform (``ROADMAP.md`` queue 1 item 14). The schedule (per-iteration thresholds and momenta) is computed on the host
(``_fista_schedule``). The inpainting solvers decide their route once
(``_solve_route``) and dispatch on it, in the JAX package's order: with a
scalar ``lam`` on a plan whose tensors go to the CUDA kernels, the
one-launch whole solve (``NDDWT._fista_fused``, one ``nddwt_flat_iter``
launch up to ``ITER_MAX_NUMEL`` elements, where ``NDDWT.route`` says
``iter``; never for a sharded transform), else the stepped route, where
every iterate is kernels end to end (the transforms, the shrink, and one
``fista_step`` pass of glue). A tensor ``lam``, or a plan on the CPU, takes
the generic loop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tracing
from ..ops import elemwise
from .denoise import soft_threshold, soft_threshold_mag_pair


def _sharded(transform) -> bool:
    from ..parallel.sharded import ShardedNDDWT

    return isinstance(transform, ShardedNDDWT)


def _check_transform(transform):
    from ..plan import NDDWT

    if not (isinstance(transform, NDDWT) or _sharded(transform)):
        raise TypeError(
            "expected an NDDWT plan or a ShardedNDDWT (parallel/sharded.py, "
            f"ROADMAP.md queue 1 item 14), got {type(transform).__name__}"
        )


def _check_fft(transform):
    if _sharded(transform):
        raise NotImplementedError(
            "the masked-Fourier solver on a ShardedNDDWT needs a sharded FFT, "
            "which is not ported yet (ROADMAP.md queue 1 item 14: "
            "parallel/sharded_fft.py); fista_inpaint and fista_inpaint_split "
            "take sharded transforms"
        )


def _mask_input(transform, mask, dtype):
    """The sampling mask as a tensor on the plan's device, in ``dtype``:
    the plan's shape, or this rank's block of a sharded transform."""
    mask = transform._as_input(mask)
    want = transform.local_shape if _sharded(transform) else transform.shape
    if tuple(mask.shape) != want:
        raise ValueError(
            f"mask shape {tuple(mask.shape)} does not match plan shape {want}"
        )
    return mask.to(dtype)


def _dec(transform, x, level):
    """Band-first analysis: ``ShardedNDDWT.dec`` is band-first already."""
    if _sharded(transform):
        return transform.dec(x, level)
    return transform.dec(x, level, band_axis=0)


def _rec(transform, y):
    if _sharded(transform):
        return transform.rec(y)
    return transform.rec(y, band_axis=0)


def _dec_rec(transform, x, level, threshold):
    """The fused iterate's reconstruction, for either kind of transform: a
    single-card plan's reconstruction-only iterate (``NDDWT._iterate``,
    which never joins a complex iterate's bands)."""
    if _sharded(transform):
        return transform.dec_rec(x, level, threshold=threshold)[1]
    return transform._iterate(x, level, threshold)


def _shrink_details(y, lam):
    """Soft-threshold the detail bands only (band-first layout): the
    approximation band carries the low-frequency content the l1 penalty
    should not shrink, as in ``denoise.denoise``."""
    return torch.cat([y[:1], soft_threshold(y[1:], lam)])


def _prox(transform, v, lam, level):
    """``W^T soft(W v, lam)`` (details only). A scalar ``lam`` goes through
    the fused iterate (``_dec_rec``: the shrink rides the CUDA analysis
    kernels, and no band is kept)."""
    if not hasattr(lam, "shape"):
        return _dec_rec(transform, v, level, float(lam))
    return _rec(transform, _shrink_details(_dec(transform, v, level), lam))


def _prox_split(transform, v_pair, lam, level):
    """Split-complex prox: ``W^T shrink_mag(W v, lam)`` with the joint
    re/im magnitude shrink, the prox of the complex l1 norm
    (``Functions/nd_dwt_1D.m:57-61``)."""
    if not hasattr(lam, "shape"):
        _, xr = transform.dec_rec_split(v_pair, level, threshold=float(lam))
        return xr
    y = transform.dec_split(v_pair, level)
    return transform.rec_split(soft_threshold_mag_pair(y, lam))


@functools.lru_cache(maxsize=64)
def _momenta(iters: int) -> tuple:
    """The momentum coefficients ``(t_k - 1) / t_{k+1}``, ``t_1 = 1``, of
    ``iters`` iterations: they depend on the count alone, so they are worked
    out once per count and not in every solve's host time."""
    t, moms = 1.0, []
    for _ in range(iters):
        t_next = 0.5 * (1.0 + float(np.sqrt(1.0 + 4.0 * t * t)))
        moms.append((t - 1.0) / t_next)
        t = t_next
    return tuple(moms)


def _fista_schedule(iters, lam, step):
    """The FISTA schedule, computed on the host (JAX ``cs_recon.py:98-108``):
    the per-iteration shrink thresholds ``lam * step`` (the prox scaling)
    and momentum coefficients (``_momenta``)."""
    return [float(lam) * float(step)] * iters, list(_momenta(int(iters)))


def _fwd(x, mask):
    return mask * torch.fft.fftn(x, norm="ortho")


def _adj(k, mask):
    return torch.fft.ifftn(mask * k, norm="ortho")


def _data_step(x, b, mask, step):
    """The gradient step of the data term: ``x - step F^H M (M F x - b)``."""
    return x - step * _adj(_fwd(x, mask) - b, mask)


def ista_step(transform, x, b, mask, lam, step, level):
    """One proximal-gradient step: data consistency + wavelet shrinkage.
    With ``preserve_l2`` the transform is a tight frame, so
    ``W^T soft(W v, lam)`` is the cycle-spinning surrogate of the prox."""
    _check_fft(transform)
    return _prox(transform, _data_step(x, b, mask, step), lam * step, level)


def fista_cs_mri(transform, b, mask, lam, level=2, iters=20, step=1.0):
    """FISTA on the masked-Fourier CS problem; returns the (complex)
    reconstruction. ``b``: observed k-space (the image's shape), ``mask``:
    0/1 sampling mask. On the card each iterate is two FFTs, one complex
    reconstruction-only iterate (``NDDWT._iterate``: both components' level
    chains and one ``mag_shrink_pair`` launch; its only copies are the
    split of ``v`` into its re/im pair and the join of the reconstruction)
    and torch elementwise ops for the gradient and momentum. An
    iteration runs inside the span ``nddwt.solve.iter``, its phases inside
    ``nddwt.solve.data``, ``nddwt.solve.prox`` and ``nddwt.solve.momentum``
    (``tracing.py``)."""
    _check_transform(transform)
    _check_fft(transform)
    b = transform._as_input(b)
    if not b.is_complex():
        b = b.to(transform.complex_dtype)
    mask = _mask_input(transform, mask, b.real.dtype)
    x = _adj(b, mask)
    z = x
    for mom in _fista_schedule(iters, lam, step)[1]:
        with tracing.span("nddwt.solve.iter"):
            with tracing.span("nddwt.solve.data"):
                v = _data_step(z, b, mask, step)
            with tracing.span("nddwt.solve.prox"):
                x_new = _prox(transform, v, lam * step, level)
            with tracing.span("nddwt.solve.momentum"):
                z = x_new + mom * (x_new - x)
            x = x_new
    return x


def _fista_stepped(transform, b, mask, lam, level, moms, step):
    """FISTA for inpainting with every iterate on kernels: the shrink rides
    the analysis kernels (``dec_rec`` threshold fusion) and the momentum
    and data-term glue is one ``fista_step`` pass. On the CPU the same loop
    runs the kernels' plain versions."""
    x = mask * b
    v = x - step * (mask * (mask * x - b))  # z_0 = x_0, once before the loop
    thr = float(lam) * float(step)
    for mom in moms:
        x_new = _dec_rec(transform, v, level, thr)
        v = elemwise.fista_step(x_new, x, mask, b, mom, float(step))
        x = x_new
    return x


def _fista_stepped_split(transform, b_pair, mask, lam, level, moms, step):
    """Split-complex FISTA with every iterate on kernels: the split
    ``dec_rec_split`` iterate (one flat launch, or per-component analysis
    chains, one ``mag_shrink_pair`` pass over both components' details and
    per-component synthesis chains), one ``fista_step`` pass (the mask read
    once per re/im pair)."""
    x = mask * b_pair
    v = x - step * (mask * (mask * x - b_pair))
    thr = float(lam) * float(step)
    for mom in moms:
        _, x_new = transform.dec_rec_split(v, level, threshold=thr)
        v = elemwise.fista_step(x_new, x, mask, b_pair, mom, float(step))
        x = x_new
    return x


def _fista_loop(prox, b, mask, iters, step):
    """The generic FISTA loop for a masked image-domain data term."""
    x = mask * b
    z = x
    for mom in _fista_schedule(iters, 0.0, step)[1]:
        x_new = prox(z - step * (mask * (mask * z - b)))
        z = x_new + mom * (x_new - x)
        x = x_new
    return x


def _solve_route(transform, b, lam, level, split):
    """The route of an inpainting solve, on which the solver dispatches and
    after which its span is named: ``iter`` where one ``nddwt_flat_iter``
    launch runs the whole solve (a scalar ``lam``; ``NDDWT.route``),
    ``stepped`` where every iterate runs on kernels end to end (a scalar
    ``lam``, real or split data, on the card, or on a sharded transform's
    kernel bodies), else that of the generic loop's transforms
    (``NDDWT.route``; ``sharded`` for a ``ShardedNDDWT``)."""
    scalar = not hasattr(lam, "shape")
    steppable = scalar and (split or not b.is_complex())
    if _sharded(transform):
        return "stepped" if steppable and b.is_cuda and transform.use_pallas else "sharded"
    route = transform.route(b.dtype, level, pair=split, whole=scalar)
    return "stepped" if steppable and route in ("flat", "multi", "stage", "level") else route


def fista_inpaint(transform, b, mask, lam, level=2, iters=20, step=1.0):
    """FISTA for image-domain masked observation (inpainting):
    ``min_x 0.5 ||M ⊙ x - b||^2 + lam ||W x||_1``. ``b`` may be complex
    (generic loop, joint-magnitude shrink). On the card with a scalar
    ``lam`` the whole solve is one launch where ``NDDWT.route`` says
    ``iter``, else the stepped route. With a ``ShardedNDDWT``, ``b`` and
    ``mask`` are this rank's blocks and so is the result; every iterate
    exchanges halos (the stepped route on the kernel bodies on the card).
    The solve runs inside the span ``nddwt.fista_inpaint.<route>.L<level>``
    (``tracing.entry``)."""
    _check_transform(transform)
    b = transform._as_input(b)
    mask = _mask_input(transform, mask, b.real.dtype)
    route = _solve_route(transform, b, lam, level, False)
    with tracing.entry("fista_inpaint", route, level):
        if route == "iter":
            lams, moms = _fista_schedule(iters, lam, step)
            return transform._fista_fused(b, mask, level, lams, moms, step)
        if route == "stepped":
            return _fista_stepped(transform, b, mask, lam, level,
                                  _fista_schedule(iters, lam, step)[1], step)
        return _fista_loop(lambda v: _prox(transform, v, lam * step, level),
                           b, mask, iters, step)


def fista_inpaint_split(transform, b_pair, mask, lam, level=2, iters=20,
                        step=1.0):
    """FISTA for image-domain masked observation of complex data carried as
    a split re/im pair ``(2, *shape)``: ``min_x 0.5 ||M ⊙ x - b||^2 +
    lam ||W x||_{1,c}`` with the complex l1 norm (joint re/im magnitude).
    ``mask`` is real with the plan's shape. Its routes are
    ``fista_inpaint``'s; with a ``ShardedNDDWT`` the arrays are this rank's
    blocks, as there. The solve runs inside the span
    ``nddwt.fista_inpaint_split.<route>.L<level>``."""
    _check_transform(transform)
    b_pair = transform._as_pair(b_pair)
    mask = _mask_input(transform, mask, b_pair.dtype)
    route = _solve_route(transform, b_pair, lam, level, True)
    with tracing.entry("fista_inpaint_split", route, level):
        if route == "iter":
            lams, moms = _fista_schedule(iters, lam, step)
            return transform._fista_fused(b_pair, mask, level, lams, moms, step,
                                          split=True)
        if route == "stepped":
            return _fista_stepped_split(transform, b_pair, mask, lam, level,
                                        _fista_schedule(iters, lam, step)[1], step)
        return _fista_loop(
            lambda v: _prox_split(transform, v, lam * step, level),
            b_pair, mask, iters, step)
