"""The benchmark's plain reference of each unit of work: FISTA for CS-MRI,
wavelet-shrinkage denoising and the coil-wise prox, on ``nddwt_fft``.

Each function takes the inputs the benchmark made and nothing the program
made, and computes in the arithmetic of ``prec`` (``nddwt_fft.Precision``).
"""

from __future__ import annotations

import math

import torch

from . import nddwt_fft as W


def prox(v: torch.Tensor, bank: W.FilterBank, level: int, lam: float) -> torch.Tensor:
    """``W^T soft(W v, lam)`` with the deepest approximation band left
    alone: analysis, the soft threshold of every detail band, synthesis."""
    y = W.dec(v, bank, level)
    W.shrink_details(y, lam, bank.ndim, bank.prec)
    return W.rec(y, bank)


def fista_cs_mri(b: torch.Tensor, mask: torch.Tensor, bank: W.FilterBank, level: int,
                 lam: float, iters: int, step: float) -> torch.Tensor:
    """FISTA (Beck and Teboulle, SIAM J. Imaging Sci. 2009) for
    ``min_x 0.5 ||M F x - b||^2 + lam ||W x||_1`` with ``F`` the orthonormal
    FFT over the bank's axes and ``M`` the 0/1 mask: ``x_0 = F^H M b``,
    ``z_0 = x_0``; each iteration a gradient step on the data term from
    ``z``, the prox at threshold ``lam * step``, and the momentum
    ``(t_k - 1) / t_(k+1)`` with ``t_1 = 1``."""
    prec = bank.prec
    q, dims = prec.q, tuple(range(-bank.ndim, 0))
    b = q(b.to(prec.complex))
    mask = q(mask.to(prec.real))

    def fwd(x):
        return q(mask * q(torch.fft.fftn(x, dim=dims, norm="ortho")))

    def adj(k):
        return q(torch.fft.ifftn(q(mask * k), dim=dims, norm="ortho"))

    x = adj(b)
    z, t = x, 1.0
    for _ in range(iters):
        t_next = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        grad = adj(q(fwd(z) - b))
        x_new = prox(q(z - step * grad), bank, level, lam * step)
        del grad
        z = q(x_new + ((t - 1.0) / t_next) * q(x_new - x))
        x, t = x_new, t_next
    return x


def denoise(x: torch.Tensor, bank: W.FilterBank, level: int, lam: float) -> torch.Tensor:
    """One ``dec -> soft-threshold(details) -> rec`` iterate of ``x``."""
    return prox(bank.prec.q(x.to(bank.prec.complex if x.is_complex() else bank.prec.real)),
                bank, level, lam)
