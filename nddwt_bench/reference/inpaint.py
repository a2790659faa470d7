"""The benchmark's plain reference of an inpainting solve: FISTA for an
image-domain masked data term, on ``nddwt_fft``.

``fista_inpaint`` solves ``min_x 0.5 ||M x - b||^2 + lam ||W x||_1`` with
``M`` a 0/1 pixel mask, by the same iteration as the program
(``models/cs_recon.py: _fista_loop``, and the flat kernel's plain version
``ops/flat_ref.py: flat_iter_ref``):

* ``x_0 = z_0 = M b``, ``t_1 = 1``;
* each iteration the gradient step ``v = z - step M (M z - b)``, the prox
  ``x+ = W^T soft(W v, lam step)`` (details only, ``solvers.prox``) and the
  momentum ``z+ = x+ + ((t_k - 1) / t_(k+1)) (x+ - x)``,
  ``t_(k+1) = (1 + sqrt(1 + 4 t_k^2)) / 2``;
* it returns the last ``x``.

It departs from the program in how, not what, it computes: the transform
is the FFT-domain one of the MATLAB original (the program convolves in
the image domain), and the schedule is computed in float64 on the host
(the program's kernel reads it from the device in its compute type).
``Precision`` sets the arithmetic: float64, or the bfloat16 control
(every stored result rounded to bfloat16). It imports torch alone.
"""

from __future__ import annotations

import math

import torch

from . import nddwt_fft as W
from .solvers import prox


def fista_inpaint(b: torch.Tensor, mask: torch.Tensor, bank: W.FilterBank, level: int,
                  lam: float, iters: int, step: float) -> torch.Tensor:
    """``iters`` FISTA iterations of the inpainting problem of the
    observation ``b`` under ``mask`` (both real, the bank's shape)."""
    q = bank.prec.q
    b = q(b.to(bank.prec.real))
    mask = q(mask.to(bank.prec.real))
    x = q(mask * b)
    z, t = x, 1.0
    for _ in range(iters):
        t_next = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        v = q(z - step * q(mask * q(mask * z - b)))
        x_new = prox(v, bank, level, lam * step)
        z = q(x_new + ((t - 1.0) / t_next) * q(x_new - x))
        x, t = x_new, t_next
    return x
