"""The kinds of unit a traffic mix can name (``"kind"`` in its file): one
module each, found by that name.

A kind module gives:

* ``setup(ctx)``: the program's plan and the inputs, made from the seed on
  the device (``ctx``: ``cfg``, ``traffic``, ``seed``, ``device``);
* ``unit(state, i, span)``: the ``i``-th unit of work, each call into the
  program inside ``span(name)``; returns the unit's output and the index of
  the input it worked on;
* ``steps_per_unit(ctx)``, ``voxels_per_unit(ctx)`` and ``work(ctx)``
  (``counts.Work`` of one unit, counted from shapes);
* ``release(state)``: drops the program's state once the window closed;
* ``reference(state, index, precision)``: the plain reference's output for
  that input, in ``"float64"`` or in the ``"bfloat16"`` control;
* optionally ``control(state, index)``: the program's own lower-precision
  path, which then serves as the control in place of the reference's.
"""

from __future__ import annotations


def port_plan(cfg: dict, device, dtype=None):
    """The program's plan of a configuration."""
    from non_decimated_wavelets_tpu_torch import NDDWT

    return NDDWT(cfg["wavelet"], tuple(cfg["shape"]), preserve_l2=cfg["preserve_l2"],
                 dtype=dtype or cfg["dtype"], device=device)


def reference_bank(cfg: dict, precision: str, device):
    """The reference's filter bank of a configuration."""
    from ..reference import nddwt_fft

    return nddwt_fft.FilterBank(cfg["wavelet"], cfg["shape"], cfg["preserve_l2"],
                                nddwt_fft.Precision(precision), device)
