"""Plain torch versions of the two one-launch multilevel CUDA kernels.

Each function has exactly its kernel's contract (``csrc/nddwt_multi.cu``),
which is the contract of the TPU kernels it replaces
(``non_decimated_wavelets_tpu/ops/pallas_kernels.py`` ``_fused_dec_multi``
and ``_fused_rec_multi``) over a batch: the level loop of the per-level
kernels' plain versions (``ops/level_ref.py``), item by item, with the
approximation between levels stored in the array dtype as the kernels' ping
slots store it. The CPU tests and ``chip_smoke.py`` hold the kernels against
these; nothing on the CUDA path calls them, and the kernel wrappers
(``ops/multi.py``) use them only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from ..oracle import num_bands
from .level_ref import dec_level_ref, rec_level_ref


def dec_multi_ref(x, taps, level, lam=0.0, out=None):
    """``x`` ``(N, *s)`` -> bands ``(N, B, *s)`` (written into ``out`` when
    given): per item, level ``l`` writes its details at ``B - (2^d - 1)(l +
    1)``, soft-thresholded by ``lam``, and the last level its approximation
    into band 0."""
    nd = x.ndim - 1
    nb, B = 2**nd, num_bands(nd, level)
    big = out if out is not None else torch.empty(
        (x.shape[0], B) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    for item in range(x.shape[0]):
        approx = x[item]
        for lvl in range(level):
            approx = dec_level_ref(approx, big[item], B - (nb - 1) * (lvl + 1),
                                   taps, lam, lvl == level - 1)
    return big


def rec_multi_ref(y, taps, level, scale):
    """Bands ``y`` ``(N, B, *s)`` -> ``(N, *s)``: per item, level ``l``
    (0 = deepest) synthesizes band 0 (``y[0]`` at ``l = 0``, then the
    previous level's output) and the details ``y[2^d + (2^d - 1)(l - 1) + b
    - 1]``, times ``scale``."""
    nd = y.ndim - 2
    nb = 2**nd
    out = []
    for item in range(y.shape[0]):
        acc = rec_level_ref(y[item], None, [("y", b) for b in range(nb)], taps,
                            scale)
        for lvl in range(1, level):
            pos = nb + (nb - 1) * (lvl - 1)
            acc = rec_level_ref(
                y[item], acc,
                [("a", 0)] + [("y", pos + b - 1) for b in range(1, nb)],
                taps, scale)
        out.append(acc)
    return torch.stack(out)
