"""The work a unit needs, counted from shapes alone, and the chip's peaks.

The counts say what the mathematics needs, whatever kernels carry it out,
so that a later change that fuses, splits or renames kernels leaves them
valid:

* an L-level analysis reads its input once and writes each of its ``B``
  output bands once (the approximations between levels count nothing, and
  a fused detail shrink is part of the band write); a synthesis reads each
  band once and writes its output once;
* operations: ``2K`` per tap row per output element per axis pass, the
  separable band tree factored axis by axis (axis 0 first); an analysis
  pass on axis ``a`` writes twice the elements it reads, each through one
  tap row of ``K_a`` taps; a synthesis pass sums two tap rows into each
  output; so each level costs ``sum_j 2 K_(a_j) 2^j N`` in each direction;
* an FFT of ``N`` complex elements reads and writes them once and costs
  ``5 N log2 N`` operations;
* complex data counts both components.

The peaks are NVIDIA's published rates for the H100 SXM (dense, no
sparsity); a card not in the table has no roofline.
"""

from __future__ import annotations

import math

from .reference.taps import scaling_taps

# name of the card as torch.cuda.get_device_name() gives it -> peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flops": 67e12,  # float32 outside the tensor cores
        "f64_flops": 34e12,
    },
}

WORD = {"float32": 4, "float64": 8, "bfloat16": 2}


class Work:
    """Bytes moved and operations, to be added up."""

    def __init__(self, nbytes: float = 0.0, flops: float = 0.0):
        self.bytes, self.flops = float(nbytes), float(flops)

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops)

    def __mul__(self, k: float) -> "Work":
        return Work(self.bytes * k, self.flops * k)

    __rmul__ = __mul__

    def least_s(self, peaks: dict) -> tuple:
        """The least time on a chip of ``peaks``, the operations at the
        float32 rate, and which bound sets it."""
        t_bytes = self.bytes / peaks["hbm_bytes_per_s"]
        t_ops = self.flops / peaks["f32_flops"]
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def num_bands(ndim: int, level: int) -> int:
    nb = 2**ndim
    return nb + (nb - 1) * (level - 1)


def wavelets(cfg: dict) -> tuple:
    w = cfg["wavelet"]
    return (w,) * len(cfg["shape"]) if isinstance(w, str) else tuple(w)


def transform(cfg: dict, components: int, level: int) -> Work:
    """One analysis or one synthesis of ``components`` real arrays of the
    configuration's shape and dtype."""
    shape = cfg["shape"]
    n = math.prod(shape)
    taps = [len(scaling_taps(w)) for w in wavelets(cfg)]
    word = WORD[cfg["dtype"]]
    nbytes = components * word * n * (1 + num_bands(len(shape), level))
    per_level = sum(2 * k * 2 ** (j + 1) * n for j, k in enumerate(taps))
    return Work(nbytes, components * level * per_level)


def fft(n: int, complex_word: int) -> Work:
    """One complex FFT of ``n`` elements."""
    return Work(2 * n * complex_word, 5 * n * math.log2(n))


def elementwise(n: int, words) -> Work:
    """One elementwise pass over ``n`` elements that reads or writes one
    operand of each size in ``words`` (bytes a element) once."""
    return Work(n * sum(words), 0.0)
