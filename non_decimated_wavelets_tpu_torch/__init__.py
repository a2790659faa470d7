"""PyTorch + CUDA port of the non-decimated wavelet transform framework.

The JAX package ``non_decimated_wavelets_tpu`` is the reference this port is
held against; this package imports torch and NumPy and never JAX. Plans run
on the card unless the caller asks for ``device="cpu"``. On a CUDA tensor
the 2D/3D float32/bfloat16 transforms and the solvers' elementwise passes
run on hand-written Hopper kernels (``ops/csrc/*.cu``), built by ``nvcc``
at first use; importing the package builds nothing.
"""

from .filters import (
    correlation_taps,
    daubechies_taps,
    decomposition_filters,
    frequency_response,
    parse_wavelet_name,
    qmf_highpass,
    symlet_taps,
)
from .oracle import level_from_bands, num_bands
from .plan import NDDWT

__all__ = [
    "NDDWT",
    "correlation_taps",
    "daubechies_taps",
    "decomposition_filters",
    "frequency_response",
    "level_from_bands",
    "num_bands",
    "parse_wavelet_name",
    "qmf_highpass",
    "symlet_taps",
]
