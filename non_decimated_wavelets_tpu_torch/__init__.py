"""PyTorch + CUDA port of the non-decimated wavelet transform framework.

The JAX package ``non_decimated_wavelets_tpu`` is the reference this port is
held against; this package imports torch and NumPy and never JAX. Plans run
on the card unless the caller asks for ``device="cpu"``. On a CUDA tensor
the 1D-4D float32/bfloat16/float64 transforms and the solvers' elementwise
passes run on hand-written Hopper kernels (``ops/csrc/*.cu``), built by
``nvcc`` at first use; importing the package builds nothing. The
reference-style classes (``nd_dwt_1D`` ... ``harr_nddwt_4D``, ``api.py``)
run there at their default double precision. ``parallel.ShardedNDDWT``
shards a transform's spatial axes over the ranks of a ``torch.distributed``
device mesh.
"""

from .api import (
    harr_nddwt_2D,
    harr_nddwt_4D,
    nd_dwt_1D,
    nd_dwt_2D,
    nd_dwt_3D,
    nd_dwt_4D,
)
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
    "harr_nddwt_2D",
    "harr_nddwt_4D",
    "level_from_bands",
    "nd_dwt_1D",
    "nd_dwt_2D",
    "nd_dwt_3D",
    "nd_dwt_4D",
    "num_bands",
    "parse_wavelet_name",
    "qmf_highpass",
    "symlet_taps",
]
