"""Reference-compatible class API, in torch.

Port of ``non_decimated_wavelets_tpu/api.py``: the six public classes of the
reference (``Functions/nd_dwt_{1,2,3,4}D.m``, ``Functions/harr_nddwt_{2,4}D.m``),
each with ``ctor(wname, sizes, **opts)`` / ``dec(x, level)`` / ``rec(y)``,
the reference's option names (``pres_l2_norm``, ``compute``, ``precision``)
and its band layout ``[n1..nd, B]``.

``compute`` maps the reference's backends onto the port's:

=============================  ==========================================
``compute``                    here
=============================  ==========================================
``'gpu'``, ``'jax'``, ``'tpu'``  tensors in and out, on the plan's device
                               (the card)
``'mat'``, ``'gpu_off'``,      NumPy in and out, the kernels on the card
``'tpu_off'``, ``'offload'``   underneath (a copy each way per call,
                               ``Functions/nd_dwt_1D.m:139-141,192-194``)
``'mex'``, ``'native'``        the C++ CPU backend (``native/``); without
                               the built library, a warning and the plan
``'numpy'``                    the float64 NumPy oracle (``oracle.py``)
=============================  ==========================================

``precision`` is ``'double'`` by default, as in the reference: float64 (and
complex128) on the card, through the float64 kernels. Torch has no switch
that turns float64 off, so the JAX package's downgrade to single precision
when x64 is disabled does not apply here. ``device`` (default ``"cuda"``)
is where the plan runs; the CPU tests pass ``device="cpu"``. Unknown options
warn rather than raise, as in the reference (``Functions/nd_dwt_1D.m:112``).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import oracle as _oracle
from .filters import correlation_taps
from .native import cpu_backend
from .plan import NDDWT

_COMPUTE_ALIASES = {
    # 'mat' is host-in/host-out in the reference (plain MATLAB arrays);
    # 'gpu' is device-resident (Functions/nd_dwt_1D.m:129-131 vs 139-141).
    "mat": "offload",
    "gpu": "jax",
    "jax": "jax",
    "tpu": "jax",
    "gpu_off": "offload",
    "tpu_off": "offload",
    "offload": "offload",
    "mex": "native",
    "native": "native",
    "numpy": "numpy",
}


class _NdDwtBase:
    """Shared implementation of the per-dimension classes."""

    _NDIM: int = 0

    def _forced_path(self, device: torch.device):
        """The path a class forces on a plan on ``device`` (None: 'auto')."""
        return None

    def __init__(self, wname, sizes, **options):
        if np.isscalar(sizes):
            sizes = (int(sizes),)
        sizes = tuple(int(s) for s in sizes)
        if len(sizes) != self._NDIM:
            raise ValueError(
                f"{type(self).__name__} expects {self._NDIM} sizes, got {len(sizes)}"
            )

        pres_l2_norm = False
        compute = "jax"
        precision = "double"
        path = None
        device = "cuda"
        for key, val in options.items():
            k = key.lower()
            if k in ("pres_l2_norm", "preserve_l2"):
                pres_l2_norm = bool(val)
            elif k == "compute":
                if str(val).lower() not in _COMPUTE_ALIASES:
                    raise ValueError(f"Unknown compute mode {val!r}")
                compute = _COMPUTE_ALIASES[str(val).lower()]
            elif k == "precision":
                precision = val
            elif k == "path":
                path = val
            elif k == "device":
                device = val
            else:
                # The reference warns on unknown options (Functions/nd_dwt_1D.m:112).
                warnings.warn(f"Unknown optional input {key!r}; ignoring", stacklevel=2)

        self.wname = wname
        self.sizes = sizes
        self.pres_l2_norm = pres_l2_norm
        self.compute = compute
        self.precision = (
            "single" if str(precision).lower() in ("single", "float32") else "double"
        )
        if compute == "native" and not cpu_backend.available():
            warnings.warn(
                "native CPU backend not built; falling back to compute='gpu'",
                stacklevel=2,
            )
            self.compute = "jax"

        if self.compute != "numpy":
            device = torch.device(device)
            self.plan = NDDWT(
                wavelet=wname,
                shape=sizes,
                preserve_l2=pres_l2_norm,
                dtype=torch.float32 if self.precision == "single" else torch.float64,
                path=path or self._forced_path(device) or "auto",
                device=device,
            )
        else:
            self.plan = None
        wavelets = _oracle._normalize_wavelets(wname, len(sizes))
        self.f_size = tuple(len(correlation_taps(w)[0]) for w in wavelets)

    # ------------------------------------------------------------------ dec
    def dec(self, x, level):
        x = self._prepare_input(x)
        if self.compute == "numpy":
            return _oracle.dec(np.asarray(x), self.wname, int(level),
                               preserve_l2=self.pres_l2_norm)
        if self.compute == "native":
            return cpu_backend.dec(np.asarray(x), self.wname, int(level),
                                   self.pres_l2_norm, self.precision)
        y = self.plan.dec(x, int(level))
        return self._out(y)

    # ------------------------------------------------------------------ rec
    def rec(self, y):
        if self.compute == "numpy":
            return _oracle.rec(np.asarray(y), self.wname, preserve_l2=self.pres_l2_norm)
        if self.compute == "native":
            return cpu_backend.rec(np.asarray(y), self.wname, self.pres_l2_norm,
                                   self.precision)
        return self._out(self.plan.rec(self._host_in(y)))

    def _host_in(self, x):
        """NumPy in for the host modes (the plan copies it to its device)."""
        return np.asarray(x) if self.compute in ("offload", "native", "numpy") else x

    def _out(self, t: torch.Tensor):
        return t.detach().cpu().numpy() if self.compute == "offload" else t

    def _prepare_input(self, x):
        return self._host_in(x)


class nd_dwt_1D(_NdDwtBase):
    """1D NDDWT (reference: ``Functions/nd_dwt_1D.m``).

    Row vectors ``(1, N)`` are flattened as in the reference
    (``Functions/nd_dwt_1D.m:151-153``). Unlike the reference (which errors
    on cell input, ``nd_dwt_1D.m:83-85``), a one-element list of wavelet
    names is accepted.
    """

    _NDIM = 1

    def __init__(self, wname, sizes, **options):
        if isinstance(wname, (list, tuple)) and len(wname) == 1:
            wname = wname[0]
        super().__init__(wname, sizes, **options)

    def _prepare_input(self, x):
        x = self._host_in(x)
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if x.ndim == 2 and x.shape[0] == 1:
            x = x.reshape(-1)
        return x


class nd_dwt_2D(_NdDwtBase):
    """2D NDDWT (reference: ``Functions/nd_dwt_2D.m``); 4 bands/level."""

    _NDIM = 2


class nd_dwt_3D(_NdDwtBase):
    """3D NDDWT (reference: ``Functions/nd_dwt_3D.m``); 8 bands/level."""

    _NDIM = 3


class nd_dwt_4D(_NdDwtBase):
    """4D NDDWT (reference: ``Functions/nd_dwt_4D.m``); 16 bands/level.

    The reference's 4D-only ``method`` option (``'fft'|'conv'``,
    ``Functions/nd_dwt_4D.m:97,111-112``) is accepted: on a CPU plan
    ``'fft'`` takes the FFT path and ``'conv'`` the spatial-domain direct
    path (the reference's ``'conv'`` branch is broken: 1D ``cconv`` on 4D
    arrays, ``Functions/nd_dwt_4D.m:427-442``). Both give the same numbers;
    on the card ``'auto'`` keeps the stage kernels.
    """

    _NDIM = 4

    def __init__(self, wname, sizes, **options):
        method = str(options.pop("method", "")).lower()
        if method not in ("", "fft", "conv"):
            raise ValueError(f"Unknown method {method!r}: expected 'fft' or 'conv'")
        self._method = method
        super().__init__(wname, sizes, **options)

    def _forced_path(self, device):
        if device.type == "cpu" and self._method:
            return "direct" if self._method == "conv" else "fft"
        return None


class _HaarBase(_NdDwtBase):
    """The Haar classes: the wavelet is fixed to Haar/db1. Their identity is
    the direct two-tap stencils, which a CPU plan runs; on the card
    ``'auto'`` takes the kernels (the same numbers)."""

    def _forced_path(self, device):
        return "direct" if device.type == "cpu" else None

    def __init__(self, wname="db1", sizes=None, **options):
        if sizes is None:
            sizes = wname
            wname = "db1"
        if _first_name(wname) not in ("db1", "haar"):
            raise ValueError(f"{type(self).__name__} supports only Haar (db1) filters")
        super().__init__("db1", sizes, **options)


class harr_nddwt_2D(_HaarBase):
    """2D Haar NDDWT via direct stencils (reference:
    ``Functions/harr_nddwt_2D.m``, two-tap circular sums and differences).
    Multilevel ``dec`` is supported (the reference restricts ``dec`` to
    level 1, ``harr_nddwt_2D.m:136-138``)."""

    _NDIM = 2


class harr_nddwt_4D(_HaarBase):
    """4D Haar NDDWT via direct stencils (reference:
    ``Functions/harr_nddwt_4D.m``, 16 unrolled two-tap stencil bands)."""

    _NDIM = 4


def _first_name(wname) -> str:
    if isinstance(wname, (list, tuple)):
        wname = wname[0]
    return str(wname).lower()
