"""Transform plan: validated config + cached filter bank + dec/rec, in torch.

Port of ``non_decimated_wavelets_tpu/plan.py`` (``NDDWT`` core: ``dec``,
``rec``, ``dec_rec``, complex data, the split-complex ``dec_split``,
``rec_split``, ``dec_rec_split``, band layouts, level inference, config
round trip). The plan builds the per-axis correlation taps once, as the
reference's constructors do (``Functions/nd_dwt_2D.m:1-4``), and names the
device its transforms run on: the card (``"cuda"``) unless the caller asks
for ``device="cpu"``.

Dispatch:

* a CUDA tensor, 1D to 4D, float32, bfloat16 or float64: the hand-written
  level kernels (``ops/cuda_kernels.py``): per level and direction one
  launch in 1D, 2D and 3D, two (a lane and a lead stage) in 4D and for 3D
  filters too long for the one-launch tile; the shrink of ``dec_rec`` fused
  into the analysis. float64 computes in float64 (the TPU package's
  double-f32 kernels, ``pallas_df32``, exist only because the TPU has no
  float64 units). Complex data (complex64, complex128) and split re/im
  pairs run each component through its own level chain (the filters are
  real); their shrink is the joint-magnitude ``mag_shrink_pair`` kernel
  (``ops/elemwise.py``);
* a CPU tensor: the torch direct path (``ops/direct_path.py``), complex
  data included;
* 5D and up on CUDA raises ``NotImplementedError``; nothing runs silently
  on torch ops.

``path`` picks the route as in the JAX plan: ``'auto'`` as above;
``'direct'`` the torch direct path on any device; ``'pallas'`` the kernels
only (a tensor they cannot take raises); ``'fft'`` the FFT path
(``ops/fft_path.py``, cuFFT on the card) on any device. A tensor must
already lie on the plan's ``device``: the plan never copies one between
devices, so work on the card cannot end up on the host.

Autograd: ``dec`` and ``rec`` are ``torch.autograd.Function`` s whose
backward is the exact adjoint, as the JAX package's ``linear_call`` rules
(``ops/pallas_kernels.py:898-902,1703-1713``): the adjoint of ``dec`` is the
synthesis with ``preserve_l2=True`` on the same taps, and the adjoint of
``rec`` is ``dec`` with the per-level ``1/2^d`` redistributed onto the band
groups when not ``preserve_l2``. ``dec_rec`` with a threshold on CUDA is
non-linear and has no adjoint, as in JAX; nor do the split transforms on
CUDA. The same rules serve 1D, float64 and the FFT path (the JAX package's
``dec64``/``rec64`` carry the same ``linear_call`` rules,
``ops/pallas_df32.py:548-610``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import filters as _filters
from . import oracle as _oracle
from .models.denoise import soft_threshold, soft_threshold_mag_pair
from .ops import cuda_kernels, direct_path, elemwise, fft_path

_VALID_PATHS = ("auto", "fft", "direct", "pallas")
_REAL_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "single": torch.float32,
    "double": torch.float64,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def _as_real_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        dt = dtype
    else:
        key = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        dt = _REAL_DTYPES.get(key.lower().removeprefix("torch."))
    if dt not in (torch.float32, torch.float64, torch.bfloat16):
        raise ValueError(
            "precision must be float32/float64/bfloat16 "
            f"('single'/'double'/'bf16'), got {dtype!r}"
        )
    return dt


def _is_cuda(t: torch.Tensor) -> bool:
    """Whether a transform of ``t`` runs on the CUDA kernels."""
    return t.is_cuda


def _parts(z: torch.Tensor) -> torch.Tensor:
    """Complex ``(*s)`` -> the real ``(2, *s)`` re/im pair."""
    return torch.stack([z.real, z.imag])


def _join(pair: torch.Tensor) -> torch.Tensor:
    """The real ``(2, *s)`` re/im pair -> complex ``(*s)``."""
    return torch.complex(pair[0], pair[1])


def _no_adjoint_on_kernels(t: torch.Tensor, what: str) -> None:
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError(f"{what} has no adjoint on the CUDA kernels")


def _rec_transpose_scales(ndim: int, level: int) -> np.ndarray:
    """Per-band scales of the NOT-preserve_l2 synthesis transpose
    (``pallas_kernels._rec_transpose_scales``): the group at depth ``l``
    carries ``(1/2^d)^l`` (the deepest approximation and details:
    ``l = level``)."""
    nb = 2**ndim
    s = np.empty((_oracle.num_bands(ndim, level),), np.float64)
    s[:nb] = (1.0 / nb) ** level
    pos = nb
    for depth in range(level - 1, 0, -1):
        s[pos : pos + nb - 1] = (1.0 / nb) ** depth
        pos += nb - 1
    return s


class _Dec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, level):
        ctx.plan, ctx.level = plan, level
        return plan._dec_bands(x, level)

    @staticmethod
    def backward(ctx, gy):
        return ctx.plan._rec_bands(gy, ctx.level, True), None, None


class _Rec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, plan, level):
        ctx.plan, ctx.level = plan, level
        return plan._rec_bands(y, level, plan.preserve_l2)

    @staticmethod
    def backward(ctx, gx):
        plan, level = ctx.plan, ctx.level
        z = plan._dec_bands(gx, level)
        if not plan.preserve_l2:
            s = torch.as_tensor(_rec_transpose_scales(plan.ndim, level))
            z = z * s.to(z.dtype).to(z.device).view((-1,) + (1,) * plan.ndim)
        return z, None, None


@dataclasses.dataclass(frozen=True, eq=False)
class NDDWT:
    """Plan for a multidimensional non-decimated DWT.

    ``wavelet`` is one name or one per axis; ``shape`` the spatial extents;
    ``preserve_l2`` the tight-frame normalization (the reference's
    ``pres_l2_norm``); ``dtype`` the precision (``'single'``/``'double'``
    accepted; complex data computes in ``complex_dtype``); ``path`` the
    route (module docstring); ``device`` is where the transforms run, the
    card by default: tensor inputs must lie there, NumPy arrays and lists
    are copied there.
    """

    wavelet: object
    shape: tuple
    preserve_l2: bool = False
    dtype: object = torch.float32
    path: str = "auto"
    device: object = "cuda"

    wavelets: tuple = dataclasses.field(init=False)
    ndim: int = dataclasses.field(init=False)
    real_dtype: torch.dtype = dataclasses.field(init=False)
    complex_dtype: torch.dtype = dataclasses.field(init=False)
    resp: tuple = dataclasses.field(init=False, repr=False)
    taps: tuple = dataclasses.field(init=False, repr=False)
    taps_hp: tuple = dataclasses.field(init=False, repr=False)
    filter_lengths: tuple = dataclasses.field(init=False)

    def __post_init__(self):
        shape = tuple(int(s) for s in self.shape)
        if len(shape) < 1:
            raise ValueError("shape must have at least one axis")
        if any(s < 1 for s in shape):
            raise ValueError(f"invalid shape {shape}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "ndim", len(shape))
        wavelets = _oracle._normalize_wavelets(self.wavelet, len(shape))
        object.__setattr__(self, "wavelets", wavelets)
        if self.path not in _VALID_PATHS:
            raise ValueError(f"path must be one of {_VALID_PATHS}, got {self.path!r}")
        rdt = _as_real_dtype(self.dtype)
        object.__setattr__(self, "real_dtype", rdt)
        # float32 and bfloat16 both promote to complex64 (JAX plan.py:113-120).
        cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
        object.__setattr__(self, "complex_dtype", cdt)
        object.__setattr__(self, "device", torch.device(self.device))

        scale = 1.0 / np.sqrt(2.0) if self.preserve_l2 else 1.0
        resp, taps, taps_hp, flens = [], [], [], []
        np_cdt = np.complex128 if rdt == torch.float64 else np.complex64
        for w, n in zip(wavelets, shape):
            F = _filters.frequency_response(w, n)  # validates K <= n
            # The FFT path's (2, N) response per axis, scale folded in.
            resp.append(np.asarray(scale * F, dtype=np_cdt))
            lo, hi = _filters.correlation_taps(w)
            flens.append(len(lo))
            hp = np.asarray(scale * np.stack([lo, hi]), dtype=np.float64)
            # ``taps`` in the storage dtype drive the direct path; the
            # kernels compute in float32 for bfloat16 arrays too and take
            # ``taps_hp``, so a bf16 plan does not correlate with
            # 3-digit taps (plan.py:132-140 of the JAX package).
            taps.append(torch.from_numpy(hp).to(rdt))
            taps_hp.append(hp)
        object.__setattr__(self, "resp", tuple(resp))
        object.__setattr__(self, "taps", tuple(taps))
        object.__setattr__(self, "taps_hp", tuple(taps_hp))
        object.__setattr__(self, "filter_lengths", tuple(flens))

    # ------------------------------------------------------------ dispatch
    def _route(self, x: torch.Tensor) -> str:
        """``'kernels'`` when ``x`` goes to the CUDA kernels, ``'direct'``
        for the torch direct path, ``'fft'`` for the FFT path; raises for
        what the port does not serve yet."""
        if self.path in ("fft", "direct"):
            return self.path
        if not _is_cuda(x):
            if self.path == "pallas":
                raise ValueError(
                    "path='pallas' runs the CUDA kernels only, and this "
                    f"tensor lies on {x.device}; use path='auto' or 'direct'"
                )
            return "direct"
        if self.ndim > 4:
            raise NotImplementedError(
                f"{self.ndim}D transforms on CUDA are not ported yet: no kernel "
                "takes them (the TPU's flat kernels, ROADMAP.md queue 2 item "
                "12, serve any ndim at small sizes)"
            )
        return "kernels"

    def _uses_kernels(self, x: torch.Tensor) -> bool:
        return self._route(x) == "kernels"

    def _resp(self, device) -> tuple:
        """The FFT path's per-axis responses on ``device``."""
        return tuple(torch.from_numpy(F).to(device) for F in self.resp)

    def _dtype_of(self, x: torch.Tensor) -> torch.dtype:
        return self.complex_dtype if x.is_complex() else self.real_dtype

    def _as_input(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            want = self.device
            if x.device.type != want.type or (
                want.index is not None and x.device.index != want.index
            ):
                raise ValueError(
                    f"tensor on {x.device} given to a plan on {want}: move "
                    "it, or build the plan with device=tensor.device"
                )
        else:
            x = torch.as_tensor(x, device=self.device)
        return x.to(dtype=self._dtype_of(x))

    def _as_pair(self, x_pair) -> torch.Tensor:
        """A split re/im pair ``(2, *shape)``, real, on the plan's device."""
        x_pair = self._as_input(x_pair)
        if x_pair.is_complex():
            raise ValueError(
                "a split pair holds the real and imaginary parts as real "
                "arrays; give complex tensors to dec/rec/dec_rec"
            )
        if tuple(x_pair.shape) != (2,) + self.shape:
            raise ValueError(
                f"expected (2, *{self.shape}) split re/im array, got "
                f"{tuple(x_pair.shape)}"
            )
        return x_pair

    def _dec_bands(self, x, level):
        """Band-first analysis, no autograd."""
        route = self._route(x)
        if route == "fft":
            y = fft_path.dec_fft(x, self._resp(x.device), level,
                                 real_out=not x.is_complex())
            return y.to(self._dtype_of(x))
        if route == "direct":
            return direct_path.dec_direct(x, self.taps, level)
        if x.is_complex():
            return _join(self._dec_pair(_parts(x), level))
        return cuda_kernels.dec_levels(x.contiguous(), self.taps_hp, level)

    def _rec_bands(self, y, level, preserve_l2):
        """Band-first synthesis, no autograd."""
        route = self._route(y)
        if route == "fft":
            x = fft_path.rec_fft(y, self._resp(y.device), level, preserve_l2,
                                 real_out=not y.is_complex())
            return x.to(self._dtype_of(y))
        if route == "direct":
            return direct_path.rec_direct(y, self.taps, level, preserve_l2)
        if y.is_complex():
            return _join(self._rec_pair(_parts(y), level, preserve_l2))
        return cuda_kernels.rec_levels(
            y.contiguous(), self.taps_hp, level, preserve_l2
        )

    def _dec_pair(self, xp, level):
        """``(2, *s)`` real components -> ``(2, B, *s)``: the filters are
        real, so each component runs its own analysis chain."""
        route = self._route(xp)
        if route == "fft":
            return torch.stack([self._dec_bands(xp[c], level) for c in range(2)])
        if route == "direct":
            return direct_path.dec_direct(xp, self.taps, level).transpose(0, 1)
        _no_adjoint_on_kernels(xp, "the split analysis")
        out = torch.empty((2, self.num_bands(level)) + self.shape,
                          dtype=xp.dtype, device=xp.device)
        for c in range(2):
            cuda_kernels.dec_levels(xp[c].contiguous(), self.taps_hp, level,
                                    out=out[c])
        return out

    def _rec_pair(self, yp, level, preserve_l2):
        """``(2, B, *s)`` -> ``(2, *s)``, one synthesis chain per component."""
        route = self._route(yp)
        if route == "fft":
            return torch.stack([self._rec_bands(yp[c], level, preserve_l2)
                                for c in range(2)])
        if route == "direct":
            return direct_path.rec_direct(yp.transpose(0, 1), self.taps, level,
                                          preserve_l2)
        _no_adjoint_on_kernels(yp, "the split synthesis")
        return torch.stack([
            cuda_kernels.rec_levels(yp[c].contiguous(), self.taps_hp, level,
                                    preserve_l2)
            for c in range(2)
        ])

    @staticmethod
    def _check_band_axis(band_axis):
        if band_axis not in (0, -1):
            raise ValueError("band_axis must be 0 or -1")

    def _check_level(self, level) -> int:
        level = int(level)
        if level < 1:
            raise ValueError(f"level must be >= 1, got {level}")
        return level

    def _check_shape(self, x):
        if tuple(x.shape) != self.shape:
            raise ValueError(
                f"input shape {tuple(x.shape)} does not match plan shape "
                f"{self.shape}"
            )

    # ------------------------------------------------------------- public
    def dec(self, x, level: int, band_axis: int = -1):
        """Multilevel analysis. ``band_axis=-1`` gives the reference layout
        ``[n1..nd, B]`` (a view); ``0`` the band-first ``(B, *shape)``."""
        level = self._check_level(level)
        self._check_band_axis(band_axis)
        x = self._as_input(x)
        self._check_shape(x)
        y = _Dec.apply(x, self, level)
        return y.movedim(0, -1) if band_axis == -1 else y

    def rec(self, y, band_axis: int = -1):
        """Multilevel synthesis; level inferred from the band count
        (``Functions/nd_dwt_3D.m:217``)."""
        self._check_band_axis(band_axis)
        y = self._as_input(y)
        if y.ndim != self.ndim + 1:
            raise ValueError(
                f"expected {self.ndim + 1}-D band array, got {y.ndim}-D"
            )
        if band_axis == -1:
            y = y.movedim(-1, 0)
        if tuple(y.shape[1:]) != self.shape:
            raise ValueError(
                f"band array spatial shape {tuple(y.shape[1:])} does not "
                f"match plan shape {self.shape}"
            )
        level = _oracle.level_from_bands(self.ndim, y.shape[0])
        return _Rec.apply(y, self, level)

    @staticmethod
    def _check_threshold(threshold) -> float:
        threshold = float(threshold)
        if threshold < 0:
            raise ValueError(f"threshold must be >= 0, got {threshold}")
        return threshold

    def dec_rec(self, x, level: int, threshold: float = 0.0,
                band_axis: int = -1):
        """One analysis -> soft-threshold(details) -> synthesis iterate;
        returns ``(bands, reconstruction)``. On CUDA the shrink rides the
        analysis kernel's band writes (``lam``), as on the TPU; complex data
        takes the joint-magnitude shrink, one ``mag_shrink_pair`` launch
        between the components' analyses and syntheses."""
        level = self._check_level(level)
        self._check_band_axis(band_axis)
        threshold = self._check_threshold(threshold)
        x = self._as_input(x)
        self._check_shape(x)
        if threshold and self._uses_kernels(x):
            _no_adjoint_on_kernels(x, "dec_rec with a threshold (non-linear)")
            if x.is_complex():
                yp = elemwise.mag_shrink_pair(self._dec_pair(_parts(x), level),
                                              threshold)
                y = _join(yp)
                xr = _join(self._rec_pair(yp, level, self.preserve_l2))
            else:
                y = cuda_kernels.dec_levels(x.contiguous(), self.taps_hp,
                                            level, lam=threshold)
                xr = cuda_kernels.rec_levels(y, self.taps_hp, level,
                                             self.preserve_l2)
        else:
            y = _Dec.apply(x, self, level)
            if threshold:
                y = torch.cat([y[:1], soft_threshold(y[1:], threshold)])
            xr = _Rec.apply(y, self, level)
        return (y.movedim(0, -1) if band_axis == -1 else y), xr

    # ------------------------------------------------------ split-complex
    def dec_split(self, x_pair, level: int):
        """Analysis of complex data in split re/im form: ``(2, *shape)``
        real -> ``(2, B, *shape)`` real, band-first. The filters are real,
        so this equals ``dec`` of ``x_pair[0] + 1j * x_pair[1]``."""
        level = self._check_level(level)
        return self._dec_pair(self._as_pair(x_pair), level)

    def rec_split(self, y_pair):
        """Synthesis from split re/im bands: ``(2, B, *shape)`` ->
        ``(2, *shape)``."""
        y_pair = self._as_input(y_pair)
        if (y_pair.is_complex() or y_pair.ndim != self.ndim + 2
                or y_pair.shape[0] != 2 or tuple(y_pair.shape[2:]) != self.shape):
            raise ValueError(
                f"expected a real (2, B, *{self.shape}) split band array, got "
                f"{y_pair.dtype} {tuple(y_pair.shape)}"
            )
        level = _oracle.level_from_bands(self.ndim, y_pair.shape[1])
        return self._rec_pair(y_pair, level, self.preserve_l2)

    def dec_rec_split(self, x_pair, level: int, threshold: float = 0.0):
        """One split-complex iterate: analysis -> joint re/im magnitude
        soft-threshold of the details (the prox of the complex l1 norm,
        ``Functions/nd_dwt_1D.m:57-61``) -> synthesis. Returns
        ``((2, B, *shape) bands, (2, *shape) reconstruction)``. On the
        kernels: two per-component analysis chains, one ``mag_shrink_pair``
        launch, two synthesis chains; elsewhere the torch shrink, as JAX."""
        threshold = self._check_threshold(threshold)
        y = self.dec_split(x_pair, level)
        if threshold:
            shrink = (elemwise.mag_shrink_pair if self._uses_kernels(y)
                      else soft_threshold_mag_pair)
            y = shrink(y, threshold)
        return y, self.rec_split(y)

    def num_bands(self, level: int) -> int:
        return _oracle.num_bands(self.ndim, level)

    # A plan round-trips through the JAX plan's five config fields; the
    # device is where it runs, not part of the transform.
    def to_config(self) -> dict:
        return {
            "wavelet": list(self.wavelets),
            "shape": list(self.shape),
            "preserve_l2": bool(self.preserve_l2),
            "dtype": str(self.real_dtype).removeprefix("torch."),
            "path": self.path,
        }

    @classmethod
    def from_config(cls, cfg: dict, device="cuda") -> "NDDWT":
        return cls(
            wavelet=tuple(cfg["wavelet"]),
            shape=tuple(cfg["shape"]),
            preserve_l2=cfg.get("preserve_l2", False),
            dtype=cfg.get("dtype", "float32"),
            path=cfg.get("path", "auto"),
            device=device,
        )
