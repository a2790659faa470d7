"""Transform plan: validated config + cached filter bank + dec/rec, in torch.

Port of ``non_decimated_wavelets_tpu/plan.py`` (``NDDWT`` core: ``dec``,
``rec``, ``dec_rec``, complex data, the split-complex ``dec_split``,
``rec_split``, ``dec_rec_split``, the batched ``dec_batched`` and
``rec_batched``, band layouts, level inference, config round trip). The
plan builds the per-axis correlation taps once, as the reference's
constructors do (``Functions/nd_dwt_2D.m:1-4``), and names the device its
transforms run on: the card (``"cuda"``) unless the caller asks for
``device="cpu"``.

Dispatch:

* a CUDA tensor of at most ``ops/flat.py``'s ``FLAT_MAX_NUMEL`` elements
  for the per-level route it would take (a complex array's or a split
  pair's two components counted), any ndim up to 8, float32, bfloat16 or
  float64: the one-launch flat kernel
  (``nddwt_flat_pair``): ``dec``, ``rec``, ``dec_rec`` and their split and
  complex forms are one launch each, complex data as a re/im pair whose
  shrink is the joint magnitude. ``dec_rec_n`` and the solvers' fused
  route (``_fista_fused``) run a whole chain or solve in one
  ``nddwt_flat_iter`` launch up to ``ITER_MAX_NUMEL`` (route ``iter``);
* a larger CUDA tensor, 2D or 3D, with at least two levels and at most
  ``ops/multi.py``'s ``MULTI_MAX_NUMEL`` elements a component, whose
  levels the per-level kernels' streamed bodies take (in 3D, filters
  shorter than those of ``stage_route``): the one-launch multilevel
  kernels (``nddwt_dec_multi``, ``nddwt_rec_multi``), one launch per
  direction for all levels and both components of a complex array or a
  split pair (a batch of 2); a thresholded complex ``dec_rec`` is
  ``dec_multi`` -> ``mag_shrink_pair`` -> ``rec_multi``;
* any other larger CUDA tensor, 1D to 4D: the hand-written level kernels
  (``ops/cuda_kernels.py``): per level and direction one launch in 1D, 2D
  and 3D, two (a lane and a lead stage) in 4D and for the 3D filters of
  ``stage_route`` (db15 and up); the shrink of ``dec_rec``
  fused into the analysis. Complex data (complex64, complex128) and split
  re/im pairs run each component through its own level chain (the filters
  are real); their shrink is the joint-magnitude ``mag_shrink_pair`` kernel
  (``ops/elemwise.py``). A larger 5D+ tensor raises
  ``NotImplementedError``; nothing runs silently on torch ops;
* a CUDA batch (``dec_batched``, ``rec_batched``) whose items the
  multilevel kernels take (as above, by the size of one item): one launch
  per direction for the whole batch, complex items as a batch of 2N real
  components; any other CUDA batch runs item by item on ``dec``'s and
  ``rec``'s own route;
* float64 computes in float64 on every kernel (the TPU package's
  double-f32 kernels, ``pallas_df32``, exist only because the TPU has no
  float64 units);
* a CPU tensor: the torch direct path (``ops/direct_path.py``), complex
  data and batches included.

``path`` picks the route as in the JAX plan: ``'auto'`` as above;
``'direct'`` the torch direct path on any device (batch-native for a
batch); ``'pallas'`` the kernels only (a tensor they cannot take raises);
``'fft'`` the FFT path (``ops/fft_path.py``, cuFFT on the card) on any
device, item by item for a batch. A tensor must already lie on the plan's
``device``: the plan never copies one between devices, so work on the card
cannot end up on the host.

Every public call decides its route once, from shapes and dtypes
(``NDDWT.route``: ``fft``, ``direct``, ``flat``, ``multi``, ``stage`` or
``level``, and ``iter`` for a whole chain or solve in one launch), hands it
down to the kernel wrappers, which do not decide it again, and runs inside
the span ``nddwt.<op>.<route>.L<level>`` (``tracing.entry``); the copies between
complex and re/im form run inside ``nddwt.split`` and ``nddwt.join`` and
count their bytes in ``split_join_bytes``.

Autograd: ``dec`` and ``rec`` are ``torch.autograd.Function`` s whose
backward is the exact adjoint, as the JAX package's ``linear_call`` rules
(``ops/pallas_kernels.py:898-902,1703-1713``): the adjoint of ``dec`` is the
synthesis with ``preserve_l2=True`` on the same taps, and the adjoint of
``rec`` is ``dec`` with the per-level ``1/2^d`` redistributed onto the band
groups when not ``preserve_l2``, on the flat and the per-level kernels
alike, and for a batch (``dec_batched``, ``rec_batched``) the batched
adjoint by the same rules. ``dec_rec`` with a threshold on CUDA is
non-linear and has no adjoint, as in JAX; nor do the split transforms,
``dec_rec_n`` and the fused solve on CUDA; a ``dec_rec`` without threshold
whose input needs a gradient runs as ``dec`` and ``rec``. The same rules serve 1D, float64
and the FFT path (the JAX package's ``dec64``/``rec64`` carry the same
``linear_call`` rules, ``ops/pallas_df32.py:548-610``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import filters as _filters
from . import oracle as _oracle
from . import tracing
from .models.denoise import soft_threshold, soft_threshold_mag_pair
from .ops import cuda_kernels, direct_path, elemwise, fft_path, flat, multi

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


def _copied(name: str, fn, src):
    """``fn(src)``, a copy between complex and re/im form or one that
    gathers per-component results, inside the span ``name``; the bytes it
    reads (``src``: a tensor or a list of them) and writes are added to
    the counter ``split_join_bytes``."""
    with tracing.span(name) as on:
        out = fn(src)
        if on:
            read = sum(t.nbytes for t in src) if isinstance(src, list) else src.nbytes
            tracing.count("split_join_bytes", read + out.nbytes)
    return out


def _parts(z: torch.Tensor) -> torch.Tensor:
    """Complex ``(*s)`` -> the real ``(2, *s)`` re/im pair."""
    return _copied("nddwt.split", lambda t: torch.stack([t.real, t.imag]), z)


def _join(pair: torch.Tensor) -> torch.Tensor:
    """The real ``(2, *s)`` re/im pair -> complex ``(*s)``."""
    return _copied("nddwt.join", lambda t: torch.complex(t[0], t[1]), pair)


def _gather(components: list) -> torch.Tensor:
    """The per-component results -> the real ``(2, *s)`` pair."""
    return _copied("nddwt.join", torch.stack, components)


def _batch_parts(z: torch.Tensor) -> torch.Tensor:
    """A complex batch ``(N, ...)`` -> ``2N`` real components, the real
    parts first."""
    return _copied("nddwt.split", lambda t: torch.cat([t.real, t.imag]), z)


def _batch_join(t: torch.Tensor) -> torch.Tensor:
    """``2N`` real components, the real parts first -> the complex batch
    ``(N, ...)``."""
    n = t.shape[0] // 2
    return _copied("nddwt.join", lambda c: torch.complex(c[:n], c[n:]), t)


_REAL_PART = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _no_adjoint_on_kernels(t: torch.Tensor, what: str) -> None:
    if _needs_grad(t):
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
    """``dec`` (``batched``: ``dec_batched``) on ``route``; the backward is
    the synthesis with ``preserve_l2=True``."""

    @staticmethod
    def forward(ctx, x, plan, level, batched=False, route=None):
        ctx.plan, ctx.level, ctx.batched = plan, level, batched
        return plan._dec_bands(x, level, batched, route=route)

    @staticmethod
    def backward(ctx, gy):
        return (ctx.plan._rec_bands(gy, ctx.level, True, ctx.batched),
                None, None, None, None)


class _Rec(torch.autograd.Function):
    """``rec`` (``batched``: ``rec_batched``) on ``route``; the backward is
    the analysis, the per-level ``1/2^d`` redistributed onto the band
    groups when not ``preserve_l2``."""

    @staticmethod
    def forward(ctx, y, plan, level, batched=False, route=None):
        ctx.plan, ctx.level, ctx.batched = plan, level, batched
        return plan._rec_bands(y, level, plan.preserve_l2, batched, route=route)

    @staticmethod
    def backward(ctx, gx):
        plan, level = ctx.plan, ctx.level
        z = plan._dec_bands(gx, level, ctx.batched)
        if not plan.preserve_l2:
            s = torch.as_tensor(_rec_transpose_scales(plan.ndim, level))
            z = z * s.to(z.dtype).to(z.device).view((-1,) + (1,) * plan.ndim)
        return z, None, None, None, None


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
    def route(self, dtype, level: int, *, pair: bool = False, batch: int = 0,
              whole: bool = False, on_card=None) -> str:
        """The route a transform of ``level`` levels of ``dtype`` arrays
        takes, from shapes and dtypes alone: ``'fft'`` or ``'direct'`` (the
        torch paths), or on the CUDA kernels ``'flat'`` (the one-launch flat
        kernel), ``'multi'`` (the one-launch multilevel kernels), ``'stage'``
        (the lane and lead stage kernels) or ``'level'`` (the per-level
        kernels). ``pair``: a split re/im pair of real arrays (a complex
        ``dtype`` is one too); ``batch``: the items of a ``dec_batched`` or
        ``rec_batched`` call, 0 for one array; ``whole``: the caller runs a
        whole chain of sweeps or a whole solve (``dec_rec_n``, the fused
        inpainting solve), which is ``'iter'`` where one ``nddwt_flat_iter``
        launch takes it (real arrays, up to ``ITER_MAX_NUMEL``) and
        otherwise the route of its iterates; ``on_card``: whether the arrays
        lie on a CUDA device (by default the plan's device). Raises where the
        port serves no route. The only place a route is chosen: every public
        call dispatches on it and names its span after it (``tracing.entry``).

        On the kernels, in order: a batch takes the multilevel kernels
        where ``multi.multi_supported`` holds; one array (or pair) takes the
        flat kernel up to the limit measured against the route it replaces
        (``flat.FLAT_MAX_NUMEL``: ``'1d'``, ``'stage'`` or the others), else
        the multilevel kernels as a batch does; the rest takes the stage
        kernels (every 4D level, and the 3D levels of
        ``cuda_kernels.stage_route``, which the multilevel kernels never
        take) or the per-level kernels."""
        if self.path in ("fft", "direct"):
            return self.path
        if not (self.device.type == "cuda" if on_card is None else on_card):
            if self.path == "pallas":
                raise ValueError(
                    "path='pallas' runs the CUDA kernels only, and this "
                    "tensor is not on a CUDA device; use path='auto' or 'direct'"
                )
            return "direct"
        if whole and not dtype.is_complex and flat.iter_supported(
                self.shape, dtype, 2 if pair else 0):
            return "iter"
        real = _REAL_PART.get(dtype, dtype)
        stage = cuda_kernels.stage_route(self.shape, self.taps_hp, real)

        def on_multi():
            return not stage and multi.multi_supported(self.shape, self.taps_hp, real, level)

        if batch and on_multi():
            return "multi"
        replaces = "1d" if self.ndim == 1 else ("stage" if stage else None)
        if flat.flat_supported(self.shape, real, 2 if pair or dtype.is_complex else 0,
                               replaces=replaces):
            return "flat"
        if self.ndim > 4:
            raise NotImplementedError(
                f"{self.ndim}D transforms on CUDA run on the one-launch flat "
                f"kernel only, up to {flat.flat_limit(replaces)} elements (a "
                "pair's two components counted); larger ones are not ported yet "
                "(ROADMAP.md queue 1 item 16)"
            )
        if on_multi():
            return "multi"
        return "stage" if stage else "level"

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

    def _dec_bands(self, x, level, batched=False, route=None):
        """Band-first analysis on ``route`` (``x``'s own when None), no
        autograd; ``batched``: ``(N, *s)`` -> ``(N, B, *s)``."""
        if route is None:
            route = self.route(x.dtype, level, batch=x.shape[0] if batched else 0)
        if batched:
            return self._dec_batch(x, level, route)
        if route == "fft":
            y = fft_path.dec_fft(x, self._resp(x.device), level,
                                 real_out=not x.is_complex())
            return y.to(self._dtype_of(x))
        if route == "direct":
            return direct_path.dec_direct(x, self.taps, level)
        if x.is_complex():
            return _join(self._dec_pair(_parts(x), level, route))
        if route == "flat":
            return flat.dec_flat(x.contiguous(), self.taps_hp, level)
        return self._dec_kernels(x.contiguous(), level, route)

    def _rec_bands(self, y, level, preserve_l2, batched=False, route=None):
        """Band-first synthesis on ``route`` (``y``'s own when None), no
        autograd; ``batched``: ``(N, B, *s)`` -> ``(N, *s)``."""
        if route is None:
            route = self.route(y.dtype, level, batch=y.shape[0] if batched else 0)
        if batched:
            return self._rec_batch(y, level, preserve_l2, route)
        if route == "fft":
            x = fft_path.rec_fft(y, self._resp(y.device), level, preserve_l2,
                                 real_out=not y.is_complex())
            return x.to(self._dtype_of(y))
        if route == "direct":
            return direct_path.rec_direct(y, self.taps, level, preserve_l2)
        if y.is_complex():
            return _join(self._rec_pair(_parts(y), level, preserve_l2, route))
        if route == "flat":
            return flat.rec_flat(y.contiguous(), self.taps_hp, level, preserve_l2)
        return self._rec_kernels(y.contiguous(), level, preserve_l2, route)

    def _dec_kernels(self, x, level, route, lam=0.0, out=None):
        """``(*s)`` -> ``(B, *s)`` (into ``out`` when given), the details
        shrunk by ``lam``, on ``route``'s kernels: one multilevel launch
        (a batch of one), or the per-level loop of the level or the stage
        kernels."""
        if route == "multi":
            return multi.dec_multi(x[None], self.taps_hp, level, lam,
                                   None if out is None else out[None])[0]
        return cuda_kernels.dec_levels(x, self.taps_hp, level, lam, out,
                                       stages=route == "stage")

    def _rec_kernels(self, y, level, preserve_l2, route):
        """``(B, *s)`` -> ``(*s)`` on ``route``'s kernels, as
        ``_dec_kernels``."""
        if route == "multi":
            return multi.rec_multi(y[None], self.taps_hp, level, preserve_l2)[0]
        return cuda_kernels.rec_levels(y, self.taps_hp, level, preserve_l2,
                                       stages=route == "stage")

    def _dec_pair(self, xp, level, route):
        """``(2, *s)`` real components -> ``(2, B, *s)`` on a pair's
        ``route``: the filters are real, so the components are a batch of
        two (one flat or multilevel launch) or each runs its own analysis
        chain."""
        if route == "fft":
            return _gather([self._dec_bands(xp[c], level, route=route)
                            for c in range(2)])
        if route == "direct":
            return direct_path.dec_direct(xp, self.taps, level).transpose(0, 1)
        _no_adjoint_on_kernels(xp, "the split analysis")
        if route == "flat":
            return flat.dec_split_flat(xp.contiguous(), self.taps_hp, level)
        if route == "multi":
            return multi.dec_multi(xp.contiguous(), self.taps_hp, level)
        out = torch.empty((2, self.num_bands(level)) + self.shape,
                          dtype=xp.dtype, device=xp.device)
        for c in range(2):
            self._dec_kernels(xp[c].contiguous(), level, route, out=out[c])
        return out

    def _rec_pair(self, yp, level, preserve_l2, route):
        """``(2, B, *s)`` -> ``(2, *s)`` on a pair's ``route``: one flat or
        multilevel launch for both components, or one synthesis chain
        each, whose last launch writes its component of the result."""
        if route == "fft":
            return _gather([self._rec_bands(yp[c], level, preserve_l2, route=route)
                            for c in range(2)])
        if route == "direct":
            return direct_path.rec_direct(yp.transpose(0, 1), self.taps, level,
                                          preserve_l2)
        _no_adjoint_on_kernels(yp, "the split synthesis")
        if route == "flat":
            return flat.rec_split_flat(yp.contiguous(), self.taps_hp, level,
                                       preserve_l2)
        if route == "multi":
            return multi.rec_multi(yp.contiguous(), self.taps_hp, level,
                                   preserve_l2)
        out = torch.empty((2,) + self.shape, dtype=yp.dtype, device=yp.device)
        for c in range(2):
            cuda_kernels.rec_levels(yp[c].contiguous(), self.taps_hp, level,
                                    preserve_l2, out[c], stages=route == "stage")
        return out

    def _dec_batch(self, x, level, route):
        """``(N, *s)`` -> ``(N, B, *s)`` on a batch's ``route``, no autograd
        (JAX ``plan.py:604-643``): the direct path batch-native; on the
        multilevel route one launch for the whole batch, complex items as 2N
        real components; otherwise item by item on ``dec``'s route."""
        if route == "direct":
            return direct_path.dec_direct(x, self.taps, level).transpose(0, 1)
        if route == "multi":
            if not x.is_complex():
                return multi.dec_multi(x.contiguous(), self.taps_hp, level)
            return _batch_join(multi.dec_multi(_batch_parts(x), self.taps_hp, level))
        return torch.stack([self._dec_bands(v, level, route=route) for v in x])

    def _rec_batch(self, y, level, preserve_l2, route):
        """``(N, B, *s)`` -> ``(N, *s)``, no autograd, by the rules of
        ``_dec_batch``."""
        if route == "direct":
            return direct_path.rec_direct(y.transpose(0, 1), self.taps, level,
                                          preserve_l2)
        if route == "multi":
            if not y.is_complex():
                return multi.rec_multi(y.contiguous(), self.taps_hp, level,
                                       preserve_l2)
            return _batch_join(multi.rec_multi(_batch_parts(y), self.taps_hp,
                                               level, preserve_l2))
        return torch.stack([self._rec_bands(v, level, preserve_l2, route=route)
                            for v in y])

    def _bands_last(self, band_axis) -> bool:
        """Whether ``band_axis`` names the band-last layout: ``-1`` or its
        positive index ``ndim`` (JAX ``plan.py:368``); ``0`` is band-first,
        anything else raises."""
        if band_axis in (-1, self.ndim):
            return True
        if band_axis != 0:
            raise ValueError(f"band_axis must be 0, -1 or {self.ndim}")
        return False

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
        """Multilevel analysis. ``band_axis=-1`` (or ``ndim``) gives the
        reference layout ``[n1..nd, B]`` (a view); ``0`` the band-first
        ``(B, *shape)``."""
        level = self._check_level(level)
        last = self._bands_last(band_axis)
        x = self._as_input(x)
        self._check_shape(x)
        route = self.route(x.dtype, level)
        with tracing.entry("dec", route, level):
            y = _Dec.apply(x, self, level, False, route)
        return y.movedim(0, -1) if last else y

    def rec(self, y, band_axis: int = -1):
        """Multilevel synthesis; level inferred from the band count
        (``Functions/nd_dwt_3D.m:217``)."""
        last = self._bands_last(band_axis)
        y = self._as_input(y)
        if y.ndim != self.ndim + 1:
            raise ValueError(
                f"expected {self.ndim + 1}-D band array, got {y.ndim}-D"
            )
        if last:
            y = y.movedim(-1, 0)
        if tuple(y.shape[1:]) != self.shape:
            raise ValueError(
                f"band array spatial shape {tuple(y.shape[1:])} does not "
                f"match plan shape {self.shape}"
            )
        level = _oracle.level_from_bands(self.ndim, y.shape[0])
        route = self.route(y.dtype, level)
        with tracing.entry("rec", route, level):
            return _Rec.apply(y, self, level, False, route)

    @staticmethod
    def _check_threshold(threshold) -> float:
        threshold = float(threshold)
        if threshold < 0:
            raise ValueError(f"threshold must be >= 0, got {threshold}")
        return threshold

    def dec_rec(self, x, level: int, threshold: float = 0.0,
                band_axis: int = -1):
        """One analysis -> soft-threshold(details) -> synthesis iterate;
        returns ``(bands, reconstruction)``. A negative threshold raises
        ``ValueError`` (the JAX plan takes one and grows the details). On
        CUDA within the flat kernel's size the whole iterate is one
        ``nddwt_flat_pair`` launch, complex data as a re/im pair with the
        joint-magnitude shrink; beyond it the shrink rides the multilevel or
        per-level analysis kernels' band writes (``lam``), as on the TPU,
        and complex data takes one ``mag_shrink_pair`` launch between the
        components' analyses and syntheses (one multilevel launch each,
        where the multilevel kernels take the shape). On the kernels,
        complex data is split into its re/im pair once and its bands and
        reconstruction joined once each; the per-level syntheses write
        their components of the pair in place."""
        return self._dec_rec(x, level, threshold, band_axis, bands=True)

    def _iterate(self, x, level: int, threshold: float):
        """``dec_rec(x, level, threshold, band_axis=0)[1]`` without the
        bands: the solvers' prox ``W^T shrink(W x)``. Complex data on the
        flat route, or with a threshold on the other kernel routes, never
        joins its bands, so the iterate's only copies are the split of
        ``x`` and the join of the reconstruction; every other call runs as
        ``dec_rec``."""
        return self._dec_rec(x, level, threshold, 0, bands=False)[1]

    def _dec_rec(self, x, level, threshold, band_axis, bands):
        """The body of ``dec_rec`` and ``_iterate``, inside the span
        ``nddwt.dec_rec.<route>.L<level>``; without ``bands`` the first
        result is None where the bands would only be joined for it."""
        level = self._check_level(level)
        last = self._bands_last(band_axis)
        threshold = self._check_threshold(threshold)
        x = self._as_input(x)
        self._check_shape(x)
        route = self.route(x.dtype, level)
        kernels = route not in ("fft", "direct")
        if kernels and threshold:
            _no_adjoint_on_kernels(x, "dec_rec with a threshold (non-linear)")
        with tracing.entry("dec_rec", route, level):
            if route == "flat" and not _needs_grad(x):
                if x.is_complex():
                    yp, xp = flat.pair_split_flat(
                        _parts(x), self.taps_hp, level, self.preserve_l2, threshold)
                    y, xr = (_join(yp) if bands else None), _join(xp)
                else:
                    y, xr = flat.pair_flat(x.contiguous(), self.taps_hp, level,
                                           self.preserve_l2, threshold)
            elif kernels and threshold:
                if x.is_complex():
                    yp = elemwise.mag_shrink_pair(
                        self._dec_pair(_parts(x), level, route), threshold)
                    y = _join(yp) if bands else None
                    xr = _join(self._rec_pair(yp, level, self.preserve_l2, route))
                else:
                    y = self._dec_kernels(x.contiguous(), level, route, lam=threshold)
                    xr = self._rec_kernels(y, level, self.preserve_l2, route)
            else:
                y = _Dec.apply(x, self, level, False, route)
                if threshold:
                    y = torch.cat([y[:1], soft_threshold(y[1:], threshold)])
                xr = _Rec.apply(y, self, level, False, route)
        return (y.movedim(0, -1) if last and y is not None else y), xr

    def dec_rec_n(self, x, level: int, thresholds):
        """``len(thresholds)`` ``dec -> soft-threshold -> rec`` sweeps, one
        threshold each; returns the reconstruction after the last (JAX
        ``plan.py:516-559``). Real data only (complex raises
        ``ValueError``); at least one sweep; a negative threshold raises
        ``ValueError``, as in ``dec_rec``. On CUDA up to ``ITER_MAX_NUMEL``
        elements the whole chain is one ``nddwt_flat_iter`` launch;
        elsewhere it loops ``dec_rec``."""
        level = self._check_level(level)
        thresholds = [self._check_threshold(t) for t in thresholds]
        if not thresholds:
            raise ValueError("thresholds must contain at least one sweep")
        x = self._as_input(x)
        self._check_shape(x)
        if x.is_complex():
            raise ValueError(
                "dec_rec_n is real-only; split complex data and use the "
                "split entry points"
            )
        route = self.route(x.dtype, level, whole=True)
        with tracing.entry("dec_rec_n", route, level):
            if route == "iter":
                _no_adjoint_on_kernels(x, "dec_rec_n")
                return flat.chain_flat(x.contiguous(), self.taps_hp, level,
                                       self.preserve_l2, thresholds)
            for lam in thresholds:
                _, x = self.dec_rec(x, level, threshold=lam, band_axis=0)
        return x

    def _fista_fused(self, b, mask, level, lams, moms, step, split=False):
        """A whole FISTA inpainting solve (the image-domain masked data
        term, schedule ``lams``/``moms``) in one ``nddwt_flat_iter`` launch,
        on the route ``'iter'`` (JAX ``plan.py:561-601``). ``split`` takes a
        ``(2, *shape)`` re/im pair with the joint-magnitude shrink. Used by
        ``models.fista_inpaint`` and ``fista_inpaint_split``, which give
        ``b`` and ``mask`` on the plan's device."""
        want = ((2,) + self.shape) if split else self.shape
        if tuple(b.shape) != want:
            raise ValueError(
                f"input shape {tuple(b.shape)} does not match plan shape {want}"
            )
        if tuple(mask.shape) != self.shape:
            raise ValueError(
                f"mask shape {tuple(mask.shape)} does not match plan shape "
                f"{self.shape}"
            )
        level = self._check_level(level)
        _no_adjoint_on_kernels(b, "the fused FISTA solve")
        solve = flat.fista_split_flat if split else flat.fista_flat
        return solve(b.contiguous(), mask.to(b.dtype).contiguous(), self.taps_hp,
                     level, self.preserve_l2, lams, moms, float(step))

    # ------------------------------------------------------------ batched
    def dec_batched(self, x, level: int):
        """Analysis of a batch of arrays: ``(N, *shape) -> (N, B, *shape)``,
        band-first per item (multi-coil MRI, cycle spinning). On CUDA a
        batch of 2D or 3D items that the multilevel kernels take is one
        ``nddwt_dec_multi`` launch (complex items as 2N real components);
        other batches run item by item on ``dec``'s route. Differentiable
        as ``dec``."""
        level = self._check_level(level)
        x = self._as_input(x)
        if x.ndim != self.ndim + 1 or tuple(x.shape[1:]) != self.shape or x.shape[0] < 1:
            raise ValueError(
                f"expected (N, *{self.shape}) batch with N >= 1, got "
                f"{tuple(x.shape)}"
            )
        route = self.route(x.dtype, level, batch=x.shape[0])
        with tracing.entry("dec_batched", route, level):
            return _Dec.apply(x, self, level, True, route)

    def rec_batched(self, y):
        """Synthesis of a batch: ``(N, B, *shape) -> (N, *shape)``, the level
        inferred from ``B``; one ``nddwt_rec_multi`` launch where
        ``dec_batched`` takes one ``nddwt_dec_multi``."""
        y = self._as_input(y)
        if y.ndim != self.ndim + 2 or tuple(y.shape[2:]) != self.shape or y.shape[0] < 1:
            raise ValueError(
                f"expected (N, B, *{self.shape}) batch of band arrays with "
                f"N >= 1, got {tuple(y.shape)}"
            )
        level = _oracle.level_from_bands(self.ndim, y.shape[1])
        route = self.route(y.dtype, level, batch=y.shape[0])
        with tracing.entry("rec_batched", route, level):
            return _Rec.apply(y, self, level, True, route)

    # ------------------------------------------------------ split-complex
    def dec_split(self, x_pair, level: int):
        """Analysis of complex data in split re/im form: ``(2, *shape)``
        real -> ``(2, B, *shape)`` real, band-first. The filters are real,
        so this equals ``dec`` of ``x_pair[0] + 1j * x_pair[1]``."""
        level = self._check_level(level)
        x_pair = self._as_pair(x_pair)
        route = self.route(x_pair.dtype, level, pair=True)
        with tracing.entry("dec_split", route, level):
            return self._dec_pair(x_pair, level, route)

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
        route = self.route(y_pair.dtype, level, pair=True)
        with tracing.entry("rec_split", route, level):
            return self._rec_pair(y_pair, level, self.preserve_l2, route)

    def dec_rec_split(self, x_pair, level: int, threshold: float = 0.0):
        """One split-complex iterate: analysis -> joint re/im magnitude
        soft-threshold of the details (the prox of the complex l1 norm,
        ``Functions/nd_dwt_1D.m:57-61``) -> synthesis. Returns
        ``((2, B, *shape) bands, (2, *shape) reconstruction)``. On the
        kernels: one ``nddwt_flat_pair`` launch within the flat kernel's
        size, else one multilevel analysis launch (or two per-component
        chains), one ``mag_shrink_pair`` launch and one synthesis launch
        (or two chains); elsewhere the torch shrink, as JAX."""
        threshold = self._check_threshold(threshold)
        level = self._check_level(level)
        x_pair = self._as_pair(x_pair)
        route = self.route(x_pair.dtype, level, pair=True)
        with tracing.entry("dec_rec_split", route, level):
            if route == "flat":
                _no_adjoint_on_kernels(x_pair, "the split iterate")
                return flat.pair_split_flat(x_pair.contiguous(), self.taps_hp,
                                            level, self.preserve_l2, threshold)
            y = self._dec_pair(x_pair, level, route)
            if threshold:
                shrink = (soft_threshold_mag_pair if route in ("fft", "direct")
                          else elemwise.mag_shrink_pair)
                y = shrink(y, threshold)
            return y, self._rec_pair(y, level, self.preserve_l2, route)

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
