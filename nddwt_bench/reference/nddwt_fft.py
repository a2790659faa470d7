"""The benchmark's plain reference transform: the FFT-domain non-decimated
wavelet transform of the MATLAB original, in plain PyTorch.

It follows ``Functions/nd_dwt_3D.m`` of the original (``SURVEY.md`` §3.1-3.3)
for any number of axes:

* per axis, the decomposition filters of ``wave_filters.m`` (the scaling
  taps reversed, and their quadrature mirror), zero-padded to the axis,
  transformed and advanced by half the filter length,
  ``shift[k] = exp(2j*pi*(K/2)*k/N)``;
* the ``2^d`` separable outer products held as one precomputed
  frequency-domain bank ``f_dec`` (band bit ``a`` selects axis ``a``'s
  high-pass, axis 0 toggling fastest), scaled by ``1/sqrt(2^d)`` iff
  ``preserve_l2``;
* analysis: ``y_b = ifftn(fftn(a) * f_dec_b)`` for every band, the same
  filters applied to the approximation band ``a`` again at every level and
  each level's bands put in front of the shallower levels' details (band 0
  is the deepest approximation, level-1 details come last);
* synthesis, the adjoint: ``ifftn(sum_b fftn(y_b) * conj(f_dec_b))`` per
  level, divided by ``2^d`` iff not ``preserve_l2``;
* real input gives real bands and a real reconstruction.

Leading axes of an array are a batch: the transform runs over the last
``d`` axes. ``Precision`` sets the arithmetic: float64 for the reference
itself, or bfloat16 storage (every stored result rounded to bfloat16,
computed in float32) for the control that the correctness limits are held
against. The module imports torch alone.
"""

from __future__ import annotations

import math

import torch

from .taps import scaling_taps


class Precision:
    """The arithmetic of a reference run: ``"float64"`` computes in float64
    and complex128; ``"bfloat16"`` computes in float32 and complex64 and
    rounds every stored result to bfloat16 (each component of a complex
    one), as a program that keeps its arrays in bfloat16 would."""

    def __init__(self, name: str):
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"precision must be float64 or bfloat16, got {name!r}")
        self.name = name
        self.real = torch.float64 if name == "float64" else torch.float32
        self.complex = torch.complex128 if name == "float64" else torch.complex64

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as this precision stores it."""
        if self.name == "float64":
            return t
        if t.is_complex():
            return torch.view_as_complex(
                torch.view_as_real(t).to(torch.bfloat16).to(torch.float32).contiguous())
        return t.to(torch.bfloat16).to(torch.float32)


def decomposition_filters(wavelet: str) -> tuple:
    """``(lo_d, hi_d)`` as ``wave_filters.m`` returns them: the scaling
    taps reversed, and the high-pass ``hi_d[m] = (-1)^(m+1) h[m]``."""
    h = torch.tensor(scaling_taps(wavelet), dtype=torch.float64)
    sign = torch.tensor([(-1.0) ** (m + 1) for m in range(len(h))],
                        dtype=torch.float64)
    return h.flip(0), sign * h


def axis_response(wavelet: str, n: int) -> torch.Tensor:
    """The ``(2, n)`` complex128 low- and high-pass responses of one axis
    with the half-length advance (``nd_dwt_3D.m:308-310``)."""
    lo_d, hi_d = decomposition_filters(wavelet)
    k = len(lo_d)
    if k > n:
        raise ValueError(f"axis of length {n} is shorter than the {wavelet} filter")
    shift = torch.exp(2j * math.pi * (k / 2) * torch.arange(n, dtype=torch.float64) / n)
    return torch.stack([torch.fft.fft(lo_d, n), torch.fft.fft(hi_d, n)]) * shift


class FilterBank:
    """The precomputed frequency-domain bank ``f_dec`` of one configuration:
    ``(2^d, *shape)`` in the precision's complex type, on ``device``."""

    def __init__(self, wavelets, shape, preserve_l2: bool, prec: Precision, device):
        shape = tuple(int(s) for s in shape)
        d = len(shape)
        if isinstance(wavelets, str):
            wavelets = (wavelets,) * d
        self.shape, self.ndim, self.preserve_l2, self.prec = shape, d, preserve_l2, prec
        resp = [axis_response(w, n).to(device) for w, n in zip(wavelets, shape)]
        scale = 1.0 / math.sqrt(2.0**d) if preserve_l2 else 1.0
        bank = torch.empty((2**d,) + shape, dtype=torch.complex128, device=device)
        for b in range(2**d):
            f = torch.full(shape, scale, dtype=torch.complex128, device=device)
            for a, r in enumerate(resp):
                view = [1] * d
                view[a] = shape[a]
                f = f * r[(b >> a) & 1].view(view)
            bank[b] = f
        self.f = prec.q(bank.to(prec.complex))

    def num_bands(self, level: int) -> int:
        nb = 2**self.ndim
        return nb + (nb - 1) * (level - 1)


def _dims(bank: FilterBank) -> tuple:
    return tuple(range(-bank.ndim, 0))


def dec(x: torch.Tensor, bank: FilterBank, level: int) -> torch.Tensor:
    """Multilevel analysis of ``x`` (``(..., *shape)``) into band-first
    ``(..., B, *shape)``; real input gives real bands."""
    q, dims, d = bank.prec.q, _dims(bank), bank.ndim
    real = not x.is_complex()
    nb = 2**d
    lead = tuple(x.shape[: x.ndim - d])
    out = torch.empty(lead + (bank.num_bands(level),) + bank.shape,
                      dtype=bank.prec.real if real else bank.prec.complex,
                      device=x.device)
    approx = q(x.to(bank.prec.complex))
    slot = out.shape[len(lead)]
    for _ in range(level):
        spec = q(torch.fft.fftn(approx, dim=dims)).unsqueeze(-d - 1)
        bands = q(torch.fft.ifftn(q(spec * bank.f), dim=dims))
        del spec
        # This level's details go in front of the shallower levels' ones.
        slot -= nb - 1
        det = bands.narrow(-d - 1, 1, nb - 1)
        out.narrow(len(lead), slot, nb - 1).copy_(det.real if real else det)
        approx = bands.select(-d - 1, 0).contiguous()
        del bands, det
    out.select(len(lead), 0).copy_(approx.real if real else approx)
    return out


def rec(y: torch.Tensor, bank: FilterBank) -> torch.Tensor:
    """Multilevel synthesis of band-first ``(..., B, *shape)``; the level
    follows from ``B``."""
    q, dims, d = bank.prec.q, _dims(bank), bank.ndim
    nb = 2**d
    axis = y.ndim - d - 1
    level, rem = divmod(y.shape[axis] - nb, nb - 1)
    if rem or level < 0:
        raise ValueError(f"{y.shape[axis]} bands is no {d}-D multilevel layout")
    level += 1
    real = not y.is_complex()
    conj = bank.f.conj()

    def synth(first: torch.Tensor, rest: torch.Tensor) -> torch.Tensor:
        acc = q(torch.fft.fftn(q(first.to(bank.prec.complex)), dim=dims) * conj[0])
        for b in range(1, nb):
            band = q(rest.select(axis, b - 1).to(bank.prec.complex))
            acc = q(acc + q(torch.fft.fftn(band, dim=dims) * conj[b]))
        x = q(torch.fft.ifftn(acc, dim=dims))
        return x if bank.preserve_l2 else q(x / nb)

    x = synth(y.select(axis, 0), y.narrow(axis, 1, nb - 1))
    pos = nb
    for _ in range(1, level):
        x = synth(x, y.narrow(axis, pos, nb - 1))
        pos += nb - 1
    return x.real.contiguous() if real else x


def soft_threshold(y: torch.Tensor, lam: float, prec: Precision) -> torch.Tensor:
    """``y * max(|y| - lam, 0) / |y|`` (0 where ``y`` is 0): the soft
    threshold of real data, and of complex data by its magnitude."""
    mag = y.abs()
    tiny = torch.finfo(mag.dtype).tiny
    return prec.q(y * (torch.clamp(mag - lam, min=0.0) / torch.clamp(mag, min=tiny)))


def shrink_details(y: torch.Tensor, lam: float, ndim: int, prec: Precision) -> torch.Tensor:
    """``y`` with every band but the deepest approximation (band 0 of the
    band axis, ``ndim`` axes from the end) soft-thresholded, in place."""
    axis = y.ndim - ndim - 1
    det = y.narrow(axis, 1, y.shape[axis] - 1)
    det.copy_(soft_threshold(det, lam, prec))
    return y
