"""FFT (fast-convolution) path for the non-decimated DWT, in ``torch.fft``.

Port of ``non_decimated_wavelets_tpu/ops/fft_path.py``: the reference's
design (``Functions/nd_dwt_3D.m:334-341,359-366``) of filters cached in the
frequency domain, so that every transform is FFT -> pointwise multiply ->
inverse FFT, with separable per-axis ``(2, N_k)`` responses, the running
approximation carried in the frequency domain between levels, and the
band-first ``(B, *spatial)`` layout.

It runs when a plan asks for ``path='fft'``, on any device: on a CUDA tensor
``torch.fft`` calls cuFFT, in complex64 or complex128. The JAX package runs
this path in XLA with no Pallas kernel, so it has no kernel of its own here.

``resp`` is one ``(2, N_k)`` complex tensor per axis, on the data's device,
with any tight-frame scale already folded in (``plan.NDDWT.resp``).
"""

from __future__ import annotations

import torch


def _axes(ndim: int) -> tuple:
    """FFT axes: the trailing ``ndim`` axes of a band-leading array."""
    return tuple(range(-ndim, 0))


def _axis_view(f: torch.Tensor, ndim_out: int, ndim: int, ax: int) -> torch.Tensor:
    shape = [1] * ndim_out
    shape[ndim_out - ndim + ax] = f.shape[0]
    return f.reshape(shape)


def _apply_band(Xf: torch.Tensor, resp, band: int, conj: bool) -> torch.Tensor:
    """Multiply a spectrum by one band's separable response (bit 0 = axis 0)."""
    ndim = len(resp)
    out = Xf
    for ax, F in enumerate(resp):
        f = F[(band >> ax) & 1]
        out = out * _axis_view(f.conj() if conj else f, out.ndim, ndim, ax)
    return out


def _level1_dec_freq_ordered(Xf: torch.Tensor, resp) -> torch.Tensor:
    """``(2^d, *spatial)`` frequency-domain bands from a ``(*spatial)``
    spectrum; band bit ``k`` selects the high pass on axis ``k``, so axis
    0's bit toggles fastest (``Functions/nd_dwt_3D.m:334-341``)."""
    ndim = len(resp)
    T = Xf.unsqueeze(0)
    for ax, F in enumerate(resp):
        lo = T * _axis_view(F[0], T.ndim, ndim, ax)
        hi = T * _axis_view(F[1], T.ndim, ndim, ax)
        T = torch.cat([lo, hi], dim=0)
    return T


def dec_fft(x: torch.Tensor, resp, level: int, real_out: bool) -> torch.Tensor:
    """Multilevel analysis: ``(B, *spatial)``, the deepest approximation
    first, then the detail groups deepest first."""
    axes = _axes(x.ndim)
    Xf = torch.fft.fftn(x.to(resp[0].dtype), dim=axes)
    groups = []
    approx_f = Xf
    for _ in range(level):
        bands_f = _level1_dec_freq_ordered(approx_f, resp)
        approx_f = bands_f[0]
        groups.append(bands_f[1:])
    parts = [torch.fft.ifftn(approx_f, dim=axes).unsqueeze(0)]
    parts += [torch.fft.ifftn(g, dim=axes) for g in reversed(groups)]
    y = torch.cat(parts, dim=0)
    return y.real if real_out else y


def rec_fft(y: torch.Tensor, resp, level: int, preserve_l2: bool,
            real_out: bool) -> torch.Tensor:
    """Multilevel synthesis from ``(B, *spatial)`` bands: conjugate
    responses (the adjoint, ``Functions/nd_dwt_3D.m:374``) and a ``/2^d``
    per level unless ``preserve_l2`` (``Functions/nd_dwt_3D.m:233-235``)."""
    ndim = y.ndim - 1
    nb = 2**ndim
    axes = _axes(ndim)
    Yf = torch.fft.fftn(y.to(resp[0].dtype), dim=axes)

    def synth(group_f):
        acc = None
        for b in range(nb):
            term = _apply_band(group_f[b], resp, b, conj=True)
            acc = term if acc is None else acc + term
        return acc if preserve_l2 else acc / nb

    acc_f = synth(Yf[:nb])
    pos = nb
    for _ in range(1, level):
        acc_f = synth(torch.cat([acc_f.unsqueeze(0), Yf[pos : pos + nb - 1]], dim=0))
        pos += nb - 1
    x = torch.fft.ifftn(acc_f, dim=axes)
    return x.real if real_out else x
