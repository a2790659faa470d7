"""Inputs of the benchmark, made on the device from the seed.

Every array comes from a ``torch.Generator`` on the run's device, seeded
from ``--seed`` and a stream number, in a few large calls. The sizes never
depend on the seed: a seed changes the values, never the work. The same
arrays go to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

_MASK63 = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of one seed's inputs."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7_919 * int(stream)) & _MASK63)
    return g


def _grid(shape, device):
    """Coordinates in [-1, 1) along each axis, shaped to broadcast."""
    d = len(shape)
    out = []
    for a, n in enumerate(shape):
        view = [1] * d
        view[a] = n
        out.append((torch.arange(n, device=device, dtype=torch.float32) * (2.0 / n) - 1.0)
                   .view(view))
    return out


def phantom(shape, ellipsoids: int, g: torch.Generator, device) -> torch.Tensor:
    """A smooth complex phantom: a large body ellipsoid and ``ellipsoids - 1``
    smaller ones inside it, axis-aligned with soft edges, intensities in
    [0.2, 1], magnitude scaled to a maximum of 1, under a smooth phase of
    random linear and quadratic terms. complex64, ``shape``."""
    d = len(shape)
    grid = _grid(shape, device)
    p = torch.rand((ellipsoids, 2 * d + 1), generator=g, device=device).tolist()
    mag = torch.zeros(shape, device=device, dtype=torch.float32)
    for e, row in enumerate(p):
        if e == 0:  # the body
            centre, radius, level = [0.0] * d, [0.8 + 0.1 * r for r in row[d:2 * d]], 0.6
        else:
            centre = [0.8 * (c - 0.5) for c in row[:d]]
            radius = [0.08 + 0.3 * r for r in row[d:2 * d]]
            level = 0.2 + 0.8 * row[2 * d]
        r2 = sum(((x - c) / r) ** 2 for x, c, r in zip(grid, centre, radius))
        mag += level * torch.sigmoid((1.0 - r2) * 12.0)
    mag /= mag.max()
    coef = ((torch.rand((2, d), generator=g, device=device) - 0.5) * math.pi).tolist()
    phase = sum(a * x + b * x * x for x, a, b in zip(grid, coef[0], coef[1]))
    return torch.polar(mag, phase.expand(shape).contiguous())


def complex_noise(shape, sigma: float, g: torch.Generator, device) -> torch.Tensor:
    """Circular complex Gaussian noise, ``sigma`` per component."""
    return torch.complex(torch.randn(shape, generator=g, device=device),
                         torch.randn(shape, generator=g, device=device)) * sigma


def density_mask(shape, axes, accel: float, centre, power: float,
                 g: torch.Generator, device) -> torch.Tensor:
    """A variable-density random 0/1 sampling mask of ``shape`` (float32):
    drawn over the phase-encode ``axes``, every other axis fully sampled.
    A fully sampled ``centre`` block (unshifted FFT order: low frequencies
    at index 0), and elsewhere sampling probability ``c * (1 - r)^power``
    at normalised radius ``r``, with ``c`` set so that ``1/accel`` of the
    phase encodes are sampled on average."""
    sub = [shape[a] for a in axes]
    k = [torch.fft.fftfreq(n, d=1.0 / n, device=device) for n in sub]  # signed indices
    ky, kz = k[0].view(-1, 1), k[1].view(1, -1)
    r = torch.sqrt(((2 * ky / sub[0]) ** 2 + (2 * kz / sub[1]) ** 2) / 2.0)
    inner = ((ky >= -centre[0] / 2) & (ky < centre[0] / 2)
             & (kz >= -centre[1] / 2) & (kz < centre[1] / 2))
    pdf = (1.0 - r) ** power
    lo, hi = 0.0, 1.0 / float(pdf.mean())
    while float(torch.where(inner, 1.0, torch.clamp(hi * pdf, max=1.0)).mean()) < 1.0 / accel:
        hi *= 2.0
    for _ in range(50):  # bisect the scale to the wanted rate
        mid = 0.5 * (lo + hi)
        rate = float(torch.where(inner, 1.0, torch.clamp(mid * pdf, max=1.0)).mean())
        lo, hi = (mid, hi) if rate < 1.0 / accel else (lo, mid)
    prob = torch.where(inner, 1.0, torch.clamp(hi * pdf, max=1.0))
    sample = (torch.rand(prob.shape, generator=g, device=device) < prob).to(torch.float32)
    view = [1] * len(shape)
    for a, n in zip(axes, sub):
        view[a] = n
    return sample.view(view).expand(shape).contiguous()


def cs_problem(shape, traffic: dict, seed: int, index: int, device):
    """One CS-MRI problem: the k-space ``b = M (F x + noise)`` of a phantom
    ``x`` (complex64) and its mask ``M`` (float32), scaled so that
    ``max |F^H b| = 1``."""
    g = generator(seed, 100 + index, device)
    x = phantom(shape, traffic["ellipsoids"], g, device)
    dims = tuple(range(len(shape)))
    k = torch.fft.fftn(x, dim=dims, norm="ortho")
    del x
    k += complex_noise(shape, traffic["noise_sigma"], g, device)
    mask = density_mask(shape, traffic["mask_axes"], traffic["accel"],
                        traffic["centre"], traffic["density_power"], g, device)
    b = mask * k
    del k
    b /= torch.fft.ifftn(b, dim=dims, norm="ortho").abs().max()
    return b, mask


def coil_maps(shape, coils: int, g: torch.Generator, device) -> torch.Tensor:
    """Smooth coil sensitivities ``(coils, *shape)`` (complex64, 2D): a
    Gaussian profile per coil, centred on a ring around the field of view,
    under a random linear phase."""
    y, x = _grid(shape, device)
    p = torch.rand((coils, 3), generator=g, device=device).tolist()
    maps = []
    for c, (jitter, py, px) in enumerate(p):
        ang = 2.0 * math.pi * (c + 0.5 * jitter) / coils
        cy, cx = 1.1 * math.sin(ang), 1.1 * math.cos(ang)
        prof = torch.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * 0.7**2))
        phase = math.pi * ((py - 0.5) * y + (px - 0.5) * x)
        maps.append(torch.polar(prof.expand(shape), phase.expand(shape)))
    return torch.stack(maps)


def coil_ring(shape, coils: int, traffic: dict, seed: int, device):
    """The ring of multi-coil slices ``(ring, coils, *shape)`` (complex64):
    ``ring`` slices of one phantom volume, each seen through the same coil
    maps, with complex noise of ``noise_sigma`` times the largest coil
    magnitude; returns the ring and that noise sigma."""
    g = generator(seed, 200, device)
    ring = traffic["ring"]
    vol = phantom((ring,) + tuple(shape), traffic["ellipsoids"], g, device)
    maps = coil_maps(shape, coils, g, device)
    data = maps.unsqueeze(0) * vol.unsqueeze(1)
    del vol
    sigma = traffic["noise_sigma"] * float(data.abs().max())
    data += complex_noise(data.shape, sigma, g, device)
    return data, sigma


def magnitude_volume(shape, traffic: dict, seed: int, index: int, device):
    """A real noisy magnitude volume (float32): ``|phantom|`` plus Gaussian
    noise of ``noise_sigma``; returns it and that sigma."""
    g = generator(seed, 300 + index, device)
    x = phantom(shape, traffic["ellipsoids"], g, device).abs()
    sigma = traffic["noise_sigma"]
    x += torch.randn(shape, generator=g, device=device) * sigma
    return x, sigma
