"""Sampler debug images, after the reference's UI panel
(raytracer.cpp:2199-2290): a 2-D scatter plot of one pixel's sample stream,
a 1-D projection histogram and a per-pixel first-sample noise image.

Counterpart of ``buas_pathtracer_tpu/app/sampler_debug.py`` (:16-79) over
the port's ``core/sampler.make_sampler`` with a tensor sample index; the
images are byte-equal to the JAX package's (``tests/test_torch_viewer.py``).
The samples are drawn on ``device`` (None: the CUDA card) and the images
drawn in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import sampler as smp
from ..core.device import resolve_device


def _collect_samples(strategy: int, dim: int, px: int, py: int,
                     n: int = 256, device=None) -> np.ndarray:
    """(n, 2) samples of one (pixel, dimension) stream across sample
    indices 0..n-1."""
    dev = resolve_device(device)
    xs = torch.full((n,), px, dtype=torch.int64, device=dev)
    ys = torch.full((n,), py, dtype=torch.int64, device=dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    s = smp.make_sampler(xs, ys, idx, strategy=strategy)
    s, u, v = smp.sample_2d(s, strategy, dim, 0)
    return np.stack([u.cpu().numpy(), v.cpu().numpy()], axis=1)


def scatter_plot(strategy: int, dim: int = smp.SampleDimension.AA,
                 px: int = 7, py: int = 11, n: int = 256,
                 size: int = 256, device=None) -> np.ndarray:
    """(size, size, 3) uint8 scatter of the first n samples (noise plot,
    raytracer.cpp:2199-2238)."""
    pts = _collect_samples(strategy, dim, px, py, n, device)
    img = np.full((size, size, 3), 24, np.uint8)
    # 8x8 stratum grid guides (the stratified layout, samplers.cpp:48-80)
    for g in range(0, size, size // 8):
        img[g, :] = 48
        img[:, g] = 48
    xi = np.clip((pts[:, 0] * size).astype(int), 0, size - 1)
    yi = np.clip((pts[:, 1] * size).astype(int), 0, size - 1)
    for x, y in zip(xi, yi):
        img[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2] = (90, 200, 255)
    return img


def projection_histogram(strategy: int, dim: int = smp.SampleDimension.AA,
                         px: int = 7, py: int = 11, n: int = 4096,
                         bins: int = 64, size: int = 256,
                         device=None) -> np.ndarray:
    """(size//2, size, 3) uint8 histogram of the 1-D projection
    (raytracer.cpp:2258-2290): flat means well distributed."""
    pts = _collect_samples(strategy, dim, px, py, n, device)
    counts, _ = np.histogram(pts[:, 0], bins=bins, range=(0.0, 1.0))
    h = size // 2
    img = np.full((h, size, 3), 24, np.uint8)
    peak = max(counts.max(), 1)
    bw = size // bins
    for b, c in enumerate(counts):
        bh = int(h * c / peak)
        img[h - bh:, b * bw:(b + 1) * bw] = (255, 180, 80)
    # expected-uniform line
    exp_h = h - int(h * (n / bins) / peak)
    img[max(exp_h - 1, 0):exp_h + 1, :] = (120, 255, 120)
    return img


def noise_image(strategy: int, dim: int = smp.SampleDimension.AA,
                size: int = 128, device=None) -> np.ndarray:
    """(size, size, 3) uint8 image of each pixel's first sample
    (raytracer.cpp:2240-2256): blue noise looks even, white noise
    clumpy."""
    dev = resolve_device(device)
    ys, xs = torch.meshgrid(torch.arange(size, device=dev),
                            torch.arange(size, device=dev), indexing="ij")
    s = smp.make_sampler(xs.reshape(-1), ys.reshape(-1),
                         torch.zeros(size * size, dtype=torch.int64,
                                     device=dev), strategy=strategy)
    s, u, v = smp.sample_2d(s, strategy, dim, 0)
    img = np.zeros((size, size, 3), np.uint8)
    img[..., 0] = (u.cpu().numpy().reshape(size, size) * 255).astype(np.uint8)
    img[..., 1] = (v.cpu().numpy().reshape(size, size) * 255).astype(np.uint8)
    return img
