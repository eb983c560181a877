"""Blue-noise texture generation (void-and-cluster, Ulichney 1993).

The post pass dithers with a tileable 64 x 64 blue-noise tile made by the
classic void-and-cluster method from fixed seeds (the upstream renderer
ships pre-made tiles, assets.cpp:63-113).  Numpy only.
"""

from __future__ import annotations

import numpy as np


def _energy_kernel(n: int, sigma: float = 1.5) -> np.ndarray:
    """Toroidal Gaussian energy kernel, FFT-ready."""
    ax = np.arange(n)
    d = np.minimum(ax, n - ax).astype(np.float64)
    d2 = d[:, None] ** 2 + d[None, :] ** 2
    return np.exp(-d2 / (2.0 * sigma * sigma))


def _filtered(mask: np.ndarray, kf: np.ndarray) -> np.ndarray:
    return np.real(np.fft.ifft2(np.fft.fft2(mask) * kf))


def void_and_cluster(n: int = 64, seed: int = 0x0D17) -> np.ndarray:
    """Returns an (n, n) array of ranks in [0, n*n) — a tileable blue-noise
    threshold matrix."""
    rng = np.random.RandomState(seed)
    kf = np.fft.fft2(np.fft.ifftshift(np.fft.fftshift(_energy_kernel(n))))

    total = n * n
    n_init = max(1, total // 10)
    mask = np.zeros((n, n), bool)
    idx = rng.choice(total, n_init, replace=False)
    mask.flat[idx] = True

    # de-cluster the prototype pattern until stable
    for _ in range(total):
        e = _filtered(mask.astype(np.float64), kf)
        cluster = np.argmax(np.where(mask, e, -np.inf))
        mask.flat[cluster] = False
        e = _filtered(mask.astype(np.float64), kf)
        void = np.argmin(np.where(mask, np.inf, e))
        if void == cluster:
            mask.flat[cluster] = True
            break
        mask.flat[void] = True

    ranks = np.zeros((n, n), np.int64)

    # phase 1: remove tightest clusters -> ranks n_init-1 .. 0
    work = mask.copy()
    for rank in range(n_init - 1, -1, -1):
        e = _filtered(work.astype(np.float64), kf)
        cluster = np.argmax(np.where(work, e, -np.inf))
        work.flat[cluster] = False
        ranks.flat[cluster] = rank

    # phase 2: fill largest voids -> ranks n_init .. total-1
    work = mask.copy()
    for rank in range(n_init, total):
        e = _filtered(work.astype(np.float64), kf)
        void = np.argmin(np.where(work, np.inf, e))
        work.flat[void] = True
        ranks.flat[void] = rank

    return ranks


def blue_noise_texture(n: int = 64, channels: int = 3,
                       seed: int = 0x0D17) -> np.ndarray:
    """(n, n, channels) float32 in [0, 1): independent blue-noise per channel."""
    chans = [void_and_cluster(n, seed + 7919 * c).astype(np.float32) / (n * n)
             for c in range(channels)]
    return np.stack(chans, axis=-1)
