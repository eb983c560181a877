"""Reconstruction filters (reconstruction_filters.cpp:101-124) and the
splat: the sample at pixel q with AA jitter j adds f(dx - j.x) * f(dy - j.y)
of its colour and weight to pixel q + (dx, dy); samples outside the frame
add nothing.  Each output pixel sums its neighbours row by row, column by
column."""

from __future__ import annotations

import math

import torch

from .vec import PI


def _sinc(x):
    px = PI * x
    return torch.sin(px) / px


def _lanczos(radius: float):
    def f(x):
        ax = torch.abs(x)
        safe = torch.clamp(ax, min=1e-4)
        val = _sinc(safe) * _sinc(safe / radius)
        val = torch.where(ax < 1e-4, 1.0, val)
        return torch.where(ax <= radius, val, 0.0)
    return f


def _gaussian(alpha: float, radius: float):
    edge = math.exp(-alpha * radius * radius)

    def f(x):
        return torch.clamp(torch.exp(-alpha * x * x) - edge, min=0.0)
    return f


def _mitchell(x, B: float = 1.0 / 3.0, C: float = 1.0 / 3.0):
    x = torch.abs(x)
    outer = ((-B - 6 * C) * x ** 3 + (6 * B + 30 * C) * x ** 2 +
             (-12 * B - 48 * C) * x + (8 * B + 24 * C)) / 6.0
    inner = ((12 - 9 * B - 6 * C) * x ** 3 +
             (-18 + 12 * B + 6 * C) * x ** 2 + (6 - 2 * B)) / 6.0
    val = torch.where(x > 1.0, outer, inner)
    return torch.where(x > 2.0, 0.0, val)


FILTERS = {
    "Box": (None, 0),
    "Gaussian 3": (_gaussian(3.0, 3.0), 3),
    "Gaussian 12": (_gaussian(0.03, 12.0), 12),
    "Mitchell Netravali": (_mitchell, 2),
    "Lanczos 3": (_lanczos(3.0), 3),
    "Lanczos 4": (_lanczos(4.0), 4),
    "Lanczos 6": (_lanczos(6.0), 6),
    "Lanczos 12": (_lanczos(12.0), 12),
}


def find_filter(name: str):
    """(f, radius); Box for an unknown name."""
    return FILTERS.get(name, FILTERS["Box"])


def splat(sample, jx, jy, f, r: int):
    """(..., H + 2r, W + 2r, 4) samples with their jitters, zero outside
    the frame -> (..., H, W, 4) contributions of the inner H x W pixels."""
    if f is None:
        return sample
    h = sample.shape[-3] - 2 * r
    w = sample.shape[-2] - 2 * r
    out = torch.zeros(sample.shape[:-3] + (h, w, 4), dtype=torch.float32,
                      device=sample.device)
    for dy in range(-r, r + 1):
        rows = slice(r + dy, r + dy + h)
        win = sample[..., rows, :, :]
        wjx = jx[..., rows, :]
        fy = f(-float(dy) - jy[..., rows, :])
        for dx in range(-r, r + 1):
            cols = slice(r + dx, r + dx + w)
            wgt = f(-dx - wjx[..., cols]) * fy[..., cols]
            out = out + win[..., cols, :] * wgt[..., None]
    return out
