"""Reconstruction filters: the reference registry (reconstruction_filters.cpp)
as closed-form tensor functions.

Counterpart of ``buas_pathtracer_tpu/ops/filters.py``; names and radii match
the reference table (reconstruction_filters.cpp:101-111).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..core.vec import PI


def _sinc(x):
    px = PI * x
    return torch.sin(px) / px


def lanczos(radius: float):
    def f(x):
        ax = torch.abs(x)
        safe = torch.clamp(ax, min=1e-4)
        val = _sinc(safe) * _sinc(safe / radius)
        val = torch.where(ax < 1e-4, 1.0, val)
        return torch.where(ax <= radius, val, 0.0)
    return f


def gaussian(alpha: float, radius: float):
    edge = math.exp(-alpha * radius * radius)

    def f(x):
        return torch.clamp(torch.exp(-alpha * x * x) - edge, min=0.0)
    return f


def mitchell_netravali(x, B: float = 1.0 / 3.0, C: float = 1.0 / 3.0):
    x = torch.abs(x)
    outer = ((-B - 6 * C) * x ** 3 + (6 * B + 30 * C) * x ** 2 +
             (-12 * B - 48 * C) * x + (8 * B + 24 * C)) / 6.0
    inner = ((12 - 9 * B - 6 * C) * x ** 3 +
             (-18 + 12 * B + 6 * C) * x ** 2 + (6 - 2 * B)) / 6.0
    val = torch.where(x > 1.0, outer, inner)
    return torch.where(x > 2.0, 0.0, val)


class FilterOption(NamedTuple):
    name: str
    f: Optional[Callable]  # None => box (direct accumulate)
    radius: int


FILTERS = [
    FilterOption("Box", None, 0),
    FilterOption("Gaussian 3", gaussian(3.0, 3.0), 3),
    FilterOption("Gaussian 12", gaussian(0.03, 12.0), 12),
    FilterOption("Mitchell Netravali", mitchell_netravali, 2),
    FilterOption("Lanczos 3", lanczos(3.0), 3),
    FilterOption("Lanczos 4", lanczos(4.0), 4),
    FilterOption("Lanczos 6", lanczos(6.0), 6),
    FilterOption("Lanczos 12", lanczos(12.0), 12),
]


def find_filter(name: str) -> FilterOption:
    """Box if not found (reconstruction_filters.cpp:113-124)."""
    for opt in FILTERS:
        if opt.name == name:
            return opt
    return FILTERS[0]
