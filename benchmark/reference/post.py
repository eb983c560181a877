"""Post-processing (raytracer.cpp:2103-2173): accumulation -> RGBA8.

Colour over weight, exposure, the exponential tonemap, the sRGB power
curve, sigmoidal contrast (:69-84), x255, TPDF dither from the 64 x 64
blue-noise tile (:125-132), NaN shown cyan and negative weight magenta.
Pixel by pixel, so it runs on any block of pixels given their frame
coordinates."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bluenoise import blue_noise_texture


@functools.lru_cache(maxsize=1)
def _tile() -> np.ndarray:
    return np.ascontiguousarray(blue_noise_texture(64, channels=3),
                                np.float32)


def dither_tile(device) -> torch.Tensor:
    return torch.from_numpy(_tile()).to(device)


def _contrast(x, contrast, midpoint):
    lo_s = x / np.float32(max(midpoint, 1e-6))
    lo = midpoint * lo_s * lo_s
    y = np.float32(1.0) / np.float32(max(1.0 - midpoint, 1e-6))
    hi_s = y - y * x
    hi = 1.0 - (1.0 - midpoint) * hi_s * hi_s
    return x + (torch.where(x < midpoint, lo, hi) - x) * contrast


def _tpdf(x):
    orig = 2.0 * x - 1.0
    v = orig * torch.rsqrt(torch.clamp(torch.abs(orig), min=1e-30))
    v = torch.clamp(v, min=-1.0)
    return v - torch.sign(v)


def rgba8(accum, py, px, post: dict, tile) -> torch.Tensor:
    """(..., 4) accumulation of pixels at frame rows ``py`` and columns
    ``px`` (broadcast to its leading shape) -> (..., 4) uint8."""
    wgt = accum[..., 3]
    is_nan = torch.isnan(accum).any(dim=-1)
    has_w = wgt > 0.001
    neg_w = wgt < -0.01
    c = torch.clamp(accum[..., :3] / torch.where(has_w, wgt, 1.0)[..., None],
                    min=0.0)
    if post["exposure"] != 0.0:
        c = c * (2.0 ** post["exposure"])
    if post["tonemapping"]:
        c = 1.0 - torch.exp(-c)
    if post["srgb_transform"]:
        c = torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.23333)
    if post["contrast"] != 0.0:
        c = _contrast(c, post["contrast"], post["midpoint"])
    c = c * 255.0
    if post["dither"]:
        c = c + 0.5 + _tpdf(tile[py % 64, px % 64])
    c = torch.where(has_w[..., None], c, 0.0)
    cyan = torch.tensor([0.0, 255.0, 255.0], device=accum.device)
    c = torch.where(is_nan[..., None], cyan, c)
    mag = -255.0 * wgt
    c = torch.where((neg_w & ~is_nan)[..., None],
                    torch.stack([mag, torch.zeros_like(mag), mag], -1), c)
    rgb = torch.clamp(c, 0.0, 255.0).to(torch.uint8)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=accum.device)
    return torch.cat([rgb, alpha], dim=-1)
