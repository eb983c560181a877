"""Post-processing entry point: accumulation buffer -> uint8 RGBA image.

Counterpart of ``buas_pathtracer_tpu/runtime/post.py`` (``post_process``):
exposure, tonemap, sRGB, sigmoidal contrast, TPDF dither from a 64x64
blue-noise tile, NaN shown cyan and negative weight shown magenta
(reference raytracer.cpp:2103-2173).  On the card the work is one launch of
the ``post_rgba8`` kernel (ops/post_kernel.py); on the CPU its plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.device import check_on, resolve_device
from ..models.scene import PostProcessSettings
from ..ops.post_kernel import post_rgba8
from ..utils import trace


@functools.lru_cache(maxsize=1)
def _dither_tile_np(size: int = 64) -> np.ndarray:
    """(size, size, 3) blue-noise dither values in [0, 1) (host; built once
    per process, ~2 s of void-and-cluster: the set-up phase
    ``dither_tile``)."""
    from ..utils.bluenoise import blue_noise_texture
    with trace.phase("dither_tile"):
        return np.ascontiguousarray(blue_noise_texture(size, channels=3),
                                    np.float32)


def dither_tile(device) -> torch.Tensor:
    """The 64x64x3 dither tile as a float32 tensor on ``device``."""
    return trace.wait("dither_tile", torch.from_numpy(_dither_tile_np(64)).to,
                      device)


def post_process(accum: torch.Tensor, settings: PostProcessSettings,
                 device=None) -> torch.Tensor:
    """(H, W, 4) accumulation -> (H, W, 4) uint8 RGBA.  ``device`` (None:
    the CUDA card) must hold ``accum``."""
    dev = resolve_device(device)
    check_on(dev, accum, "accum")
    tile = dither_tile(accum.device)
    with trace.span("pt.post"):
        return post_rgba8(accum.contiguous(), tile, settings)
