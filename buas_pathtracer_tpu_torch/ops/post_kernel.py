"""Post-processing: the ``post_rgba8`` kernel wrapper and its plain version.

Counterpart of ``buas_pathtracer_tpu/ops/pallas_post.py``
(``post_process_pallas`` / ``_post_kernel``).  ``post_rgba8`` launches
``csrc/post.cu`` for CUDA tensors and runs ``post_rgba8_plain`` for CPU
tensors.  The plain version is the JAX package's ``_post_process_jnp``
(runtime/post.py :73) in PyTorch; reference raytracer.cpp:2103-2173,
``sigmoidal_contrast`` :69-84, ``remap_tpdf`` :125-132.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from . import cuda_lib


def _check(accum, tile):
    if accum.dtype != torch.float32 or accum.dim() != 3 or accum.shape[2] != 4:
        raise ValueError(f"accum must be float32 (H, W, 4), got "
                         f"{accum.dtype} {tuple(accum.shape)}")
    if tile.dtype != torch.float32 or tuple(tile.shape) != (64, 64, 3):
        raise ValueError(f"tile must be float32 (64, 64, 3), got "
                         f"{tile.dtype} {tuple(tile.shape)}")
    for name, x in (("accum", accum), ("tile", tile)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tile.device != accum.device:
        raise ValueError(f"tile on {tile.device}, accum on {accum.device}")


def post_rgba8(accum, tile, settings) -> torch.Tensor:
    """(H, W, 4) float32 accumulation -> (H, W, 4) uint8 RGBA.

    ``tile``: the (64, 64, 3) float32 dither tile; ``settings``: a
    PostProcessSettings."""
    _check(accum, tile)
    if accum.device.type == "cpu":
        return post_rgba8_plain(accum, tile, settings)
    if accum.device.type != "cuda":
        raise ValueError(f"no post_rgba8 for device {accum.device}")
    if accum.data_ptr() % 16:
        raise ValueError("accum must be 16-byte aligned (float4 pixels)")
    lib = cuda_lib.load()
    h, w, _ = accum.shape
    out = torch.empty((h, w, 4), dtype=torch.uint8, device=accum.device)
    f32 = np.float32
    mid = float(settings.midpoint)
    with torch.cuda.device(accum.device):
        stream = torch.cuda.current_stream(accum.device).cuda_stream
        rc = lib.post_rgba8_launch(
            accum.data_ptr(), tile.data_ptr(), out.data_ptr(), h, w,
            float(f32(2.0 ** float(settings.exposure))), mid,
            float(settings.contrast),
            float(f32(max(mid, 1e-6))),
            float(f32(1.0) / f32(max(1.0 - mid, 1e-6))),
            float(f32(1.0 - mid)),
            int(settings.exposure != 0.0), int(bool(settings.tonemapping)),
            int(bool(settings.srgb_transform)),
            int(settings.contrast != 0.0), int(bool(settings.dither)),
            stream)
    cuda_lib.check(rc, "post_rgba8")
    trace.launch("post_rgba8")
    return out


def sigmoidal_contrast(x, contrast, midpoint):
    scale_lo = x / np.float32(max(midpoint, 1e-6))
    lo = midpoint * scale_lo * scale_lo
    y = np.float32(1.0) / np.float32(max(1.0 - midpoint, 1e-6))
    scale_hi = y - y * x
    hi = 1.0 - (1.0 - midpoint) * scale_hi * scale_hi
    curve = torch.where(x < midpoint, lo, hi)
    return x + (curve - x) * contrast


def remap_tpdf(x):
    """Uniform [0,1] -> triangular-PDF [-1,1] (raytracer.cpp:125-132)."""
    orig = 2.0 * x - 1.0
    v = orig * torch.rsqrt(torch.clamp(torch.abs(orig), min=1e-30))
    v = torch.clamp(v, min=-1.0)
    return v - torch.sign(v)


def post_rgba8_plain(accum, tile, settings) -> torch.Tensor:
    h, w, _ = accum.shape
    wgt = accum[..., 3]
    rgb = accum[..., :3]
    is_nan = torch.isnan(accum).any(dim=-1)
    has_weight = wgt > 0.001
    neg_weight = wgt < -0.01

    color = torch.clamp(rgb / torch.where(has_weight, wgt, 1.0)[..., None],
                        min=0.0)
    if settings.exposure != 0.0:
        color = color * (2.0 ** settings.exposure)
    if settings.tonemapping:
        color = 1.0 - torch.exp(-color)
    if settings.srgb_transform:
        color = torch.pow(torch.clamp(color, min=0.0), 1.0 / 2.23333)
    if settings.contrast != 0.0:
        color = sigmoidal_contrast(color, settings.contrast, settings.midpoint)
    color = color * 255.0
    if settings.dither:
        ty = torch.arange(h, device=accum.device) % 64
        tx = torch.arange(w, device=accum.device) % 64
        color = color + 0.5 + remap_tpdf(tile[ty[:, None], tx[None, :]])

    color = torch.where(has_weight[..., None], color, 0.0)
    # NaN -> cyan (0, 255, 255); negative weight -> magenta scaled by |w|
    cyan = torch.tensor([0.0, 255.0, 255.0], device=accum.device)
    color = torch.where(is_nan[..., None], cyan, color)
    mag = -255.0 * wgt
    color = torch.where((neg_weight & ~is_nan)[..., None],
                        torch.stack([mag, torch.zeros_like(mag), mag], -1),
                        color)
    rgb8 = torch.clamp(color, 0.0, 255.0).to(torch.uint8)
    a = torch.full((h, w, 1), 255, dtype=torch.uint8, device=accum.device)
    return torch.cat([rgb8, a], dim=-1)
