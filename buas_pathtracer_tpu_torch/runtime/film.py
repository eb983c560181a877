"""Film: accumulation buffer and race-free reconstruction splat.

Counterpart of ``buas_pathtracer_tpu/runtime/film.py``.  The reference
splats each sample into its (2r+1)^2 neighbourhood (splat_filter,
raytracer.cpp:187-259); here every output pixel gathers the contributions
of its neighbours through shifted windows, so there is no scatter and no
race.  The sample at pixel q with AA jitter j contributes
f(dx - j.x) * f(dy - j.y) to pixel q + (dx, dy).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.vec import Vec3
from ..ops.filters import FilterOption


def new_accumulation_buffer(h: int, w: int, device) -> torch.Tensor:
    """(H, W, 4) zeros; .w accumulates filter weight (raytracer.cpp:501-522)."""
    return torch.zeros((h, w, 4), dtype=torch.float32, device=device)


def splat_pass(color: Vec3, jitter_x, jitter_y,
               filt: FilterOption) -> torch.Tensor:
    """One full-frame sample pass -> (H, W, 4) contribution image.

    color: Vec3 of (H, W) tensors (one sample per pixel, vignetted);
    jitter_x/_y: (H, W) AA jitter in [-0.5, 0.5] of those samples."""
    sample = torch.stack([color.x, color.y, color.z,
                          torch.ones_like(color.x)], dim=-1)  # (H, W, 4)
    if filt.f is None:  # Box: sample -> own pixel, weight 1
        return sample
    r = int(filt.radius)
    # zero pad: out-of-frame neighbours contribute 0
    return splat_pass_prepadded(F.pad(sample, (0, 0, 0, 0, r, r)),
                                F.pad(jitter_x, (0, 0, r, r)),
                                F.pad(jitter_y, (0, 0, r, r)), filt)


def splat_pass_prepadded(sample_ext, jx_ext, jy_ext,
                         filt: FilterOption) -> torch.Tensor:
    """The splat over a vertically pre-padded block.

    ``sample_ext`` is (H + 2r, W, 4): H owned rows and r context rows above
    and below, zeros at the frame edge or a neighbour rank's samples
    (``parallel/mesh.py`` exchanges them).  The arithmetic is
    ``splat_pass``'s, so equal context rows give a bit-equal block."""
    if filt.f is None:
        return sample_ext
    r = int(filt.radius)
    h = int(sample_ext.shape[0]) - 2 * r
    w = int(sample_ext.shape[1])
    sp = F.pad(sample_ext, (0, 0, r, r))
    jx = F.pad(jx_ext, (r, r))
    jy = F.pad(jy_ext, (r, r))
    out = torch.zeros((h, w, 4), dtype=torch.float32,
                      device=sample_ext.device)
    for dy in range(-r, r + 1):
        win = sp[r + dy:r + dy + h]
        wjx = jx[r + dy:r + dy + h]
        fy = filt.f(-float(dy) - jy[r + dy:r + dy + h])
        for dx in range(-r, r + 1):
            wgt = filt.f(-dx - wjx[:, r + dx:r + dx + w]) \
                * fy[:, r + dx:r + dx + w]
            out = out + win[:, r + dx:r + dx + w] * wgt[..., None]
    return out


def accumulate(accum: torch.Tensor, contribution: torch.Tensor) -> torch.Tensor:
    return accum + contribution


def resolve(accum: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) -> (H, W, 3) HDR colour: xyz / w; zero-weight pixels -> 0
    (raytracer.cpp:2126-2128)."""
    wgt = accum[..., 3:4]
    ok = torch.abs(wgt) > 1e-3
    return torch.where(ok, accum[..., :3] / torch.where(ok, wgt, 1.0), 0.0)
