"""The reference's picture of a few tiles of a progressive render.

``render_tiles`` renders the square tiles at the given frame origins as
``passes`` one-sample passes starting at sample index ``first_index`` would
leave them: every sample that the tiles' filter footprint reaches (the
tile and ``radius`` pixels around it, inside the frame) is traced by the
Advanced Pathtracer over the scene's primitives, splatted with the scene's
filter, the passes summed in order from a zero buffer, and the sum turned
into RGBA8 by the post pass.  It imports nothing of the program and reads
only the configuration's ``SceneData``.  Both functions here take it or
the ``RefScene`` built from it (``scene.build``), so that a check builds
the scene once.
"""

from __future__ import annotations

import numpy as np
import torch

from . import film, integrator, post, sampler as smp
from . import scene as ref_scene
from .camera import camera_tensors, primary_rays
from .scene import RefScene
from .tracer import BIG_T, Tracer

RAYS_PER_BLOCK = 1 << 16


def _built(scene, device) -> RefScene:
    return scene if isinstance(scene, RefScene) else ref_scene.build(
        scene, device)


def _tile_pixels(origins, size: int, device):
    """(rows, columns) of the tiles' pixels, (tiles, size, size) each."""
    n_t = len(origins)
    oy = torch.tensor([o[0] for o in origins], device=device)
    ox = torch.tensor([o[1] for o in origins], device=device)
    ar = torch.arange(size, device=device)
    return ((oy[:, None, None] + ar[None, :, None]).expand(n_t, size, size),
            (ox[:, None, None] + ar[None, None, :]).expand(n_t, size, size))


def geometry_share(scene, w: int, h: int, origins, size: int,
                   device) -> np.ndarray:
    """(tiles,) float: the share of each tile's pixels whose primary ray,
    with no AA jitter and through the lens's centre, hits the scene (a
    primitive, a mesh or a plane) rather than the sky."""
    rs = _built(scene, device)
    cam = camera_tensors(rs.camera, device)
    ty, tx = _tile_pixels(origins, size, device)
    mid = torch.full((ty.numel(),), 0.5, dtype=torch.float32, device=device)
    o, d, _ = primary_rays(cam, rs.settings, tx.reshape(-1), ty.reshape(-1),
                           w, h, mid, mid, mid, mid)
    hit = Tracer(rs).closest(o, d, torch.full_like(mid, BIG_T))
    return hit.valid.reshape(len(origins), -1).to(torch.float32).mean(
        1).cpu().numpy()


def render_tiles(scene, w: int, h: int, origins, size: int,
                 first_index: int, passes: int, device,
                 dtype=torch.float32) -> np.ndarray:
    """(tiles, size, size, 4) uint8 of the tiles with top-left pixels
    ``origins`` [(y0, x0), ...] after ``passes`` passes; ``dtype`` is the
    ray-primitive arithmetic's precision (``tracer``)."""
    rs = _built(scene, device)
    tracer = Tracer(rs, dtype)
    f, r = film.find_filter(rs.filter_name)
    cam = camera_tensors(rs.camera, device)
    side = size + 2 * r
    n_t = len(origins)
    # the footprint of every tile: frame coordinates and whether in frame
    oy = torch.tensor([o[0] for o in origins], device=device)
    ox = torch.tensor([o[1] for o in origins], device=device)
    g = torch.arange(side, device=device) - r
    fy = (oy[:, None, None] + g[None, :, None]).expand(n_t, side, side)
    fx = (ox[:, None, None] + g[None, None, :]).expand(n_t, side, side)
    inside = (fy >= 0) & (fy < h) & (fx >= 0) & (fx < w)
    sel = torch.nonzero(inside.reshape(-1)).squeeze(1)
    py = fy.reshape(-1)[sel]
    px = fx.reshape(-1)[sel]
    per_pass = sel.numel()

    samples = torch.zeros((passes, n_t * side * side, 4), dtype=torch.float32,
                          device=device)
    jx = torch.zeros((passes, n_t * side * side), dtype=torch.float32,
                     device=device)
    jy = torch.zeros_like(jx)
    pass_block = max(1, RAYS_PER_BLOCK // max(per_pass, 1))
    for k0 in range(0, passes, pass_block):
        k1 = min(passes, k0 + pass_block)
        ks = torch.arange(k0, k1, device=device)
        si = ((first_index + ks[:, None]) & 0xFFFFFFFF).expand(-1, per_pass)
        bpx = px[None, :].expand(k1 - k0, -1).reshape(-1)
        bpy = py[None, :].expand(k1 - k0, -1).reshape(-1)
        s = smp.make_sampler(bpx, bpy, si.reshape(-1))
        s, aa_u, aa_v = smp.sample_2d(s, smp.AA, 0)
        s, dof_u, dof_v = smp.sample_2d(s, smp.DOF, 0)
        o, d, vig = primary_rays(cam, rs.settings, bpx, bpy, w, h, aa_u,
                                 aa_v, dof_u, dof_v)
        color = integrator.trace(rs, tracer, s, o, d) * vig
        col = torch.stack([color.x, color.y, color.z,
                           torch.ones_like(color.x)], -1)
        samples[k0:k1, sel] = col.reshape(k1 - k0, per_pass, 4)
        jx[k0:k1, sel] = (aa_u - 0.5).reshape(k1 - k0, per_pass)
        jy[k0:k1, sel] = (aa_v - 0.5).reshape(k1 - k0, per_pass)

    contrib = film.splat(samples.reshape(passes, n_t, side, side, 4),
                         jx.reshape(passes, n_t, side, side),
                         jy.reshape(passes, n_t, side, side), f, r)
    acc = torch.zeros(contrib.shape[1:], dtype=torch.float32, device=device)
    for k in range(passes):
        acc = acc + contrib[k]
    ty, tx = _tile_pixels(origins, size, device)
    img = post.rgba8(acc, ty, tx, rs.post, post.dither_tile(device))
    return img.cpu().numpy()

