"""Frame renderer: full-frame wavefront passes.

Counterpart of ``buas_pathtracer_tpu/runtime/render.py``.  One pass renders
one sample for every pixel as a single batched wavefront; ``samples_per_pixel``
passes make a frame, and frames accumulate progressively like the
reference's AccumulationBuffer (frame_count == accumulated spp, canonical
sample index raytracer.cpp:429-439).

Rays are ordered in pixel tiles (``_tiled``): a contiguous run of rays is a
compact screen tile, which keeps neighbouring GPU threads on neighbouring
pixels.  The output does not depend on the order; every per-ray draw keys
off the pixel coordinates carried with the ray.

The integrator registry is the JAX package's (integrators.cpp:823-845):
name-keyed, falling back to the Advanced Pathtracer for an unknown name.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..core import sampler as smp
from ..core.device import check_on, resolve_device
from ..core.vec import Vec3
from ..integrators import advanced as adv
from ..integrators import debug as dbg
from ..integrators import ground_truth as gt
from ..integrators import whitted as wht
from ..models.camera import Camera, camera_on, generate_rays
from ..models.scene import PackedScene, Scene, SceneSettings
from ..ops.filters import find_filter
from ..utils import trace
from . import film

INTEGRATORS: Dict[str, Callable] = {
    "Advanced Pathtracer": adv.advanced,
    "Whitted": wht.whitted,
    "Ground Truth Recursive": gt.ground_truth_iterative,  # one program on
    "Ground Truth Iterative": gt.ground_truth_iterative,  # the wavefront
    "Normals": dbg.normals,
    "Distances": dbg.distances,
}


def find_integrator(name: str) -> Callable:
    """integrators.cpp:834-845: the default integrator if not found."""
    return INTEGRATORS.get(name, adv.advanced)


# Candidate tile shapes, squarest first; 1080p lands on (8, 128)
_TILE_SHAPES = ((32, 32), (16, 64), (8, 128), (4, 256))


def _tile_shape(h, w):
    for th, tw in _TILE_SHAPES:
        if h % th == 0 and w % tw == 0:
            return th, tw
    return None


def _tiled(x2d):
    h, w = x2d.shape
    shape = _tile_shape(h, w)
    if shape is None:
        return x2d.reshape(-1)  # odd sizes: scanline order
    th, tw = shape
    return (x2d.reshape(h // th, th, w // tw, tw)
            .permute(0, 2, 1, 3).reshape(-1))


def _untiled(flat, h, w):
    shape = _tile_shape(h, w)
    if shape is None:
        return flat.reshape(h, w)
    th, tw = shape
    return (flat.reshape(h // th, w // tw, th, tw)
            .permute(0, 2, 1, 3).reshape(h, w))


def pixel_rows(row0: int, rows: int, w: int, dev):
    """Tiled pixel coordinates (px, py) of the frame rows [row0, row0 +
    rows), all ``w`` columns."""
    py_, px_ = torch.meshgrid(torch.arange(rows, device=dev),
                              torch.arange(w, device=dev), indexing="ij")
    return _tiled(px_), _tiled(py_) + row0


def sample_pass(ps: PackedScene, settings: SceneSettings, cam: Camera,
                px: torch.Tensor, py: torch.Tensor, sample_index: int, *,
                h: int, w: int, rows: int, n_lights: int, has_medium: bool):
    """One sample for every pixel of ``pixel_rows``' (px, py), ``rows`` rows
    of a frame h x w.  Returns the (rows, w) colour image (Vec3), the
    jitters jx, jy (rows, w) and stats (3,)."""
    integrator = find_integrator(settings.integrator)
    strategy = int(settings.sampling_strategy)
    with trace.span("pt.camera"):
        sampler = smp.make_sampler(px, py, sample_index, strategy=strategy)
        sampler, aa_u, aa_v = smp.sample_2d(sampler, strategy,
                                            smp.SampleDimension.AA, 0)
        sampler, dof_u, dof_v = smp.sample_2d(sampler, strategy,
                                              smp.SampleDimension.DOF, 0)
        rays = generate_rays(
            cam, px, py, w, h, aa_u, aa_v, dof_u, dof_v,
            settings.lens_distortion, settings.f_factor,
            settings.diaphragm_edges, settings.phi_shutter_max,
            settings.vignette_strength)
    if integrator is wht.whitted:
        color, _, stats = integrator(ps, settings, sampler, rays.o, rays.d,
                                     n_lights=n_lights,
                                     has_medium=has_medium)
    elif integrator is adv.advanced:
        color, _, stats = integrator(ps, settings, sampler, rays.o, rays.d,
                                     n_lights=n_lights)
    else:
        color, _, stats = integrator(ps, settings, sampler, rays.o, rays.d)
    with trace.span("pt.camera"):
        color = color * rays.vignette
        color_img = Vec3(_untiled(color.x, rows, w),
                         _untiled(color.y, rows, w),
                         _untiled(color.z, rows, w))
        jx = _untiled(aa_u - 0.5, rows, w)
        jy = _untiled(aa_v - 0.5, rows, w)
    return color_img, jx, jy, stats


def render_frame(ps: PackedScene, settings: SceneSettings, cam: Camera,
                 accum: torch.Tensor, frame_index: int, *, h: int, w: int,
                 n_lights: int, filter_name: str = "Mitchell Netravali",
                 has_medium: bool = True, device=None):
    """Accumulate ``settings.samples_per_pixel`` full-frame sample passes.

    frame_index: accumulated samples so far (host int).  Returns the new
    accumulation buffer and stats (3,) [rays, node visits, triangle tests].
    ``has_medium`` (``Scene.has_medium``) lets Whitted drop its queued
    lanes.  ``device`` (None: the CUDA card) must hold ``ps`` and
    ``accum``."""
    dev = resolve_device(device)
    check_on(dev, ps.wide_rows, "scene")
    check_on(dev, accum, "accum")
    dev = accum.device
    filt = find_filter(filter_name)
    with trace.span("pt.camera"):
        cam = camera_on(cam, dev)
        px, py = pixel_rows(0, h, w, dev)

    stats = torch.zeros(3, dtype=torch.float32, device=dev)
    for s_i in range(int(settings.samples_per_pixel)):
        with trace.span("pt.pass"):
            color_img, jx, jy, st_ = sample_pass(
                ps, settings, cam, px, py, int(frame_index) + s_i, h=h, w=w,
                rows=h, n_lights=n_lights, has_medium=has_medium)
            stats = stats + st_
            with trace.span("pt.film"):
                accum = film.accumulate(accum, film.splat_pass(
                    color_img, jx, jy, filt))
    return accum, stats


def render(scene: Scene, w: int, h: int, frames: int = 1,
           filter_name: str = "Mitchell Netravali", device=None):
    """Host loop: pack, render ``frames`` frames, resolve.

    Returns (hdr (H, W, 3) float32 numpy, accum (H, W, 4), stats (3,))."""
    dev = resolve_device(device)
    ps = scene.pack(device=dev)
    accum = film.new_accumulation_buffer(h, w, dev)
    spp = int(scene.settings.samples_per_pixel)
    stats = torch.zeros(3, dtype=torch.float32, device=dev)
    for f_i in range(frames):
        accum, st_ = render_frame(ps, scene.settings, scene.camera, accum,
                                  f_i * spp, h=h, w=w,
                                  n_lights=scene.n_lights,
                                  filter_name=filter_name,
                                  has_medium=scene.has_medium, device=dev)
        stats = stats + st_
    return film.resolve(accum).cpu().numpy(), accum, stats
