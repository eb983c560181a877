"""Camera model and batched primary-ray generation.

Counterpart of ``buas_pathtracer_tpu/models/camera.py`` (reference
raytracer.cpp:26-67 camera, :409-474 per-sample ray setup): AA jitter,
polygonal-diaphragm bokeh, Brown-Conrady lens distortion, thin lens with the
film scaled by focus distance, and the cos^4 vignette.

Camera fields are Python floats on the host.  ``camera_on`` turns them into
float32 0-d tensors, which is what ``render_frame`` passes in, so the scalar
camera arithmetic rounds in float32 as in the JAX frame program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.vec import PI, Vec3, dot, lerp, normalize, v3
from ..utils import trace


class Camera(NamedTuple):
    p: Vec3  # position
    x: Vec3  # right
    y: Vec3  # up
    z: Vec3  # backward (reference convention: aim dir is -z)
    vfov: float
    aspect_ratio: float
    lens_radius: float
    focus_distance: float
    film_distance: float
    half_film_w: float
    half_film_h: float


def _noz_np(d):
    n = np.linalg.norm(d)
    return d / n if n > 1e-20 else d * 0.0


def make_camera(p=(0.0, 0.0, 0.0), vfov=math.radians(60.0), aspect=16 / 9,
                lens_radius=0.0, focus_distance=1.0) -> Camera:
    c = Camera(
        v3(*[float(q) for q in p]),
        v3(1.0, 0.0, 0.0), v3(0.0, 1.0, 0.0), v3(0.0, 0.0, 1.0),
        float(vfov), float(aspect), float(lens_radius), float(focus_distance),
        1.0, 0.5 * aspect, 0.5,
    )
    return recompute(c)


def aim_camera(cam: Camera, camera_d) -> Camera:
    """raytracer.cpp:26-39: ``camera_d`` is the BACKWARD axis."""
    z = _noz_np(np.asarray(camera_d, np.float64))
    x = _noz_np(np.cross([0.0, 1.0, 0.0], z))
    y = _noz_np(np.cross(z, x))
    cam = cam._replace(x=v3(*x.astype(float)), y=v3(*y.astype(float)),
                       z=v3(*z.astype(float)))
    return recompute(cam)


def aim_camera_at(cam: Camera, at) -> Camera:
    """raytracer.cpp:41-47: aim at a point; focus distance = its distance."""
    p = np.array([float(cam.p.x), float(cam.p.y), float(cam.p.z)])
    cv = np.asarray(at, np.float64) - p
    cam = aim_camera(cam, -_noz_np(cv))
    return cam._replace(focus_distance=float(np.linalg.norm(cv)))


def recompute(cam: Camera) -> Camera:
    """raytracer.cpp:49-58."""
    film_w = float(cam.aspect_ratio)
    film_h = 1.0
    return cam._replace(
        half_film_w=0.5 * film_w,
        half_film_h=0.5 * film_h,
        film_distance=film_h / math.tan(float(cam.vfov)),
    )


def camera_on(cam: Camera, device) -> Camera:
    """Every scalar field as its own float32 0-d tensor on ``device``
    (each copy a wait of the site ``camera``)."""
    def s(v):
        return trace.wait("camera", torch.tensor, float(v),
                          dtype=torch.float32, device=device)

    def sv(v):
        return Vec3(s(v.x), s(v.y), s(v.z))
    return Camera(sv(cam.p), sv(cam.x), sv(cam.y), sv(cam.z),
                  *[s(f) for f in cam[4:]])


# ---------------------------------------------------------------------------
# Lens effects
# ---------------------------------------------------------------------------

def transform_bokeh_sample(u, v, f_factor, n_edges, phi_shutter_max):
    """Polygonal-diaphragm map (raytracer.cpp:86-94, shadertoy MtlGRn)."""
    ax = u * 2.0 - 1.0
    ay = v * 2.0 - 1.0
    use_x = ax * ax > ay * ay
    nz_x = torch.abs(ax) > 1e-8
    nz_y = torch.abs(ay) > 1e-8
    safe_ax = torch.where(nz_x, ax, 1.0)
    safe_ay = torch.where(nz_y, ay, 1.0)
    phi_x = torch.where(nz_x, (PI * 0.25) * (ay / safe_ax), 0.0)
    phi_y = torch.where(nz_y, (PI * 0.5) - (PI * 0.25) * (ax / safe_ay), 0.0)
    phi = torch.where(use_x, phi_x, phi_y)
    r = torch.where(use_x, ax, ay)

    phi = phi + f_factor * phi_shutter_max
    if f_factor > 0.0:
        poly = math.cos(PI / n_edges) / torch.cos(
            phi - (2.0 * (PI / n_edges))
            * torch.floor(((n_edges * phi) + PI) / (2.0 * PI)))
        r = r * torch.pow(torch.clamp(poly, min=0.0), f_factor)
    return torch.cos(phi) * r, torch.sin(phi) * r


def _brown_conrady(u, v, amount, w_over_h):
    v = v / w_over_h
    b1 = 0.1 * amount
    b2 = -0.025 * amount
    r2 = u * u + v * v
    s = 1.0 + r2 * b1 + r2 * r2 * b2
    return u * s, v * s * w_over_h


def apply_lens_distortion(u, v, amount, w, h):
    """raytracer.cpp:110-123 (incl. the rescale-when-positive quirk)."""
    woh = w / h
    zero = torch.zeros((), dtype=torch.float32, device=u.device)
    minu, minv = _brown_conrady(zero, zero, amount, woh)
    maxu, maxv = _brown_conrady(zero + 1.0, zero + 1.0, amount, woh)
    du, dv = _brown_conrady(u, v, amount, woh)
    if amount > 0.0:
        return (du - minu) / (minu + maxu), (dv - minv) / (minv + maxv)
    return du, dv


# ---------------------------------------------------------------------------
# Primary ray generation (batched over pixels)
# ---------------------------------------------------------------------------


class PrimaryRays(NamedTuple):
    o: Vec3
    d: Vec3
    vignette: torch.Tensor


def generate_rays(cam: Camera, px, py, w: int, h: int,
                  aa_u, aa_v, dof_u, dof_v,
                  lens_distortion, f_factor, diaphragm_edges, phi_shutter_max,
                  vignette_strength) -> PrimaryRays:
    """Reference render_tile ray setup (raytracer.cpp:409-474), batched.

    px/py: integer pixel coordinates (tensors); aa_*/dof_*: [0,1) samples."""
    pixel_w = 1.0 / w
    pixel_h = 1.0 / h
    u_ = 1.0 - 2.0 * px.to(torch.float32) * pixel_w
    v_ = 1.0 - 2.0 * py.to(torch.float32) * pixel_h
    u, v = apply_lens_distortion(u_, v_, lens_distortion, float(w), float(h))

    jitter_x = aa_u - 0.5
    jitter_y = aa_v - 0.5

    bx, by = transform_bokeh_sample(dof_u, dof_v, f_factor, diaphragm_edges,
                                    PI * phi_shutter_max)

    half_film_w = cam.half_film_w * cam.focus_distance
    half_film_h = cam.half_film_h * cam.focus_distance
    film_distance = cam.focus_distance * cam.film_distance
    film_center = cam.p - cam.z * film_distance

    dof_jitter_x = half_film_w * pixel_w * cam.lens_radius * bx
    dof_jitter_y = half_film_h * pixel_h * cam.lens_radius * by

    film_p = film_center \
        + cam.x * ((u + pixel_w * jitter_x) * half_film_w) \
        + cam.y * ((v + pixel_h * jitter_y) * half_film_h)

    ray_o = cam.p + cam.x * dof_jitter_x + cam.y * dof_jitter_y
    ray_d = normalize(film_p - ray_o)

    cosz = dot(ray_d, cam.z)
    vig = cosz * cosz * cosz * cosz
    vig = lerp(1.0, vig, vignette_strength)
    return PrimaryRays(ray_o, ray_d, vig)
