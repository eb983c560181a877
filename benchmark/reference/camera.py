"""Primary rays (raytracer.cpp:409-474): AA jitter, the polygonal
diaphragm, Brown-Conrady lens distortion, a thin lens with the film scaled
by the focus distance, and the cos^4 vignette.  The camera's scalars are
float32 0-d tensors, so its arithmetic rounds in float32."""

from __future__ import annotations

import math
from typing import Dict

import torch

from .vec import PI, Vec3, dot, lerp, normalize


def camera_tensors(cam: Dict, device) -> Dict:
    def s(v):
        return torch.tensor(float(v), dtype=torch.float32, device=device)

    out = {k: (Vec3(*(s(c) for c in cam[k])) if k in ("p", "x", "y", "z")
               else s(cam[k]))
           for k in ("p", "x", "y", "z", "lens_radius", "focus_distance",
                     "film_distance", "half_film_w", "half_film_h")}
    return out


def _bokeh(u, v, f_factor, n_edges, phi_shutter_max):
    """raytracer.cpp:86-94."""
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


def _distort(u, v, amount, w, h):
    """raytracer.cpp:110-123, with the rescale when the amount is
    positive."""
    woh = w / h
    zero = torch.zeros((), dtype=torch.float32, device=u.device)
    minu, minv = _brown_conrady(zero, zero, amount, woh)
    maxu, maxv = _brown_conrady(zero + 1.0, zero + 1.0, amount, woh)
    du, dv = _brown_conrady(u, v, amount, woh)
    if amount > 0.0:
        return (du - minu) / (minu + maxu), (dv - minv) / (minv + maxv)
    return du, dv


def primary_rays(cam: Dict, st: Dict, px, py, w: int, h: int,
                 aa_u, aa_v, dof_u, dof_v):
    """(origin, direction, vignette) of each pixel's sample; ``cam`` from
    ``camera_tensors``, ``st`` the scene settings."""
    pixel_w = 1.0 / w
    pixel_h = 1.0 / h
    u_ = 1.0 - 2.0 * px.to(torch.float32) * pixel_w
    v_ = 1.0 - 2.0 * py.to(torch.float32) * pixel_h
    u, v = _distort(u_, v_, st["lens_distortion"], float(w), float(h))
    jitter_x = aa_u - 0.5
    jitter_y = aa_v - 0.5
    bx, by = _bokeh(dof_u, dof_v, st["f_factor"], st["diaphragm_edges"],
                    PI * st["phi_shutter_max"])
    half_film_w = cam["half_film_w"] * cam["focus_distance"]
    half_film_h = cam["half_film_h"] * cam["focus_distance"]
    film_distance = cam["focus_distance"] * cam["film_distance"]
    film_center = cam["p"] - cam["z"] * film_distance
    dof_x = half_film_w * pixel_w * cam["lens_radius"] * bx
    dof_y = half_film_h * pixel_h * cam["lens_radius"] * by
    film_p = film_center \
        + cam["x"] * ((u + pixel_w * jitter_x) * half_film_w) \
        + cam["y"] * ((v + pixel_h * jitter_y) * half_film_h)
    o = cam["p"] + cam["x"] * dof_x + cam["y"] * dof_y
    d = normalize(film_p - o)
    cosz = dot(d, cam["z"])
    vig = cosz * cosz * cosz * cosz
    return o, d, lerp(1.0, vig, st["vignette_strength"])
