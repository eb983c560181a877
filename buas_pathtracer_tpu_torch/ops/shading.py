"""Batched sampling-theory and shading helpers.

Counterpart of ``buas_pathtracer_tpu/ops/shading.py`` (reference
integrators.cpp:11-119 sampling helpers, :235-308 Fresnel, refraction, sky
and checker).  Rejection sampling is replaced by closed forms with the same
distributions, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.vec import PI, TAU, Vec3, lerp, oriented_around_normal


def sample_in_unit_disk(u, v):
    """Concentric disk map (integrators.cpp:30-46). Returns (x, y)."""
    ox = 2.0 * u - 1.0
    oy = 2.0 * v - 1.0
    use_x = torch.abs(ox) > torch.abs(oy)
    safe_ox = torch.where(ox == 0.0, 1.0, ox)
    safe_oy = torch.where(oy == 0.0, 1.0, oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, 0.25 * PI * (oy / safe_ox),
                        0.5 * PI - 0.25 * PI * (ox / safe_oy))
    degenerate = (ox == 0.0) & (oy == 0.0)
    x = torch.where(degenerate, 0.0, r * torch.cos(theta))
    y = torch.where(degenerate, 0.0, r * torch.sin(theta))
    return x, y


def sample_on_unit_sphere(u, v) -> Vec3:
    """integrators.cpp:48-55."""
    z = 1.0 - 2.0 * u
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TAU * v
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def random_in_unit_sphere(state):
    """Uniform point in the unit ball: direction * cbrt(u).  Returns
    (state, Vec3)."""
    state, u1 = rng.next_unilateral(state)
    state, u2 = rng.next_unilateral(state)
    state, u3 = rng.next_unilateral(state)
    return state, sample_on_unit_sphere(u1, u2) * cbrt(u3)


def cbrt(x):
    """Real cube root (torch has no cbrt; x >= 0 on every caller)."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def map_to_hemisphere(n: Vec3, u, v) -> Vec3:
    """Uniform hemisphere around n (integrators.cpp:93-104); pdf = 1/(2pi)."""
    azimuth = TAU * u
    y = v
    s = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    hemi = Vec3(torch.cos(azimuth) * s, y, torch.sin(azimuth) * s)
    return oriented_around_normal(hemi, n)


def map_to_cosine_weighted_hemisphere(n: Vec3, u, v) -> Vec3:
    """Cosine-weighted hemisphere (integrators.cpp:106-118); pdf = cos/pi."""
    azimuth = TAU * u
    y = v
    s = torch.sqrt(torch.clamp(1.0 - y, min=0.0))
    hemi = Vec3(torch.cos(azimuth) * s, torch.sqrt(y), torch.sin(azimuth) * s)
    return oriented_around_normal(hemi, n)


def random_in_cone(n: Vec3, angle, u, v) -> Vec3:
    """integrators.cpp:77-90."""
    cos_angle = torch.cos(torch.as_tensor(angle, dtype=torch.float32))
    azimuth = TAU * u
    y = cos_angle + (1.0 - cos_angle) * v
    s = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    hemi = Vec3(torch.cos(azimuth) * s, y, torch.sin(azimuth) * s)
    return oriented_around_normal(hemi, n)


def fresnel_dielectric(cos_theta_i, eta_i, eta_t, eta_i_over_eta_t):
    """Returns (reflectance, cos_theta_t); total internal reflection -> 1
    (integrators.cpp:235-263, PBRT 3ed recipe)."""
    sin_theta_i = torch.sqrt(torch.clamp(1.0 - cos_theta_i * cos_theta_i,
                                         min=0.0))
    sin_theta_t = eta_i_over_eta_t * sin_theta_i
    cos_theta_t = torch.sqrt(torch.clamp(1.0 - sin_theta_t * sin_theta_t,
                                         min=0.0))
    r_par = ((eta_t * cos_theta_i) - (eta_i * cos_theta_t)) / (
        (eta_t * cos_theta_i) + (eta_i * cos_theta_t))
    r_perp = ((eta_i * cos_theta_i) - (eta_t * cos_theta_t)) / (
        (eta_i * cos_theta_i) + (eta_t * cos_theta_t))
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    f = torch.where(sin_theta_t >= 1.0, 1.0, f)
    return f, cos_theta_t


def refract(d: Vec3, n: Vec3, cos_theta_i, cos_theta_t, eta_i_over_eta_t) -> Vec3:
    """integrators.cpp:260-263."""
    return d * eta_i_over_eta_t + n * (eta_i_over_eta_t * cos_theta_i
                                       - cos_theta_t)


def sample_sky_gradient(d: Vec3, bot: Vec3, top: Vec3) -> Vec3:
    """Gradient sky (integrators.cpp:289-293): lerp by |d.y|."""
    return lerp(bot, top, torch.abs(d.y))


def evaluate_checker(albedo: Vec3, checker_color: Vec3, use_checker,
                     hit_p: Vec3) -> Vec3:
    """4x4 world-space XZ checker (integrators.cpp:297-308)."""
    cx = torch.floor(0.25 * hit_p.x).to(torch.int32)
    cz = torch.floor(0.25 * hit_p.z).to(torch.int32)
    pick = (((cx ^ cz) & 1) != 0) & use_checker
    return Vec3(torch.where(pick, checker_color.x, albedo.x),
                torch.where(pick, checker_color.y, albedo.y),
                torch.where(pick, checker_color.z, albedo.z))
