"""Sampling and shading helpers of the Advanced Pathtracer
(integrators.cpp:11-308): hemisphere maps, Fresnel and refraction, the
gradient sky, the world-space checker, and sphere-light sampling."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .vec import PI, TAU, Vec3, dot, lerp, normalize, oriented_around_normal


def sample_on_unit_sphere(u, v) -> Vec3:
    z = 1.0 - 2.0 * u
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TAU * v
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def map_to_hemisphere(n: Vec3, u, v) -> Vec3:
    azimuth = TAU * u
    s = torch.sqrt(torch.clamp(1.0 - v * v, min=0.0))
    return oriented_around_normal(
        Vec3(torch.cos(azimuth) * s, v, torch.sin(azimuth) * s), n)


def map_to_cosine_weighted_hemisphere(n: Vec3, u, v) -> Vec3:
    azimuth = TAU * u
    s = torch.sqrt(torch.clamp(1.0 - v, min=0.0))
    return oriented_around_normal(
        Vec3(torch.cos(azimuth) * s, torch.sqrt(v), torch.sin(azimuth) * s), n)


def fresnel_dielectric(cos_theta_i, eta_i, eta_t, eta_ratio):
    """(reflectance, cos_theta_t); total internal reflection gives 1."""
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_theta_i * cos_theta_i, min=0.0))
    sin_t = eta_ratio * sin_i
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_par = ((eta_t * cos_theta_i) - (eta_i * cos_t)) / (
        (eta_t * cos_theta_i) + (eta_i * cos_t))
    r_perp = ((eta_i * cos_theta_i) - (eta_t * cos_t)) / (
        (eta_i * cos_theta_i) + (eta_t * cos_t))
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(sin_t >= 1.0, 1.0, f), cos_t


def refract(d: Vec3, n: Vec3, cos_theta_i, cos_theta_t, eta_ratio) -> Vec3:
    return d * eta_ratio + n * (eta_ratio * cos_theta_i - cos_theta_t)


def sky(d: Vec3, bot: Vec3, top: Vec3) -> Vec3:
    return lerp(bot, top, torch.abs(d.y))


def checker(albedo: Vec3, checker_color: Vec3, use_checker, p: Vec3) -> Vec3:
    cx = torch.floor(0.25 * p.x).to(torch.int32)
    cz = torch.floor(0.25 * p.z).to(torch.int32)
    pick = (((cx ^ cz) & 1) != 0) & use_checker
    return Vec3(torch.where(pick, checker_color.x, albedo.x),
                torch.where(pick, checker_color.y, albedo.y),
                torch.where(pick, checker_color.z, albedo.z))


class LightSample(NamedTuple):
    L: Vec3
    Nl: Vec3
    dist: torch.Tensor
    dist_sq: torch.Tensor
    A: torch.Tensor


def point_on_sphere_light(fwd, r, u, v, p: Vec3) -> LightSample:
    """A point on the hemisphere of the sphere light facing ``p``
    (integrators.cpp:199-228); ``fwd`` (12, N) the light's forward rows."""
    centre = Vec3(fwd[3], fwd[7], fwd[11])
    towards = normalize(centre - p)
    nl = map_to_hemisphere(-towards, u, v)
    q = nl * r
    world = Vec3(fwd[0] * q.x + fwd[1] * q.y + fwd[2] * q.z + fwd[3],
                 fwd[4] * q.x + fwd[5] * q.y + fwd[6] * q.z + fwd[7],
                 fwd[8] * q.x + fwd[9] * q.y + fwd[10] * q.z + fwd[11])
    lv = world - p
    dist_sq = dot(lv, lv)
    dist = torch.sqrt(dist_sq)
    return LightSample(lv / torch.clamp(dist, min=1e-30), nl, dist, dist_sq,
                       2.0 * PI * r * r)
