"""Batched ray-primitive intersection.

Counterpart of ``buas_pathtracer_tpu/ops/intersect.py`` (reference
intersection.cpp:12-241).  Each function maps elementwise over ray batches
and returns ``(hit, t_new)`` against a running closest ``t``.  Acceptance
rules follow the reference:

  plane:    denom < -EPS, t in [EPS, t_cur)            (intersection.cpp:12-42)
  sphere:   object-space quadratic, near-else-far root (intersection.cpp:44-74)
  box:      iq slab method                             (intersection.cpp:76-105)
  aabb:     boolean slab tests, centre or min/max form  (intersection.cpp:107-133)
  triangle: Moller-Trumbore, eps=1e-9                  (intersection.cpp:135-182)
"""

from __future__ import annotations

import torch

from ..core.vec import EPSILON, Vec3, cross, dot

TRI_EPS = 1e-9

# A sign-preserving clamped reciprocal keeps every slab product finite
# (|inv_d| <= 1e18), so min/max never meet NaN from 0 * inf.
_INV_DIR_EPS = 1e-18


def safe_inv_dir(ray_d: Vec3) -> Vec3:
    def inv(c):
        s = torch.where(c >= 0.0, 1.0, -1.0)
        return s / torch.clamp(torch.abs(c), min=_INV_DIR_EPS)

    return Vec3(inv(ray_d.x), inv(ray_d.y), inv(ray_d.z))


def plane(ray_o: Vec3, ray_d: Vec3, plane_n: Vec3, plane_d, t_cur):
    denom = dot(plane_n, ray_d)
    safe = torch.where(denom == 0.0, -1.0, denom)
    t = (plane_d - dot(plane_n, ray_o)) / safe
    hit = (denom < -EPSILON) & (t >= EPSILON) & (t < t_cur)
    return hit, torch.where(hit, t, t_cur)


def sphere(ray_o: Vec3, ray_d: Vec3, radius, t_cur):
    """General quadratic (a = dot(d, d)): equal to the reference's for unit
    rays and right under scaled instance transforms."""
    a = dot(ray_d, ray_d)
    b = dot(ray_d, ray_o)
    c = dot(ray_o, ray_o) - radius * radius
    discr = b * b - a * c
    root = torch.sqrt(torch.clamp(discr, min=0.0))
    inv_a = 1.0 / torch.clamp(a, min=1e-30)
    tn = (-b - root) * inv_a
    tf = (-b + root) * inv_a
    t = torch.where(tn >= 0.0, tn, tf)
    hit = (discr >= 0.0) & (t >= EPSILON) & (t_cur > t)
    return hit, torch.where(hit, t, t_cur)


def box(ray_o: Vec3, ray_d: Vec3, box_r: Vec3, t_cur):
    inv_d = safe_inv_dir(ray_d)
    n = inv_d * ray_o
    k = Vec3(torch.abs(inv_d.x), torch.abs(inv_d.y), torch.abs(inv_d.z)) * box_r
    t1 = -n - k
    t2 = -n + k
    tn = torch.maximum(torch.maximum(t1.x, t1.y), t1.z)
    tf = torch.minimum(torch.minimum(t2.x, t2.y), t2.z)
    t = torch.where(tn >= 0.0, tn, tf)
    hit = (tn < tf) & (t_cur > t) & (t >= EPSILON)
    return hit, torch.where(hit, t, t_cur)


def aabb(ray_o: Vec3, inv_d: Vec3, box_p: Vec3, box_r: Vec3, far_clip):
    """Bounding-volume test (boolean), centre / half-extent form."""
    n = inv_d * (ray_o - box_p)
    k = Vec3(torch.abs(inv_d.x), torch.abs(inv_d.y), torch.abs(inv_d.z)) * box_r
    t1 = -n - k
    t2 = -n + k
    tn = torch.maximum(torch.maximum(t1.x, t1.y), t1.z)
    tf = torch.minimum(torch.minimum(t2.x, t2.y), t2.z)
    return (tn < tf) & (tf > 0.0) & (tn < far_clip)


def aabb_minmax(ray_o: Vec3, inv_d: Vec3, lo: Vec3, hi: Vec3, far_clip):
    """Bounding-volume test, min / max corner form (the threaded walk's
    node test)."""
    t1 = (lo - ray_o) * inv_d
    t2 = (hi - ray_o) * inv_d
    tn = torch.maximum(
        torch.maximum(torch.minimum(t1.x, t2.x), torch.minimum(t1.y, t2.y)),
        torch.minimum(t1.z, t2.z))
    tf = torch.minimum(
        torch.minimum(torch.maximum(t1.x, t2.x), torch.maximum(t1.y, t2.y)),
        torch.maximum(t1.z, t2.z))
    return (tn < tf) & (tf > 0.0) & (tn < far_clip)


def triangle(ray_o: Vec3, ray_d: Vec3, a: Vec3, b: Vec3, c: Vec3, t_cur):
    """Returns (hit, t_new, u, v, w) with barycentrics (u = 1-v-w)."""
    edge1 = b - a
    edge2 = c - a
    pvec = cross(ray_d, edge2)
    det = dot(edge1, pvec)
    ok = (det <= -TRI_EPS) | (det >= TRI_EPS)
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvec = ray_o - a
    v = dot(tvec, pvec) * inv_det
    ok = ok & (v >= 0.0) & (v <= 1.0)
    qvec = cross(tvec, edge1)
    w = dot(ray_d, qvec) * inv_det
    ok = ok & (w >= 0.0) & (v + w <= 1.0)
    t = dot(edge2, qvec) * inv_det
    ok = ok & (t >= TRI_EPS) & (t_cur >= t)
    return ok, torch.where(ok, t, t_cur), 1.0 - v - w, v, w
