"""SoA 3-vectors over torch tensors: three (N,) tensors (or Python floats
for constants), so every operation runs over the whole batch of rays."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PI = float(np.pi)
TAU = float(2.0 * np.pi)
EPSILON = 0.001  # the source's EPSILON (common.h)


class Vec3(NamedTuple):
    x: object
    y: object
    z: object

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def map(self, f) -> "Vec3":
        return Vec3(f(self.x), f(self.y), f(self.z))


def v3(x, y=None, z=None) -> Vec3:
    if y is None:
        return Vec3(x, x, x)
    return Vec3(x, y, z)


def full_like(v: Vec3, val: float) -> Vec3:
    return v.map(lambda c: torch.full_like(c, val))


def zeros(n: int, device) -> Vec3:
    z = torch.zeros(n, dtype=torch.float32, device=device)
    return Vec3(z, z.clone(), z.clone())


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def normalize(a: Vec3) -> Vec3:
    return a * torch.rsqrt(dot(a, a))


def noz(a: Vec3) -> Vec3:
    """Normalise, or zero for a degenerate (0, inf, NaN) length."""
    lsq = dot(a, a)
    ok = (lsq > 1e-24) & torch.isfinite(lsq)
    inv = torch.rsqrt(torch.where(ok, lsq, 1.0))
    return Vec3(torch.where(ok, a.x * inv, 0.0),
                torch.where(ok, a.y * inv, 0.0),
                torch.where(ok, a.z * inv, 0.0))


def lerp(a, b, t):
    if isinstance(a, Vec3) or isinstance(b, Vec3):
        a = a if isinstance(a, Vec3) else v3(a)
        b = b if isinstance(b, Vec3) else v3(b)
        return Vec3(a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t,
                    a.z + (b.z - a.z) * t)
    return a + (b - a) * t


def max3(a: Vec3):
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def reflect(d: Vec3, n: Vec3) -> Vec3:
    return d - n * (2.0 * dot(d, n))


def vexp(a: Vec3) -> Vec3:
    return a.map(torch.exp)


def oriented_around_normal(v: Vec3, n: Vec3) -> Vec3:
    """Local (x, y = normal, z) to world around ``n`` (Duff et al.'s
    basis, integrators.cpp:57-74)."""
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    t = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bb = Vec3(b, sign + n.y * n.y * a, -n.y)
    return bb * v.x + n * v.y + t * v.z
