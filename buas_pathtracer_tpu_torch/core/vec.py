"""SoA 3-vector math on PyTorch tensors.

Counterpart of ``buas_pathtracer_tpu/core/vec.py``.  A batch of 3-vectors is
three ``(N,)`` tensors (or Python floats for scene constants), so every
elementwise op runs over the whole ray batch.  The host-side affine and AABB
helpers stay in numpy, exactly as in the JAX package, so packed tables come
out byte-equal.

Reference semantics kept: ``noz`` returns 0 for degenerate inputs (0, inf,
NaN lengths); ``transform_normal`` applies the transpose of the inverse.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Union

import numpy as np
import torch

Scalar = Union[float, torch.Tensor]

PI = float(np.pi)
TAU = float(2.0 * np.pi)
EPSILON = 0.001  # reference EPSILON (common.h)


class Vec3(NamedTuple):
    """Batch of 3-vectors in SoA layout; each component a tensor or float."""

    x: Scalar
    y: Scalar
    z: Scalar

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

    def __rtruediv__(self, o):
        return Vec3(o / self.x, o / self.y, o / self.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    @property
    def shape(self):
        return self.x.shape

    def astype(self, dt):
        return Vec3(torch.as_tensor(self.x, dtype=dt),
                    torch.as_tensor(self.y, dtype=dt),
                    torch.as_tensor(self.z, dtype=dt))

    def stack(self, axis: int = -1) -> torch.Tensor:
        """To AoS ``(..., 3)`` (host IO and debugging, not hot paths)."""
        return torch.stack([torch.as_tensor(self.x), torch.as_tensor(self.y),
                            torch.as_tensor(self.z)], dim=axis)


def v3(x: Scalar, y: Scalar = None, z: Scalar = None) -> Vec3:
    """``v3(s)`` splats like the reference's ``v3(f32)``."""
    if y is None:
        return Vec3(x, x, x)
    return Vec3(x, y, z)


def from_stacked(a) -> Vec3:
    """From an AoS ``(..., 3)`` tensor."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def full_like(v: Vec3, val: float) -> Vec3:
    return Vec3(torch.full_like(v.x, val), torch.full_like(v.y, val),
                torch.full_like(v.z, val))


def zeros(shape, device, dtype=torch.float32) -> Vec3:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return Vec3(z, z.clone(), z.clone())


def broadcast_to(v: Vec3, shape) -> Vec3:
    return Vec3(*(torch.broadcast_to(torch.as_tensor(c), shape)
                  for c in (v.x, v.y, v.z)))


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def length_sq(a: Vec3):
    return dot(a, a)


def length(a: Vec3):
    return torch.sqrt(dot(a, a))


def normalize(a: Vec3) -> Vec3:
    return a * torch.rsqrt(dot(a, a))


def noz(a: Vec3) -> Vec3:
    """Normalize-or-zero (reference ``my_math.h`` noz): degenerate -> 0."""
    lsq = dot(a, a)
    ok = (lsq > 1e-24) & torch.isfinite(lsq)
    inv = torch.rsqrt(torch.where(ok, lsq, 1.0))
    return Vec3(torch.where(ok, a.x * inv, 0.0),
                torch.where(ok, a.y * inv, 0.0),
                torch.where(ok, a.z * inv, 0.0))


def lerp(a, b, t):
    if isinstance(a, Vec3) or isinstance(b, Vec3):
        if not isinstance(a, Vec3):
            a = v3(a)
        if not isinstance(b, Vec3):
            b = v3(b)
        if isinstance(t, Vec3):
            return Vec3(a.x + (b.x - a.x) * t.x,
                        a.y + (b.y - a.y) * t.y,
                        a.z + (b.z - a.z) * t.z)
        return Vec3(a.x + (b.x - a.x) * t,
                    a.y + (b.y - a.y) * t,
                    a.z + (b.z - a.z) * t)
    return a + (b - a) * t


def vmin(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.minimum(a.x, b.x), torch.minimum(a.y, b.y),
                torch.minimum(a.z, b.z))


def vmax(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.maximum(a.x, b.x), torch.maximum(a.y, b.y),
                torch.maximum(a.z, b.z))


def vabs(a: Vec3) -> Vec3:
    return Vec3(torch.abs(a.x), torch.abs(a.y), torch.abs(a.z))


def max3(a: Vec3):
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def min3(a: Vec3):
    return torch.minimum(a.x, torch.minimum(a.y, a.z))


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(mask, a.x, b.x),
                torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror reflection of direction ``d`` about normal ``n``."""
    return d - n * (2.0 * dot(d, n))


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def exp(a: Vec3) -> Vec3:
    return Vec3(torch.exp(a.x), torch.exp(a.y), torch.exp(a.z))


# ---------------------------------------------------------------------------
# Orthonormal basis (Duff et al.; integrators.cpp:57-74)
# ---------------------------------------------------------------------------

def get_tangents(n: Vec3):
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    b1 = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    b2 = Vec3(b, sign + n.y * n.y * a, -n.y)
    return b1, b2


def oriented_around_normal(v: Vec3, n: Vec3) -> Vec3:
    """Map local (x=B, y=N, z=T) into world around ``n`` (local +y = normal)."""
    t, b = get_tangents(n)
    return b * v.x + n * v.y + t * v.z


# ---------------------------------------------------------------------------
# Host-side affine transforms (numpy, reference M4x4Inv)
# ---------------------------------------------------------------------------


class Affine(NamedTuple):
    """Forward/inverse affine pair, rows stored as (3,4) float32 numpy."""

    fwd: np.ndarray  # (3,4)
    inv: np.ndarray  # (3,4)

    def __matmul__(self, o: "Affine") -> "Affine":
        return affine_compose(self, o)

    def __mul__(self, o: "Affine") -> "Affine":
        return affine_compose(self, o)


def _compose34(a, b):
    """(3,4) affine product a∘b (apply b first)."""
    ra, ta = a[:, :3], a[:, 3]
    rb, tb = b[:, :3], b[:, 3]
    r = ra @ rb
    t = ra @ tb + ta
    return np.concatenate([r, t[:, None]], axis=1).astype(np.float32)


def affine_compose(a: Affine, b: Affine) -> Affine:
    return Affine(_compose34(a.fwd, b.fwd), _compose34(b.inv, a.inv))


def identity() -> Affine:
    m = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1).astype(np.float32)
    return Affine(m, m.copy())


def translate(t) -> Affine:
    t = np.asarray(t, np.float32).reshape(3)
    f = np.concatenate([np.eye(3), t[:, None]], axis=1).astype(np.float32)
    i = np.concatenate([np.eye(3), -t[:, None]], axis=1).astype(np.float32)
    return Affine(f, i)


def scale(s) -> Affine:
    s = np.asarray(s, np.float32)
    if s.ndim == 0:
        s = np.array([s, s, s], np.float32)
    f = np.concatenate([np.diag(s), np.zeros((3, 1))], axis=1).astype(np.float32)
    i = np.concatenate([np.diag(1.0 / s), np.zeros((3, 1))], axis=1).astype(np.float32)
    return Affine(f, i)


def _rot_affine(r: np.ndarray) -> Affine:
    f = np.concatenate([r, np.zeros((3, 1))], axis=1).astype(np.float32)
    i = np.concatenate([r.T, np.zeros((3, 1))], axis=1).astype(np.float32)
    return Affine(f, i)


def rotate_x(angle: float) -> Affine:
    c, s = math.cos(angle), math.sin(angle)
    return _rot_affine(np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64))


def rotate_y(angle: float) -> Affine:
    c, s = math.cos(angle), math.sin(angle)
    return _rot_affine(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64))


def rotate_z(angle: float) -> Affine:
    c, s = math.cos(angle), math.sin(angle)
    return _rot_affine(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64))


def transform_point(m, p: Vec3) -> Vec3:
    """Apply a (3,4) affine row-matrix to points (w = 1)."""
    return Vec3(m[0, 0] * p.x + m[0, 1] * p.y + m[0, 2] * p.z + m[0, 3],
                m[1, 0] * p.x + m[1, 1] * p.y + m[1, 2] * p.z + m[1, 3],
                m[2, 0] * p.x + m[2, 1] * p.y + m[2, 2] * p.z + m[2, 3])


def transform_vector(m, v: Vec3) -> Vec3:
    """Apply a (3,4) affine row-matrix to directions (w = 0)."""
    return Vec3(m[0, 0] * v.x + m[0, 1] * v.y + m[0, 2] * v.z,
                m[1, 0] * v.x + m[1, 1] * v.y + m[1, 2] * v.z,
                m[2, 0] * v.x + m[2, 1] * v.y + m[2, 2] * v.z)


def transform_normal(inv_m, n: Vec3) -> Vec3:
    """Normals go by the inverse-transpose: given the INVERSE matrix, apply
    its 3x3 transpose (reference my_math.h:948-963)."""
    return Vec3(inv_m[0, 0] * n.x + inv_m[1, 0] * n.y + inv_m[2, 0] * n.z,
                inv_m[0, 1] * n.x + inv_m[1, 1] * n.y + inv_m[2, 1] * n.z,
                inv_m[0, 2] * n.x + inv_m[1, 2] * n.y + inv_m[2, 2] * n.z)


def aabb_surface_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def transform_aabb(m: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """World AABB of an object-space AABB under (3,4) affine ``m``: all 8
    corners, like the reference TLAS build (scene.cpp:224-236)."""
    corners = np.array(
        [
            [lo[0], lo[1], lo[2]],
            [hi[0], lo[1], lo[2]],
            [lo[0], hi[1], lo[2]],
            [lo[0], lo[1], hi[2]],
            [hi[0], hi[1], lo[2]],
            [hi[0], lo[1], hi[2]],
            [lo[0], hi[1], hi[2]],
            [hi[0], hi[1], hi[2]],
        ],
        np.float32,
    )
    wc = corners @ m[:, :3].T + m[:, 3]
    return wc.min(axis=0), wc.max(axis=0)
