"""Query result type and the plane pass shared by the scene queries.

Counterpart of the ``BIG_T``, ``Hit`` and ``_intersect_planes`` part of
``buas_pathtracer_tpu/ops/traverse.py``.  Planes live outside the BVH and
are tested linearly first (reference intersection.cpp:424-433).  The JAX
package's threaded binary walk (its oracle mode) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vec import Vec3
from . import intersect

BIG_T = 3.0e38


class Hit(NamedTuple):
    """Result of a closest-hit query (one entry per ray)."""

    t: torch.Tensor
    hit_id: torch.Tensor  # -1 = miss, [0,K) = primitive, K+i = plane i
    mat_id: torch.Tensor  # material index of the winning hit (0 if miss)
    tri: torch.Tensor  # triangle index for mesh hits, else -1
    bary_v: torch.Tensor
    bary_w: torch.Tensor
    p: Vec3  # world hit point
    n: Vec3  # world shading normal
    node_visits: torch.Tensor  # traversal stats (0-d), summed over the batch
    tri_tests: torch.Tensor

    @property
    def valid(self):
        return self.hit_id >= 0


def _intersect_planes(ps, ray_o: Vec3, ray_d: Vec3, t0):
    """Linear plane loop (intersection.cpp:424-433). Returns (t, plane_idx)."""
    t = t0
    idx = torch.full_like(t0, -1, dtype=torch.int64)
    for p in range(int(ps.plane_d.shape[0])):
        pn = Vec3(ps.plane_n.x[p], ps.plane_n.y[p], ps.plane_n.z[p])
        hit, t = intersect.plane(ray_o, ray_d, pn, ps.plane_d[p], t)
        idx = torch.where(hit, p, idx)
    return t, idx
