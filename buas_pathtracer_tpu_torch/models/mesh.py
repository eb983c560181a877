"""Triangle mesh container (host side, numpy).

Counterpart of ``buas_pathtracer_tpu/models/mesh.py`` (reference Mesh,
primitives.h:58-79): triangle vertices, optional per-vertex normals and
texture coordinates as parallel triangle arrays, and a lazily built per-mesh
BVH whose ``order`` reorders the triangles into leaf order
(bvh.cpp:379-391).  The reorder feeds the wide-row build, so it must match
the JAX package's for the packed tables to be byte-equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops import bvh as bvh_mod


@dataclass
class Mesh:
    triangles: np.ndarray  # (T, 3, 3) float32 vertices a/b/c
    normals: Optional[np.ndarray] = None  # (T, 3, 3) per-vertex normals
    texcoords: Optional[np.ndarray] = None  # (T, 3, 2)
    bvh: Optional[bvh_mod.BuildNodes] = None

    @property
    def triangle_count(self) -> int:
        return int(self.triangles.shape[0])

    @property
    def has_normals(self) -> bool:
        return self.normals is not None

    def object_aabb(self):
        lo = self.triangles.reshape(-1, 3).min(axis=0)
        hi = self.triangles.reshape(-1, 3).max(axis=0)
        return lo.astype(np.float32), hi.astype(np.float32)

    def build_bvh(self, method: str = "sah_binned"):
        """create_bvh_for_mesh (bvh.cpp:342-426): per-tri AABBs -> SAH build,
        then reorder triangles (and parallel arrays) into leaf order."""
        if self.bvh is not None:
            return self.bvh
        tri = np.asarray(self.triangles, np.float32)
        b = bvh_mod.build_bvh(tri.min(axis=1), tri.max(axis=1), method=method)
        order = b.order
        self.triangles = tri[order]
        if self.normals is not None:
            self.normals = np.asarray(self.normals, np.float32)[order]
        if self.texcoords is not None:
            self.texcoords = np.asarray(self.texcoords, np.float32)[order]
        # triangles now ARE in leaf order; neutralize the permutation
        self.bvh = bvh_mod.BuildNodes(
            b.lo, b.hi, b.left_first, b.count, b.axis,
            np.arange(len(order), dtype=np.int32))
        return self.bvh
