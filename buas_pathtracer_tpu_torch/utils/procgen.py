"""Procedural test meshes.

Counterpart of ``buas_pathtracer_tpu/utils/procgen.py`` (``icosphere``,
``torus``): the
reference's mesh scenes load an OBJ that is not checked in, so the bench
scene and the tests build subdivided icospheres instead.
"""

from __future__ import annotations

import numpy as np

from ..models.mesh import Mesh


def icosphere(subdivisions: int = 3, radius: float = 1.0) -> Mesh:
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)

    v = verts[faces] * radius  # (T, 3, 3)
    n = verts[faces]  # unit sphere normals = positions
    return Mesh(triangles=v.astype(np.float32), normals=n.astype(np.float32))


def torus(major: float = 1.0, minor: float = 0.35,
          seg_u: int = 48, seg_v: int = 24) -> Mesh:
    """A torus around +y with per-vertex normals, two triangles a quad."""
    u = np.linspace(0, 2 * np.pi, seg_u, endpoint=False)
    v = np.linspace(0, 2 * np.pi, seg_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    p = np.stack([np.cos(uu) * (major + minor * np.cos(vv)),
                  minor * np.sin(vv),
                  np.sin(uu) * (major + minor * np.cos(vv))], axis=-1)
    nrm = np.stack([np.cos(uu) * np.cos(vv), np.sin(vv),
                    np.sin(uu) * np.cos(vv)], axis=-1)
    tris, tnorm = [], []
    for i in range(seg_u):
        for j in range(seg_v):
            i2, j2 = (i + 1) % seg_u, (j + 1) % seg_v
            a, b, c, d = p[i, j], p[i2, j], p[i2, j2], p[i, j2]
            na, nb, nc, nd = nrm[i, j], nrm[i2, j], nrm[i2, j2], nrm[i, j2]
            tris += [[a, b, c], [a, c, d]]
            tnorm += [[na, nb, nc], [na, nc, nd]]
    return Mesh(triangles=np.asarray(tris, np.float32),
                normals=np.asarray(tnorm, np.float32))
