"""A scene as plain data: what a configuration file describes.

A configuration (``benchmark/configs/<name>.py``) fills a ``SceneData``
from its source's own description: materials, planes, spheres, boxes and
mesh instances with their (3, 4) forward and inverse transforms, the
camera, the render settings, the post settings and the environment map's
file.  Everything is numpy or Python values; nothing here imports the
program or torch.  The harness hands the data to the program through its
public ``Scene`` API (``harness/port_scene.py``); the reference reads it as
it is (``reference/scene.py``).

The helpers below (affine products, the camera frame, the icosphere) are
frozen copies of the arithmetic the upstream scene descriptions use, so a
configuration describes its scene the way the source does.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# material flags (scene.h)
FLAG_CHECKERS = 0x2
FLAG_EMISSIVE = 0x4


@dataclass
class SceneData:
    """One scene, as its source describes it.  Material 0 is air (ior 1, a
    participating medium with no absorption), as in the source's scene
    API; ``add_material`` returns the next index."""

    name: str
    filter_name: str = "Mitchell Netravali"
    camera: Dict = field(default_factory=dict)
    settings: Dict = field(default_factory=dict)
    post: Dict = field(default_factory=dict)
    sky_top: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sky_bot: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    materials: List[Dict] = field(default_factory=list)
    planes: List[Dict] = field(default_factory=list)
    prims: List[Dict] = field(default_factory=list)
    meshes: List[Dict] = field(default_factory=list)
    # an equirect environment map (a Radiance .hdr file), relative to the
    # repository's root; None lights misses by the gradient sky
    env_path: Optional[str] = None

    def __post_init__(self):
        if not self.materials:
            self.materials.append(material(ior=1.0, is_medium=True))

    @property
    def env_file(self) -> Optional[str]:
        """The environment map's absolute path, or None."""
        return None if self.env_path is None else os.path.join(
            ROOT, self.env_path)

    def add_material(self, m: Dict) -> int:
        self.materials.append(m)
        return len(self.materials) - 1

    def add_plane(self, mat: int, n, d: float):
        nn = np.asarray(n, np.float64)
        nn = nn / np.linalg.norm(nn)
        self.planes.append(dict(n=nn.astype(np.float32), d=float(d),
                                mat=int(mat)))

    def add_sphere(self, mat: int, r: float, xf=None):
        fwd, inv = xf if xf is not None else identity()
        self.prims.append(dict(type="sphere", mat=int(mat), fwd=fwd, inv=inv,
                               r=float(r)))

    def add_box(self, mat: int, r, xf=None):
        fwd, inv = xf if xf is not None else identity()
        rr = np.asarray(r, np.float32)
        if rr.ndim == 0:
            rr = np.array([rr, rr, rr], np.float32)
        self.prims.append(dict(type="box", mat=int(mat), fwd=fwd, inv=inv,
                               box_r=rr))

    def add_mesh_data(self, triangles: np.ndarray,
                      normals: Optional[np.ndarray]) -> int:
        self.meshes.append(dict(triangles=triangles, normals=normals))
        return len(self.meshes) - 1

    def add_mesh(self, mat: int, mesh: int, xf=None):
        fwd, inv = xf if xf is not None else identity()
        self.prims.append(dict(type="mesh", mat=int(mat), fwd=fwd, inv=inv,
                               mesh=int(mesh)))


def material(albedo=(0.0, 0.0, 0.0), checker_color=(0.0, 0.0, 0.0),
             emission=(0.0, 0.0, 0.0), ior=0.0, metallic=0.0, roughness=0.0,
             is_medium=False, absorb=(0.0, 0.0, 0.0), flags=0) -> Dict:
    """scene.h's Material; an emissive colour sets the emissive flag."""
    if sum(emission) > 0.0:
        flags |= FLAG_EMISSIVE
    return dict(flags=int(flags), albedo=tuple(albedo),
                checker_color=tuple(checker_color), emission=tuple(emission),
                ior=float(ior), metallic=float(metallic),
                roughness=float(roughness), is_medium=bool(is_medium),
                absorb=tuple(absorb))


def diffuse(albedo, ior, roughness=0.0, checkers=False,
            checker_color=(0.1, 0.1, 0.1)) -> Dict:
    """add_diffuse_material (scene.cpp:23-37)."""
    return material(albedo=albedo, ior=ior, roughness=roughness,
                    checker_color=checker_color,
                    flags=FLAG_CHECKERS if checkers else 0)


def translucent(absorb, ior, roughness=0.0) -> Dict:
    """add_translucent_material (scene.cpp:39-50)."""
    return material(is_medium=True, absorb=absorb, ior=ior,
                    roughness=roughness)


def emissive(emission) -> Dict:
    """add_emissive_material (scene.cpp:52-61)."""
    return material(emission=emission)


# ---------------------------------------------------------------------------
# (3, 4) affine pairs (fwd, inv), float32, composed as the source's scene
# code composes them
# ---------------------------------------------------------------------------

def _compose34(a, b):
    ra, ta = a[:, :3], a[:, 3]
    rb, tb = b[:, :3], b[:, 3]
    r = ra @ rb
    t = ra @ tb + ta
    return np.concatenate([r, t[:, None]], axis=1).astype(np.float32)


def compose(*xfs):
    """The product of (fwd, inv) pairs, the rightmost applied first."""
    fwd, inv = xfs[0]
    for f2, i2 in xfs[1:]:
        fwd, inv = _compose34(fwd, f2), _compose34(i2, inv)
    return fwd, inv


def identity():
    m = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1).astype(np.float32)
    return m, m.copy()


def translate(t):
    t = np.asarray(t, np.float32).reshape(3)
    f = np.concatenate([np.eye(3), t[:, None]], axis=1).astype(np.float32)
    i = np.concatenate([np.eye(3), -t[:, None]], axis=1).astype(np.float32)
    return f, i


def scale(s):
    s = np.asarray(s, np.float32)
    if s.ndim == 0:
        s = np.array([s, s, s], np.float32)
    f = np.concatenate([np.diag(s), np.zeros((3, 1))], axis=1).astype(np.float32)
    i = np.concatenate([np.diag(1.0 / s), np.zeros((3, 1))],
                       axis=1).astype(np.float32)
    return f, i


def _rotation(r):
    f = np.concatenate([r, np.zeros((3, 1))], axis=1).astype(np.float32)
    i = np.concatenate([r.T, np.zeros((3, 1))], axis=1).astype(np.float32)
    return f, i


def rotate_x(angle: float):
    c, s = math.cos(angle), math.sin(angle)
    return _rotation(np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64))


def rotate_y(angle: float):
    c, s = math.cos(angle), math.sin(angle)
    return _rotation(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64))


# ---------------------------------------------------------------------------
# camera (raytracer.cpp:26-58): p, the right / up / backward axes, and the
# film, all plain floats
# ---------------------------------------------------------------------------

def _noz(d):
    n = np.linalg.norm(d)
    return d / n if n > 1e-20 else d * 0.0


def camera(p, vfov: float, aspect: float, lens_radius: float = 0.0,
           focus_distance: float = 1.0, at=None) -> Dict:
    """make_camera, then aim_camera_at ``at`` when given (which sets the
    focus distance to the target's distance); ``vfov`` in radians."""
    cam = dict(p=tuple(float(q) for q in p), x=(1.0, 0.0, 0.0),
               y=(0.0, 1.0, 0.0), z=(0.0, 0.0, 1.0), vfov=float(vfov),
               aspect=float(aspect), lens_radius=float(lens_radius),
               focus_distance=float(focus_distance))
    if at is not None:
        cv = np.asarray(at, np.float64) - np.array(cam["p"])
        z = _noz(-_noz(cv))
        x = _noz(np.cross([0.0, 1.0, 0.0], z))
        y = _noz(np.cross(z, x))
        cam.update(x=tuple(x.astype(float)), y=tuple(y.astype(float)),
                   z=tuple(z.astype(float)),
                   focus_distance=float(np.linalg.norm(cv)))
    cam.update(half_film_w=0.5 * cam["aspect"], half_film_h=0.5,
               film_distance=1.0 / math.tan(cam["vfov"]))
    return cam


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def icosphere(subdivisions: int, radius: float = 1.0):
    """A subdivided icosahedron: (T, 3, 3) float32 vertices and the unit
    sphere's per-vertex normals."""
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
    v = verts[faces] * radius
    n = verts[faces]
    return v.astype(np.float32), n.astype(np.float32)
