"""The reference's own tables, worked out from a configuration's
``SceneData``: materials, planes, analytic primitives, lights, every mesh
instance's triangles and vertex normals in world space, and the environment
map with its sampling tables (``envmap.py``).  Nothing here reads a table
the program made.

The render settings and post settings start from the source's defaults
(init_scene, raytracer.cpp:1424-1453; scene.h:64-90), which a
configuration overrides.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from . import envmap
from .vec import Vec3

PRIM_SPHERE = 2
PRIM_BOX = 3
PRIM_MESH = 4
_TYPES = {"sphere": PRIM_SPHERE, "box": PRIM_BOX, "mesh": PRIM_MESH}

DEFAULT_SETTINGS = dict(
    next_event_estimation=True, importance_sample_lights=True,
    importance_sample_diffuse=True, use_mis=True, russian_roulette=True,
    caustics=True, sampling_strategy=2, vignette_strength=0.25,
    lens_distortion=1.0, f_factor=0.0, diaphragm_edges=6.0,
    phi_shutter_max=0.5, samples_per_pixel=1, max_bounce_count=12,
    integrator="Advanced Pathtracer", reference_mis=False, env_nee=True,
    whitted_true_split=True)
DEFAULT_POST = dict(exposure=0.0, tonemapping=True, srgb_transform=True,
                    midpoint=0.5, contrast=0.0, dither=True)


def _vec(a: np.ndarray, dev) -> Vec3:
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return Vec3(t[:, 0].contiguous(), t[:, 1].contiguous(),
                t[:, 2].contiguous())


def _t(a, dev, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


@dataclass
class RefScene:
    settings: Dict
    post: Dict
    filter_name: str
    camera: Dict
    sky_bot: Vec3
    sky_top: Vec3
    # materials (M,)
    albedo: Vec3
    emission: Vec3
    absorb: Vec3
    checker: Vec3
    ior: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    flags: torch.Tensor  # int64
    is_medium: torch.Tensor  # bool
    # planes (P,)
    plane_n: np.ndarray  # (P, 3) float32, host
    plane_d: np.ndarray
    plane_mat: torch.Tensor
    # analytic and mesh primitives (K,)
    prim_type: torch.Tensor
    prim_mat: torch.Tensor
    prim_fwd: torch.Tensor  # (K, 12)
    prim_inv: torch.Tensor  # (K, 12)
    prim_r: torch.Tensor
    prim_box_r: torch.Tensor  # (K, 3)
    lights: torch.Tensor  # (L,) prim indices
    # world triangles (T,): a, edges, shading normals, owning prim
    tri_a: torch.Tensor  # (T, 3)
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_na: torch.Tensor
    tri_nb: torch.Tensor
    tri_nc: torch.Tensor
    tri_ng: torch.Tensor
    tri_has_n: torch.Tensor
    tri_prim: torch.Tensor
    # the equirect environment map with its tables, None without one
    env: Optional[envmap.EnvMap] = None

    @property
    def n_prims(self) -> int:
        return int(self.prim_type.shape[0])


def _world_triangles(data):
    """Each mesh instance's triangles in world space (float64 transform,
    rounded once) and its vertex normals by the inverse transpose."""
    a_l, e1_l, e2_l, na_l, ng_l, has_l, own_l = [], [], [], [], [], [], []
    for k, p in enumerate(data.prims):
        if p["type"] != "mesh":
            continue
        m = data.meshes[p["mesh"]]
        tv = np.asarray(m["triangles"], np.float64)
        fwd = np.asarray(p["fwd"], np.float64)
        w = tv @ fwd[:, :3].T + fwd[:, 3]  # (T, 3, 3)
        w32 = w.astype(np.float32)
        e1 = w32[:, 1] - w32[:, 0]
        e2 = w32[:, 2] - w32[:, 0]
        ng = np.cross(w[:, 1] - w[:, 0], w[:, 2] - w[:, 0])
        ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-300)
        if m["normals"] is not None:
            inv = np.asarray(p["inv"], np.float64)[:, :3]
            wn = np.asarray(m["normals"], np.float64) @ inv
            wn /= np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True),
                             1e-300)
            has = np.ones(len(tv), bool)
        else:
            wn = np.zeros_like(w)
            has = np.zeros(len(tv), bool)
        a_l.append(w32[:, 0])
        e1_l.append(e1)
        e2_l.append(e2)
        na_l.append(wn.astype(np.float32))
        ng_l.append(ng.astype(np.float32))
        has_l.append(has)
        own_l.append(np.full(len(tv), k, np.int64))
    if not a_l:
        z = np.zeros((0, 3), np.float32)
        return z, z, z, np.zeros((0, 3, 3), np.float32), z, \
            np.zeros(0, bool), np.zeros(0, np.int64)
    return (np.concatenate(a_l), np.concatenate(e1_l), np.concatenate(e2_l),
            np.concatenate(na_l), np.concatenate(ng_l),
            np.concatenate(has_l), np.concatenate(own_l))


def build(data, device) -> RefScene:
    mats = data.materials
    col = lambda key: np.array([m[key] for m in mats], np.float32)  # noqa
    prims = data.prims
    k = len(prims)
    fwd = np.stack([np.asarray(p["fwd"], np.float32).reshape(12)
                    for p in prims]) if k else np.zeros((0, 12), np.float32)
    inv = np.stack([np.asarray(p["inv"], np.float32).reshape(12)
                    for p in prims]) if k else np.zeros((0, 12), np.float32)
    lights = [i for i, p in enumerate(prims) if mats[p["mat"]]["flags"] & 0x4]
    a, e1, e2, nrm, ng, has, own = _world_triangles(data)
    planes = data.planes
    settings = dict(DEFAULT_SETTINGS, **data.settings)
    if settings["sampling_strategy"] != 2 or \
            settings["integrator"] != "Advanced Pathtracer" or \
            settings["reference_mis"]:
        raise ValueError("the reference renders the Advanced Pathtracer with "
                         "the stratified sampler")
    return RefScene(
        settings=settings, post=dict(DEFAULT_POST, **data.post),
        filter_name=data.filter_name, camera=data.camera,
        sky_bot=Vec3(*(torch.tensor(c, dtype=torch.float32, device=device)
                       for c in data.sky_bot)),
        sky_top=Vec3(*(torch.tensor(c, dtype=torch.float32, device=device)
                       for c in data.sky_top)),
        albedo=_vec(col("albedo"), device),
        emission=_vec(col("emission"), device),
        absorb=_vec(col("absorb"), device),
        checker=_vec(col("checker_color"), device),
        ior=_t(col("ior"), device), metallic=_t(col("metallic"), device),
        roughness=_t(col("roughness"), device),
        flags=_t(np.array([m["flags"] for m in mats], np.int64), device,
                 torch.int64),
        is_medium=_t(np.array([m["is_medium"] for m in mats], bool), device,
                     torch.bool),
        plane_n=np.array([p["n"] for p in planes], np.float32).reshape(-1, 3),
        plane_d=np.array([p["d"] for p in planes], np.float32),
        plane_mat=_t(np.array([p["mat"] for p in planes], np.int64), device,
                     torch.int64),
        prim_type=_t(np.array([_TYPES[p["type"]] for p in prims], np.int64),
                     device, torch.int64),
        prim_mat=_t(np.array([p["mat"] for p in prims], np.int64), device,
                    torch.int64),
        prim_fwd=_t(fwd, device), prim_inv=_t(inv, device),
        prim_r=_t(np.array([p.get("r", 0.0) for p in prims], np.float32),
                  device),
        prim_box_r=_t(np.array([p.get("box_r", np.zeros(3)) for p in prims],
                               np.float32).reshape(-1, 3), device),
        lights=_t(np.array(lights, np.int64), device, torch.int64),
        tri_a=_t(a, device), tri_e1=_t(e1, device), tri_e2=_t(e2, device),
        tri_na=_t(nrm[:, 0], device), tri_nb=_t(nrm[:, 1], device),
        tri_nc=_t(nrm[:, 2], device), tri_ng=_t(ng, device),
        tri_has_n=_t(has, device, torch.bool),
        tri_prim=_t(own, device, torch.int64),
        env=(envmap.build(data.env_file, device)
             if data.env_path is not None else None))
