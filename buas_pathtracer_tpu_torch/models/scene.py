"""Scene model: host-side construction API and packing to device tensors.

Counterpart of ``buas_pathtracer_tpu/models/scene.py`` (reference scene API,
scene.h:134-149, scene.cpp:9-242): materials, planes (kept out of the BVH),
spheres, boxes and mesh instances with forward/inverse transform pairs, and
automatic light registration for emissive primitives.

``Scene.pack(device=None)`` lowers the scene to ``PackedScene``, a NamedTuple
of tensors on one device, holding the fields the bench frame reads:
materials, planes, primitives, lights, the 8-wide row table and its
per-triangle normals, the sky, the environment map with its sampling tables
(``ops/envmap.py``), and for big scenes the split traversal tables
(``v4_res``, ``v4_leaf``).  Every table the JAX package also packs is
byte-equal to it (``tests/test_torch_scene.py``, ``test_torch_split.py``,
``test_torch_envmap.py``); the env alias indices are int64 here, value-equal
to the JAX package's exact float values.  The threaded skip-link BVH
(the seven ``node_*`` fields) and the leaf-ordered triangle soup that the
oracle walk (``ops/traverse.py``) reads are packed only on request:
``pack(threaded=True)``, or ``BUAS_TRAVERSAL=threaded`` at pack time.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..core import vec
from ..core.device import resolve_device
from ..core.sampler import Strategy
from ..core.vec import Affine, Vec3
from ..ops import bvh as bvh_mod
from ..utils import trace
from . import materials as mat_mod
from .camera import Camera, make_camera
from .mesh import Mesh

# primitive type codes (primitives.h:3-10)
PRIM_NONE = 0
PRIM_PLANE = 1
PRIM_SPHERE = 2
PRIM_BOX = 3
PRIM_MESH = 4
PRIM_CSG = 5


@dataclass(frozen=True)
class SceneSettings:
    """scene.h:64-82.  A plain frozen dataclass: the port branches on these
    in Python, so disabled features cost nothing at run time."""

    next_event_estimation: bool = True
    importance_sample_lights: bool = True
    importance_sample_diffuse: bool = True
    use_mis: bool = True
    russian_roulette: bool = True
    caustics: bool = True
    sampling_strategy: int = Strategy.STRATIFIED
    vignette_strength: float = 0.25
    lens_distortion: float = 1.0
    f_factor: float = 0.0
    diaphragm_edges: float = 6.0
    phi_shutter_max: float = 0.5
    samples_per_pixel: int = 1
    max_bounce_count: int = 12
    integrator: str = "Advanced Pathtracer"
    # the reference's exact MIS arithmetic (integrators.cpp:660-669,
    # :757-768), kept as evidence: it does not converge to ground truth
    reference_mis: bool = False
    env_nee: bool = True
    whitted_true_split: bool = True


@dataclass(frozen=True)
class PostProcessSettings:
    """scene.h:84-90 + defaults from init_scene (raytracer.cpp:1444-1451)."""

    exposure: float = 0.0
    tonemapping: bool = True
    srgb_transform: bool = True
    midpoint: float = 0.5
    contrast: float = 0.0
    dither: bool = True


class PackedScene(NamedTuple):
    """Device-resident scene; every tensor on one device.  Zero-size
    categories are padded to length >= 1 (an unhittable plane, a null prim,
    a dummy light masked by the caller's ``n_lights``)."""

    # materials, SoA over M entries (index 0: air, ior 1, medium)
    mat_flags: torch.Tensor  # (M,) int32
    mat_albedo: Vec3
    mat_checker: Vec3
    mat_emission: Vec3
    mat_ior: torch.Tensor
    mat_metallic: torch.Tensor
    mat_roughness: torch.Tensor
    mat_is_medium: torch.Tensor  # (M,) bool
    mat_absorb: Vec3
    # (M,16) rows [albedo3 | emission3 | absorb3 | checker3 | ior, metallic,
    # roughness, code] with code = flags + 8*is_medium (exact small ints)
    mat16: torch.Tensor

    # planes (P >= 1)
    plane_n: Vec3
    plane_d: torch.Tensor
    plane_mat: torch.Tensor  # (P,) int64

    # non-plane primitives (K >= 1)
    prim_type: torch.Tensor  # (K,) int64
    prim_mat: torch.Tensor  # (K,) int64
    prim_fwd: torch.Tensor  # (K,12) row-major (3,4) forward
    prim_inv: torch.Tensor  # (K,12) inverse
    prim_r: torch.Tensor  # (K,) sphere radius
    prim_box_r: Vec3  # box half extents
    prim_nrm16: torch.Tensor  # (K,16) [inverse12 | box_r3 | type]

    # lights (L >= 1)
    light_prim: torch.Tensor  # (L,) int64 index into primitives
    light16: torch.Tensor  # (L,16) [fwd12 | r | emission3]

    # 8-wide row BVH (ops/wide_bvh.py) and its per-triangle shading rows
    wide_rows: torch.Tensor  # (R, 64) float32
    wide_depth: int  # max wide-tree depth (stack bound for traversal)
    scene_lo: torch.Tensor  # (3,) world AABB of all non-plane geometry
    scene_hi: torch.Tensor
    wtri_nrm16: torch.Tensor  # (Tw,16) [na3 | nb3 | nc3 | ng3 | has_n | 0 0 0]

    # sky (float32 0-d tensors)
    sky_bot: Vec3
    sky_top: Vec3
    ambient_light: Vec3

    # equirect environment map, (1, 1, 3) zeros when the scene has none
    # (integrators/common.has_env), and its sampling tables (ops/envmap.py;
    # (1,)-sized placeholders without a map)
    env_pixels: torch.Tensor  # (He, We, 3) float32
    env_cdf_marginal: torch.Tensor  # (He+1,)
    env_cdf_conditional: torch.Tensor  # (He, We+1)
    env_alias_prob: torch.Tensor  # (K,) K = He*We
    env_alias_idx: torch.Tensor  # (K,) int64
    env_pdf_num: torch.Tensor  # (K,)

    # split traversal tables (ops/wide_bvh.split_for_dma), present when the
    # unified table exceeds packet.RESIDENT_TABLE_LIMIT_BYTES; the JAX
    # package's names
    v4_res: Optional[torch.Tensor] = None  # (Ri, 64) f32 resident rows
    v4_leaf: Optional[torch.Tensor] = None  # (L, 128) f32 merged leaf rows

    # the threaded skip-link BVH (ops/bvh.flatten_world_bvh) and the global
    # leaf-ordered triangle soup (object space) the oracle walk reads,
    # present when packed with threaded=True; the JAX package's names
    node_lo: Optional[Vec3] = None  # (N,) world boxes, padded by _Emitter.PAD
    node_hi: Optional[Vec3] = None
    node_miss: Optional[torch.Tensor] = None  # (N,) int32
    node_kind: Optional[torch.Tensor] = None  # (N,) int32
    node_first: Optional[torch.Tensor] = None  # (N,) int32
    node_count: Optional[torch.Tensor] = None  # (N,) int32
    node_inst: Optional[torch.Tensor] = None  # (N,) int32
    tri_a: Optional[Vec3] = None  # (T,) vertices
    tri_b: Optional[Vec3] = None
    tri_c: Optional[Vec3] = None
    tri_na: Optional[Vec3] = None  # per-vertex normals (zero if none)
    tri_nb: Optional[Vec3] = None
    tri_nc: Optional[Vec3] = None
    tri_has_n: Optional[torch.Tensor] = None  # (T,) bool

    @property
    def n_lights(self) -> int:
        return int(self.light_prim.shape[0])


def _affine_or_identity(t: Optional[Affine]) -> Affine:
    return t if t is not None else vec.identity()


@dataclass
class Scene:
    """Host-side scene under construction."""

    name: str = "unnamed"
    filter_name: str = "Mitchell Netravali"  # raytracer.cpp:1427
    camera: Camera = field(default_factory=make_camera)
    settings: SceneSettings = field(default_factory=SceneSettings)
    post_settings: PostProcessSettings = field(
        default_factory=PostProcessSettings)
    top_sky_color: tuple = (0.0, 0.0, 0.0)
    bot_sky_color: tuple = (0.0, 0.0, 0.0)
    ambient_light: tuple = (0.0, 0.0, 0.0)
    env_map: Optional[np.ndarray] = None  # (H, W, 3) float32 equirect

    materials: List[mat_mod.Material] = field(default_factory=list)
    planes: List[tuple] = field(default_factory=list)  # (n, d, mat_id)
    prims: List[dict] = field(default_factory=list)
    lights: List[int] = field(default_factory=list)
    meshes: List[Mesh] = field(default_factory=list)

    def __post_init__(self):
        if not self.materials:
            # slot 0: air -- ior 1, participating, no absorption; the advanced
            # integrator's material stack bottoms out here (:597-601)
            self.materials.append(
                mat_mod.Material(ior=1.0, is_participating_medium=True))

    # -- materials ----------------------------------------------------------
    def add_material(self, m: mat_mod.Material) -> int:
        self.materials.append(m)
        return len(self.materials) - 1

    def add_diffuse_material(self, albedo, ior, roughness=0.0, checkers=False,
                             checker_color=(0.1, 0.1, 0.1)) -> int:
        return self.add_material(
            mat_mod.diffuse(albedo, ior, roughness, checkers, checker_color))

    def add_translucent_material(self, absorb, ior, roughness=0.0) -> int:
        return self.add_material(mat_mod.translucent(absorb, ior, roughness))

    def add_emissive_material(self, emission_color) -> int:
        return self.add_material(mat_mod.emissive(emission_color))

    # -- primitives ---------------------------------------------------------
    def add_plane(self, mat_id: int, n, d: float) -> int:
        nn = np.asarray(n, np.float64)
        nn = nn / np.linalg.norm(nn)
        self.planes.append((nn.astype(np.float32), float(d), int(mat_id)))
        return -(len(self.planes))  # planes get negative handles

    def _add_prim(self, ptype, mat_id, transform, **data) -> int:
        t = _affine_or_identity(transform)
        self.prims.append(dict(type=ptype, mat=int(mat_id), fwd=t.fwd,
                               inv=t.inv, **data))
        pid = len(self.prims) - 1
        if self.materials[mat_id].flags & mat_mod.FLAG_EMISSIVE:
            self.lights.append(pid)  # auto light registration (:92-96)
        return pid

    def add_sphere(self, mat_id: int, r: float,
                   transform: Optional[Affine] = None) -> int:
        return self._add_prim(PRIM_SPHERE, mat_id, transform, r=float(r))

    def add_box(self, mat_id: int, r, transform: Optional[Affine] = None) -> int:
        rr = np.asarray(r, np.float32)
        if rr.ndim == 0:
            rr = np.array([rr, rr, rr], np.float32)
        return self._add_prim(PRIM_BOX, mat_id, transform, box_r=rr)

    def add_mesh(self, mat_id: int, mesh: Mesh,
                 transform: Optional[Affine] = None) -> int:
        self.meshes.append(mesh)
        return self._add_prim(PRIM_MESH, mat_id, transform,
                              mesh_id=len(self.meshes) - 1)

    def add_csg_difference(self, mat_id: int, prim_a: int, prim_b: int,
                           transform: Optional[Affine] = None) -> int:
        """API stub for the reference's dormant CSG (add_test_difference,
        scene.cpp:161-171), which has no intersection branch: the
        primitive packs as PRIM_CSG with a zero AABB and is never hit."""
        return self._add_prim(PRIM_CSG, mat_id, transform,
                              csg_a=int(prim_a), csg_b=int(prim_b))

    # -- packing ------------------------------------------------------------
    def pack(self, device=None, bvh_method: str = "sah_binned",
             split: Optional[bool] = None,
             threaded: Optional[bool] = None) -> PackedScene:
        """``split`` None: build the split tables when the unified table's
        bytes exceed ``packet.RESIDENT_TABLE_LIMIT_BYTES``; True / False
        forces the choice (a scene whose root is a triangle leaf or empty
        never splits).  ``threaded`` None: pack the threaded BVH and the
        triangle soup when ``BUAS_TRAVERSAL=threaded``; True / False forces
        the choice.  The set-up phase ``scene_pack``, in three: ``.build``
        (the tables on the host), ``.split`` and ``.upload``."""
        with trace.phase("scene_pack"):
            dev = resolve_device(device)
            with trace.phase("scene_pack.build"):
                arrays = self._pack_arrays(bvh_method)
                if threaded is None:
                    threaded = os.environ.get("BUAS_TRAVERSAL") == "threaded"
                if threaded:
                    arrays.update(self._threaded_tables())
            with trace.phase("scene_pack.split"):
                arrays.update(_split_tables(arrays["wide_rows"], split))
            with trace.phase("scene_pack.upload"):
                return _to_device(arrays, dev)

    def _threaded_tables(self) -> Dict:
        """The threaded BVH and the triangle soup (JAX scene.py:337-358,
        :423-431), after ``_pack_arrays`` built the mesh BVHs."""
        tri_offsets, tri_v, tri_n, tri_has = [], [], [], []
        base = 0
        for mesh in self.meshes:
            tri_offsets.append(base)
            tri_v.append(np.asarray(mesh.triangles, np.float32))
            tri_n.append(np.asarray(mesh.normals, np.float32)
                         if mesh.has_normals else np.zeros_like(tri_v[-1]))
            tri_has.append(np.full(mesh.triangle_count, mesh.has_normals,
                                   bool))
            base += mesh.triangle_count
        if base == 0:
            tri_v = tri_n = [np.zeros((1, 3, 3), np.float32)]
            tri_has = [np.zeros(1, bool)]
        tv, tn = np.concatenate(tri_v), np.concatenate(tri_n)
        th = self._build_threaded(tri_offsets)
        return dict(
            node_lo=th.lo, node_hi=th.hi, node_miss=th.miss,
            node_kind=th.kind.astype(np.int32), node_first=th.first,
            node_count=th.count, node_inst=th.inst,
            tri_a=tv[:, 0], tri_b=tv[:, 1], tri_c=tv[:, 2],
            tri_na=tn[:, 0], tri_nb=tn[:, 1], tri_nc=tn[:, 2],
            tri_has_n=np.concatenate(tri_has))

    def _build_threaded(self, tri_offsets) -> bvh_mod.ThreadedBVH:
        """The TLAS over the world boxes of the real primitives, grafted
        with each mesh instance's subtree (JAX scene.py:511-545).  A mesh's
        object box is its BVH root's."""
        prims = self.prims or [dict(type=PRIM_NONE)]
        real = [i for i, p in enumerate(prims) if p["type"] != PRIM_NONE]
        if not real:
            return bvh_mod._Emitter().finish()
        item_lo = np.zeros((len(real), 3), np.float32)
        item_hi = np.zeros((len(real), 3), np.float32)
        pfwd = np.stack([p["fwd"].reshape(3, 4) for p in prims]
                        ).astype(np.float32)
        pmesh = np.array([p.get("mesh_id", -1) for p in prims], np.int32)
        for j, i in enumerate(real):
            p = prims[i]
            if p["type"] == PRIM_SPHERE:
                olo = np.full(3, -p["r"], np.float32)
                ohi = np.full(3, p["r"], np.float32)
            elif p["type"] == PRIM_BOX:
                br = np.asarray(p["box_r"], np.float32)
                olo, ohi = -br, br
            elif p["type"] == PRIM_MESH:
                b = self.meshes[pmesh[i]].bvh
                olo, ohi = b.lo[0], b.hi[0]
            else:
                olo = ohi = np.zeros(3, np.float32)
            item_lo[j], item_hi[j] = vec.transform_aabb(pfwd[i], olo, ohi)
        tlas = bvh_mod.build_bvh(item_lo, item_hi, method="sah_binned")
        return bvh_mod.flatten_world_bvh(
            tlas, np.array(real, np.int32), item_lo, item_hi, pfwd, pmesh,
            [m.bvh for m in self.meshes], tri_offsets)

    def _pack_arrays(self, bvh_method: str = "sah_binned") -> Dict:
        """The packed tables as numpy arrays (``pack`` moves them)."""
        n_mat = len(self.materials)
        mflags = np.zeros(n_mat, np.uint32)
        malb = np.zeros((n_mat, 3), np.float32)
        mchk = np.zeros((n_mat, 3), np.float32)
        memi = np.zeros((n_mat, 3), np.float32)
        mior = np.zeros(n_mat, np.float32)
        mmet = np.zeros(n_mat, np.float32)
        mrgh = np.zeros(n_mat, np.float32)
        mmed = np.zeros(n_mat, bool)
        mabs = np.zeros((n_mat, 3), np.float32)
        for i, m in enumerate(self.materials):
            mflags[i] = m.flags
            malb[i] = m.albedo
            mchk[i] = m.checker_color
            memi[i] = m.emission_color
            mior[i] = m.ior
            mmet[i] = m.metallic
            mrgh[i] = m.roughness
            mmed[i] = m.is_participating_medium
            mabs[i] = m.absorb

        # planes (padded to >= 1 with an unhittable plane)
        planes = self.planes or [(np.array([0, 1, 0], np.float32), -3.0e38, 0)]
        pn = np.stack([p[0] for p in planes])
        pd = np.array([p[1] for p in planes], np.float32)
        pm = np.array([p[2] for p in planes], np.int32)

        # primitives (padded to >= 1 with a null prim)
        prims = self.prims or [dict(type=PRIM_NONE, mat=0,
                                    fwd=vec.identity().fwd,
                                    inv=vec.identity().inv)]
        ptype = np.array([p["type"] for p in prims], np.int32)
        pmat = np.array([p["mat"] for p in prims], np.int32)
        pfwd = np.stack([p["fwd"].reshape(12) for p in prims]).astype(np.float32)
        pinv = np.stack([p["inv"].reshape(12) for p in prims]).astype(np.float32)
        pr = np.array([p.get("r", 0.0) for p in prims], np.float32)
        pboxr = np.stack([p.get("box_r", np.zeros(3, np.float32))
                          for p in prims]).astype(np.float32)
        pmesh = np.array([p.get("mesh_id", -1) for p in prims], np.int32)

        # per-mesh SAH build reorders each mesh's triangles into leaf order;
        # the wide build below reads them in that order
        for mesh in self.meshes:
            mesh.build_bvh(bvh_method)
        wide = self._build_wide(prims, ptype, pfwd, pinv, pr, pboxr, pmesh)

        lights = np.array(self.lights or [0], np.int32)
        return dict(**self._env_tables(),
            mat_flags=mflags, mat_albedo=malb, mat_checker=mchk,
            mat_emission=memi, mat_ior=mior, mat_metallic=mmet,
            mat_roughness=mrgh, mat_is_medium=mmed, mat_absorb=mabs,
            mat16=np.concatenate(
                [malb, memi, mabs, mchk, mior[:, None], mmet[:, None],
                 mrgh[:, None],
                 (mflags.astype(np.float32)
                  + 8.0 * mmed.astype(np.float32))[:, None]],
                axis=1).astype(np.float32),
            plane_n=pn, plane_d=pd, plane_mat=pm,
            prim_type=ptype, prim_mat=pmat, prim_fwd=pfwd, prim_inv=pinv,
            prim_r=pr, prim_box_r=pboxr,
            prim_nrm16=np.concatenate(
                [pinv.reshape(len(ptype), 12), pboxr.reshape(len(ptype), 3),
                 ptype.astype(np.float32)[:, None]], axis=1).astype(np.float32),
            light_prim=lights,
            light16=np.concatenate(
                [pfwd[lights].reshape(len(lights), 12), pr[lights][:, None],
                 memi[pmat[lights]]], axis=1).astype(np.float32),
            wide_rows=wide.rows, wide_depth=wide.depth,
            scene_lo=wide.scene_lo, scene_hi=wide.scene_hi,
            wtri_nrm16=np.concatenate(
                [wide.tri_na, wide.tri_nb, wide.tri_nc, wide.tri_ng,
                 wide.tri_has_n.astype(np.float32)[:, None],
                 np.zeros((len(wide.tri_has_n), 3), np.float32)],
                axis=1).astype(np.float32),
            sky_bot=np.array(self.bot_sky_color, np.float32),
            sky_top=np.array(self.top_sky_color, np.float32),
            ambient_light=np.array(self.ambient_light, np.float32),
        )

    def _env_tables(self) -> Dict:
        """The environment map and its sampling tables (JAX scene.py
        :370-382)."""
        if self.env_map is None:
            return dict(env_pixels=np.zeros((1, 1, 3), np.float32),
                        env_cdf_marginal=np.zeros(2, np.float32),
                        env_cdf_conditional=np.zeros((1, 2), np.float32),
                        env_alias_prob=np.ones(1, np.float32),
                        env_alias_idx=np.zeros(1, np.int64),
                        env_pdf_num=np.ones(1, np.float32))
        from ..ops.envmap import build_env_alias, build_env_cdf
        env = np.ascontiguousarray(np.asarray(self.env_map, np.float32))
        cdf_m, cdf_c = build_env_cdf(env)
        al_p, al_i, al_pdf = build_env_alias(env)
        return dict(env_pixels=env, env_cdf_marginal=cdf_m,
                    env_cdf_conditional=cdf_c, env_alias_prob=al_p,
                    env_alias_idx=al_i, env_pdf_num=al_pdf)

    def _build_wide(self, prims, ptype, pfwd, pinv, pr, pboxr, pmesh):
        from ..ops import wide_bvh
        real = [i for i, p in enumerate(prims) if p["type"] != PRIM_NONE]
        item_lo = np.zeros((max(len(real), 1), 3), np.float32)
        item_hi = np.zeros((max(len(real), 1), 3), np.float32)
        for j, i in enumerate(real):
            t = ptype[i]
            if t == PRIM_SPHERE:
                olo = np.full(3, -pr[i], np.float32)
                ohi = np.full(3, pr[i], np.float32)
            elif t == PRIM_BOX:
                olo, ohi = -pboxr[i], pboxr[i]
            elif t == PRIM_MESH:
                tv = np.asarray(self.meshes[pmesh[i]].triangles, np.float32)
                olo, ohi = tv.reshape(-1, 3).min(axis=0), tv.reshape(-1, 3).max(axis=0)
            else:
                olo = ohi = np.zeros(3, np.float32)
            item_lo[j], item_hi[j] = vec.transform_aabb(
                pfwd[i].reshape(3, 4), olo, ohi)
        return wide_bvh.build_wide_scene(
            ptype, pfwd.reshape(-1, 3, 4), pr, pinv.reshape(-1, 3, 4), pboxr,
            pmesh, self.meshes, real, item_lo, item_hi)

    @property
    def n_lights(self) -> int:
        return len(self.lights)

    @property
    def has_medium(self) -> bool:
        """True when a material that a primitive or plane uses is a
        participating medium: only then can the Whitted integrator split."""
        used = {p["mat"] for p in self.prims}
        used.update(m for (_, _, m) in self.planes)
        return any(self.materials[m].is_participating_medium for m in used)


# fields stored as Vec3: (X, 3) host arrays (or (3,) for the sky colours)
_VEC3_FIELDS = ("mat_albedo", "mat_checker", "mat_emission", "mat_absorb",
                "plane_n", "prim_box_r", "sky_bot", "sky_top",
                "ambient_light", "node_lo", "node_hi", "tri_a", "tri_b",
                "tri_c", "tri_na", "tri_nb", "tri_nc")
_INDEX_FIELDS = ("plane_mat", "prim_type", "prim_mat", "light_prim",
                 "env_alias_idx")


def _split_tables(rows: np.ndarray, split: Optional[bool]) -> Dict:
    """Counterpart of the JAX ``Scene._v4_split`` (scene.py:467-481), with
    the port's own residence limit in place of the TPU's VMEM budget."""
    from ..ops import packet, wide_bvh
    if split is None:
        split = rows.nbytes > packet.RESIDENT_TABLE_LIMIT_BYTES
    if not split or int(rows[0, 0]) not in (wide_bvh.KIND_INTERNAL,
                                           wide_bvh.KIND_PRIM):
        return {}
    res, leaf = wide_bvh.split_for_dma(rows)
    return {"v4_res": res, "v4_leaf": leaf}


def _to_device(arrays: Dict, dev: torch.device) -> PackedScene:
    out = {}
    for name in PackedScene._fields:
        a = arrays.get(name)
        if a is None and name in PackedScene._field_defaults:
            continue
        if name == "wide_depth":
            out[name] = int(a)
            continue
        a = np.asarray(a)
        if name in _VEC3_FIELDS:
            a = np.ascontiguousarray(a.astype(np.float32))
            out[name] = Vec3(*(torch.from_numpy(a[..., k].copy()).to(dev)
                               for k in range(3)))
        elif name in _INDEX_FIELDS:
            out[name] = torch.from_numpy(a.astype(np.int64)).to(dev)
        elif name == "mat_flags":
            out[name] = torch.from_numpy(a.astype(np.int32)).to(dev)
        else:
            out[name] = torch.from_numpy(np.array(a, order="C")).to(dev)
    return PackedScene(**out)


def from_jax_arrays(arrays: Dict[str, np.ndarray], device) -> PackedScene:
    """A ``PackedScene`` from the JAX package's packed tables as numpy.

    ``arrays`` maps the JAX ``PackedScene`` field names to numpy arrays, as
    ``{k: np.asarray(v) for k, v in jax_ps._asdict().items()}`` makes them:
    a Vec3 field arrives as a (3, ...) array, and ``wide_depth_arr`` carries
    the tree depth as its length.  The optional split tables may be absent;
    the threaded tables come across when present (the JAX package always
    packs them).  Fields the port does not use are ignored.
    The tests run both packages on identical tables this way."""
    dev = resolve_device(device)
    conv = {}
    for name in PackedScene._fields:
        if name == "wide_depth":
            conv[name] = int(np.asarray(arrays["wide_depth_arr"]).shape[0])
            continue
        if arrays.get(name) is None and name in PackedScene._field_defaults:
            continue
        a = np.asarray(arrays[name])
        if name in _VEC3_FIELDS:
            a = np.moveaxis(a, 0, -1)  # (3, ...) -> (..., 3)
        conv[name] = a
    return _to_device(conv, dev)
