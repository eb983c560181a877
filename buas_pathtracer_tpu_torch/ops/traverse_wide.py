"""Scene queries over the wide row BVH: closest hit with deferred normals,
and occlusion.

Counterpart of ``buas_pathtracer_tpu/ops/traverse_wide.py``
(``intersect_scene`` :615-749, ``intersect_shadow_ray`` :606).  Every wave
goes through ``dispatch.walk`` (the natural route) to
``packet.split_traverse`` when the scene packed split tables
(``ps.v4_res``) and to ``packet.wide_traverse`` otherwise (the CUDA kernel
on the card, its plain version on the CPU); the JAX package's choice
between its grouped and lockstep kernels is a TPU schedule and has no
counterpart.  Planes are tested linearly first; normals are computed
once from the winning hit (reference intersection.cpp:526-591).  The JAX
package gathers per-ray rows through one-hot matmuls and MXU transposes to
suit the TPU; here they are plain tensor indexing.

Every scene query of the integrators and the viewer comes through these two
functions, so they hold the ``BUAS_TRAVERSAL=threaded`` switch: it sends
the query to the threaded oracle walk of ``ops/traverse.py`` instead, as
the JAX package's ``ops/traverse.intersect_scene`` does.
"""

from __future__ import annotations

import torch

from ..core.vec import Vec3, noz, where as vwhere
from ..models.scene import PRIM_SPHERE, PackedScene
from . import dispatch, traverse
from .traverse import BIG_T, Hit, _intersect_planes


def _traverse(ps: PackedScene, o: Vec3, d: Vec3, t0, ignored_prim,
              occlusion: bool):
    """One wave through the traversal kernel.  Returns (t, prim, tri, bv,
    bw, stats) with prim/tri as int64."""
    c = torch.Tensor.contiguous
    t, prim, tri, bv, bw, stats = dispatch.walk(
        ps, Vec3(c(o.x), c(o.y), c(o.z)), Vec3(c(d.x), c(d.y), c(d.z)),
        c(t0), ignored_prim.to(torch.int32).contiguous(), occlusion)
    return t, prim.to(torch.int64), tri.to(torch.int64), bv, bw, stats


def intersect_shadow_ray(ps: PackedScene, ray_o: Vec3, ray_d: Vec3, max_t,
                         ignored_prim):
    """Occlusion query (intersection.cpp:600-604). True if anything blocks."""
    if traverse.use_threaded():
        return traverse.intersect_shadow_ray_threaded(ps, ray_o, ray_d,
                                                      max_t, ignored_prim)
    t_pl, plane_idx = _intersect_planes(ps, ray_o, ray_d, max_t)
    _, prim, *_ = _traverse(ps, ray_o, ray_d, t_pl, ignored_prim,
                            occlusion=True)
    return (prim >= 0) | (plane_idx >= 0)


def intersect_scene(ps: PackedScene, ray_o: Vec3, ray_d: Vec3,
                    max_t=None, ignored_prim=None) -> Hit:
    """Full closest-hit query + deferred normal (intersection.cpp:606-610)."""
    if traverse.use_threaded():
        return traverse.intersect_scene_threaded(ps, ray_o, ray_d, max_t,
                                                 ignored_prim)
    t0 = torch.full_like(ray_o.x, BIG_T) if max_t is None else max_t
    if ignored_prim is None:
        ignored_prim = torch.full_like(t0, -1, dtype=torch.int64)

    t_pl, plane_idx = _intersect_planes(ps, ray_o, ray_d, t0)
    t, prim, tri, bv, bw, stats = _traverse(
        ps, ray_o, ray_d, t_pl, ignored_prim, occlusion=False)

    n_prims = int(ps.prim_type.shape[0])
    plane_won = (plane_idx >= 0) & (prim < 0)
    hit_id = torch.where(prim >= 0, prim,
                         torch.where(plane_won, n_prims + plane_idx, -1))
    hit_p = ray_o + ray_d * t

    # ---- deferred normal (":NormalCalculation", intersection.cpp:526-591) --
    primc = torch.clamp(prim, min=0)
    mT = ps.prim_nrm16[primc].T  # (16, N): inverse12 | box_r3 | type
    mi = [mT[i] for i in range(12)]
    ptypes = mT[15].to(torch.int64)

    def _pt(p):
        return Vec3(mi[0] * p.x + mi[1] * p.y + mi[2] * p.z + mi[3],
                    mi[4] * p.x + mi[5] * p.y + mi[6] * p.z + mi[7],
                    mi[8] * p.x + mi[9] * p.y + mi[10] * p.z + mi[11])

    def _vec(v):
        return Vec3(mi[0] * v.x + mi[1] * v.y + mi[2] * v.z,
                    mi[4] * v.x + mi[5] * v.y + mi[6] * v.z,
                    mi[8] * v.x + mi[9] * v.y + mi[10] * v.z)

    def _nrm(nn):  # inverse-transpose: transpose of the INVERSE 3x3
        return Vec3(mi[0] * nn.x + mi[4] * nn.y + mi[8] * nn.z,
                    mi[1] * nn.x + mi[5] * nn.y + mi[9] * nn.z,
                    mi[2] * nn.x + mi[6] * nn.y + mi[10] * nn.z)

    # sphere/box: object-space normal via inverse transform, back by inv-T
    os_hit_p = _pt(ray_o) + _vec(ray_d) * t
    rel = Vec3(os_hit_p.x / torch.clamp(mT[12], min=1e-30),
               os_hit_p.y / torch.clamp(mT[13], min=1e-30),
               os_hit_p.z / torch.clamp(mT[14], min=1e-30))
    ax_, ay_, az_ = torch.abs(rel.x), torch.abs(rel.y), torch.abs(rel.z)
    x_big = (ax_ >= ay_) & (ax_ >= az_)
    y_big = ~x_big & (ay_ >= az_)
    n_box = Vec3(torch.where(x_big, torch.sign(rel.x), 0.0),
                 torch.where(y_big, torch.sign(rel.y), 0.0),
                 torch.where(x_big | y_big, 0.0, torch.sign(rel.z)))
    n_ana = vwhere(ptypes == PRIM_SPHERE, os_hit_p, n_box)
    n_ana_world = noz(_nrm(n_ana))

    # mesh: world-space normals straight from the per-triangle rows
    nT = ps.wtri_nrm16[torch.clamp(tri, min=0)].T  # (16, N)
    bu = 1.0 - bv - bw
    na = Vec3(nT[0], nT[1], nT[2])
    nb = Vec3(nT[3], nT[4], nT[5])
    nc = Vec3(nT[6], nT[7], nT[8])
    n_smooth = noz(na * bu + nb * bv + nc * bw)
    n_geom = Vec3(nT[9], nT[10], nT[11])
    n_mesh = vwhere((nT[12] > 0.5) & (tri >= 0), n_smooth, n_geom)
    n_world = vwhere(tri >= 0, n_mesh, n_ana_world)

    plc = torch.clamp(plane_idx, min=0)
    n_plane = Vec3(ps.plane_n.x[plc], ps.plane_n.y[plc], ps.plane_n.z[plc])
    n_world = vwhere(plane_won, n_plane, n_world)

    mat_id = torch.where(prim >= 0, ps.prim_mat[primc],
                         torch.where(plane_won, ps.plane_mat[plc], 0))

    return Hit(t=t, hit_id=hit_id, mat_id=mat_id,
               tri=torch.where(prim >= 0, tri, -1),
               bary_v=bv, bary_w=bw, p=hit_p, n=n_world,
               node_visits=stats[0], tri_tests=stats[1])
