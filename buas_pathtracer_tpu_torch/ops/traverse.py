"""Query result type, the plane pass and the threaded oracle walk.

Counterpart of ``buas_pathtracer_tpu/ops/traverse.py``.  Planes live
outside the BVH and are tested linearly first (reference
intersection.cpp:424-433).

The threaded skip-link walk (``_traverse_bvh``, ``intersect_scene_threaded``,
``intersect_shadow_ray_threaded``) is the JAX package's XLA oracle: every
ray carries one node pointer over the threaded BVH (``ops/bvh.py``); a hit
internal node goes to ``i + 1``, anything else to its miss link, and the
batch steps in lockstep until every pointer is past the end.  It is plain
PyTorch on the card too (no kernel: the JAX package's is no Pallas kernel
either) and runs only when ``BUAS_TRAVERSAL=threaded`` asks for it
(``use_threaded``), on a scene packed with its tables
(``Scene.pack(threaded=True)``, or under that variable).  Rays go to object
space through the primitive's stored inverse with an unnormalised
direction, so t stays world-parameterised (intersection.cpp:403-409, 472);
shadow rays skip the sampled light by index and stop at the first hit;
normals come once from the winning hit (intersection.cpp:526-591).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..core.vec import (Vec3, cross, noz, normalize, transform_normal,
                        transform_point, transform_vector, where as vwhere)
from ..models.scene import PRIM_BOX, PRIM_SPHERE
from . import intersect
from .bvh import KIND_INTERNAL, KIND_PRIM, KIND_TRIS, MAX_LEAF_SIZE

BIG_T = 3.0e38


class Hit(NamedTuple):
    """Result of a closest-hit query (one entry per ray).  ``n`` is defined
    where ``hit_id >= 0``: on a lane that hit nothing the card's
    ``hit_record`` kernel writes (0, 0, 0) and the plain versions a normal
    of row 0, which no caller reads."""

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


def use_threaded() -> bool:
    """True when ``BUAS_TRAVERSAL=threaded`` asks for the threaded walk
    (read at call time; the JAX package's other values pick TPU kernels
    and mean nothing here)."""
    return os.environ.get("BUAS_TRAVERSAL") == "threaded"


def _gather_v3(v: Vec3, i) -> Vec3:
    return Vec3(v.x[i], v.y[i], v.z[i])


def _rows34(m):
    """(N, 12) gathered row-major (3,4) affines, one a ray -> a (3, 4, N)
    view, the matrix form the ``core.vec`` transforms index."""
    return m.reshape(-1, 3, 4).permute(1, 2, 0)


def _check_threaded(ps):
    if ps.node_miss is None:
        raise ValueError("the threaded walk needs the threaded tables: pack "
                         "the scene with threaded=True (or under "
                         "BUAS_TRAVERSAL=threaded)")


def _traverse_bvh(ps, ray_o: Vec3, ray_d: Vec3, t0, ignored_prim,
                  occlusion: bool):
    """The lockstep skip-link walk (the JAX package's traverse.py:107-192).
    Returns (t, prim, tri, bv, bw, node visits, triangle tests), prim and
    tri int64, the stats 0-d int64."""
    _check_threaded(ps)
    n_nodes = int(ps.node_miss.shape[0])
    n_tris = int(ps.tri_has_n.shape[0])
    dev, shape = t0.device, t0.shape
    inv_d = intersect.safe_inv_dir(ray_d)
    ptr = torch.zeros(shape, dtype=torch.int64, device=dev)
    t = t0.clone()
    prim = torch.full(shape, -1, dtype=torch.int64, device=dev)
    tri = torch.full(shape, -1, dtype=torch.int64, device=dev)
    bv = torch.zeros(shape, dtype=torch.float32, device=dev)
    bw = torch.zeros(shape, dtype=torch.float32, device=dev)
    nv = torch.zeros((), dtype=torch.int64, device=dev)
    tt = torch.zeros((), dtype=torch.int64, device=dev)
    while bool((ptr < n_nodes).any()):
        i = torch.clamp(ptr, max=n_nodes - 1)
        active = ptr < n_nodes
        bv_hit = intersect.aabb_minmax(
            ray_o, inv_d, _gather_v3(ps.node_lo, i),
            _gather_v3(ps.node_hi, i), t) & active
        kind = ps.node_kind[i]
        first = ps.node_first[i].to(torch.int64)
        count = ps.node_count[i].to(torch.int64)
        node_inst = ps.node_inst[i].to(torch.int64)
        inst = torch.clamp(node_inst, min=0)
        internal = kind == KIND_INTERNAL
        do_leaf = bv_hit & ~internal
        not_ignored = node_inst != ignored_prim

        # object-space ray of this node's instance (the rows gathered for
        # TLAS internals are never used: the leaf kinds gate the results)
        m_inv = _rows34(ps.prim_inv[inst])
        os_o = transform_point(m_inv, ray_o)
        os_d = transform_vector(m_inv, ray_d)

        # ---- analytic primitive leaf ----
        is_prim = do_leaf & (kind == KIND_PRIM) & not_ignored
        hs, ts_ = intersect.sphere(os_o, os_d, ps.prim_r[inst], t)
        hb, tb_ = intersect.box(os_o, os_d, _gather_v3(ps.prim_box_r, inst),
                                t)
        sph = ps.prim_type[inst] == PRIM_SPHERE
        prim_hit = is_prim & torch.where(sph, hs, hb)
        t = torch.where(prim_hit, torch.where(sph, ts_, tb_), t)
        prim = torch.where(prim_hit, first, prim)
        tri = torch.where(prim_hit, -1, tri)

        # ---- triangle leaf (<= MAX_LEAF_SIZE consecutive triangles) ----
        is_tri = do_leaf & (kind == KIND_TRIS) & not_ignored
        any_tri_hit = torch.zeros_like(is_tri)
        for lane in range(MAX_LEAF_SIZE):
            ti = torch.clamp(first + lane, max=n_tris - 1)
            h, t_new, _, v_, w_ = intersect.triangle(
                os_o, os_d, _gather_v3(ps.tri_a, ti),
                _gather_v3(ps.tri_b, ti), _gather_v3(ps.tri_c, ti), t)
            h = h & is_tri & (lane < count)
            t = torch.where(h, t_new, t)
            prim = torch.where(h, inst, prim)
            tri = torch.where(h, ti, tri)
            bv = torch.where(h, v_, bv)
            bw = torch.where(h, w_, bw)
            any_tri_hit = any_tri_hit | h

        nv = nv + active.sum()
        tt = tt + torch.where(is_tri, torch.clamp(count, max=MAX_LEAF_SIZE),
                              0).sum()

        # advance: internal hit -> i + 1, else the miss link; finished
        # rays stay put, and an occlusion ray stops at its first hit
        nxt = torch.where(bv_hit & internal, i + 1,
                          ps.node_miss[i].to(torch.int64))
        nxt = torch.where(active, nxt, ptr)
        if occlusion:
            nxt = torch.where(prim_hit | any_tri_hit, n_nodes, nxt)
        ptr = nxt
    return t, prim, tri, bv, bw, nv, tt


def intersect_shadow_ray_threaded(ps, ray_o: Vec3, ray_d: Vec3, max_t,
                                  ignored_prim):
    """Occlusion over the threaded walk. True if anything blocks."""
    t_pl, plane_idx = _intersect_planes(ps, ray_o, ray_d, max_t)
    _, prim, *_ = _traverse_bvh(ps, ray_o, ray_d, t_pl, ignored_prim,
                                occlusion=True)
    return (prim >= 0) | (plane_idx >= 0)


def intersect_scene_threaded(ps, ray_o: Vec3, ray_d: Vec3, max_t=None,
                             ignored_prim=None) -> Hit:
    """Closest hit over the threaded walk, with the deferred normal (the
    JAX package's traverse.py:243-321)."""
    t0 = torch.full_like(ray_o.x, BIG_T) if max_t is None else max_t
    if ignored_prim is None:
        ignored_prim = torch.full_like(t0, -1, dtype=torch.int64)
    t_pl, plane_idx = _intersect_planes(ps, ray_o, ray_d, t0)
    t, prim, tri, bv, bw, nv, tt = _traverse_bvh(
        ps, ray_o, ray_d, t_pl, ignored_prim, occlusion=False)

    n_prims = int(ps.prim_type.shape[0])
    plane_won = (plane_idx >= 0) & (prim < 0)
    hit_id = torch.where(prim >= 0, prim,
                         torch.where(plane_won, n_prims + plane_idx, -1))

    # ---- deferred normal (":NormalCalculation") ----
    primc = torch.clamp(prim, min=0)
    m_inv = _rows34(ps.prim_inv[primc])
    os_hit_p = (transform_point(m_inv, ray_o)
                + transform_vector(m_inv, ray_d) * t)
    hit_p = ray_o + ray_d * t
    ptypes = ps.prim_type[primc]

    # box: the sign of the largest |component| of os_hit_p / box_r
    box_r = _gather_v3(ps.prim_box_r, primc)
    rel = Vec3(os_hit_p.x / torch.clamp(box_r.x, min=1e-30),
               os_hit_p.y / torch.clamp(box_r.y, min=1e-30),
               os_hit_p.z / torch.clamp(box_r.z, min=1e-30))
    ax_, ay_, az_ = torch.abs(rel.x), torch.abs(rel.y), torch.abs(rel.z)
    x_big = (ax_ >= ay_) & (ax_ >= az_)
    y_big = ~x_big & (ay_ >= az_)
    n_box = Vec3(torch.where(x_big, torch.sign(rel.x), 0.0),
                 torch.where(y_big, torch.sign(rel.y), 0.0),
                 torch.where(x_big | y_big, 0.0, torch.sign(rel.z)))

    # mesh: smooth normal from the barycentrics if present, else geometric
    tric = torch.clamp(tri, min=0)
    bu = 1.0 - bv - bw
    n_smooth = (_gather_v3(ps.tri_na, tric) * bu
                + _gather_v3(ps.tri_nb, tric) * bv
                + _gather_v3(ps.tri_nc, tric) * bw)
    a = _gather_v3(ps.tri_a, tric)
    n_geom = cross(normalize(_gather_v3(ps.tri_b, tric) - a),
                   normalize(_gather_v3(ps.tri_c, tric) - a))
    n_mesh = vwhere(ps.tri_has_n[tric] & (tri >= 0), n_smooth, n_geom)

    # sphere: the object-space hit point is the normal's direction
    n_obj = vwhere(ptypes == PRIM_SPHERE, os_hit_p,
                   vwhere(ptypes == PRIM_BOX, n_box, n_mesh))
    n_world = noz(transform_normal(m_inv, n_obj))
    plc = torch.clamp(plane_idx, min=0)
    n_world = vwhere(plane_won, _gather_v3(ps.plane_n, plc), n_world)
    mat_id = torch.where(prim >= 0, ps.prim_mat[primc],
                         torch.where(plane_won, ps.plane_mat[plc], 0))
    return Hit(t=t, hit_id=hit_id, mat_id=mat_id,
               tri=torch.where(prim >= 0, tri, -1), bary_v=bv, bary_w=bw,
               p=hit_p, n=n_world, node_visits=nv, tri_tests=tt)
