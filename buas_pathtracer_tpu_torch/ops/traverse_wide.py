"""Scene queries over the wide row BVH: closest hit with deferred normals,
and occlusion.

Counterpart of ``buas_pathtracer_tpu/ops/traverse_wide.py``
(``intersect_scene`` :615-749, ``intersect_shadow_ray`` :606).  Every wave
goes through ``_walk``, in the caller's order, to ``packet.split_traverse``
when the scene packed split tables (``ps.v4_res``) and to
``packet.wide_traverse`` otherwise (the CUDA kernel on the card, its plain
version on the CPU); the JAX package's sort keys, compaction and choice
between its grouped and lockstep kernels are a TPU schedule and have no
counterpart: the walk kernels fetch live rays themselves.  Planes are
tested linearly first; normals are computed once from the winning hit
(reference intersection.cpp:526-591), in the hit record of
``ops/hit_kernel.py``.  The JAX package gathers per-ray rows
through one-hot matmuls and MXU transposes to suit the TPU; on the card
the ``hit_record`` kernel reads one row a lane, and on the CPU the plain
version indexes tensors.

Every scene query of the integrators and the viewer comes through these
functions (``occlusion_walk`` takes the card's NEE wave, whose plane pass
``nee_sample`` did), so they hold the ``BUAS_TRAVERSAL=threaded`` switch:
it sends the query to the threaded oracle walk of ``ops/traverse.py``
instead, as the JAX package's ``ops/traverse.intersect_scene`` does.
"""

from __future__ import annotations

import torch

from ..core.vec import Vec3
from ..models.scene import PackedScene
from . import hit_kernel, packet, traverse
from .traverse import BIG_T, Hit, _intersect_planes


def _contiguous(v: Vec3) -> Vec3:
    return Vec3(*(x.contiguous() for x in v))


def _walk(ps: PackedScene, o: Vec3, d: Vec3, t0, ignored_prim,
          occlusion: bool):
    """One wave (``o``, ``d`` contiguous) through the scene's traversal
    kernel.  Returns its outputs (t, prim, tri, bv, bw, stats), prim/tri
    int32.  The kernels are looked up on ``packet`` at each call, so a
    patched ``packet.wide_traverse`` / ``split_traverse`` sees every
    wave."""
    t0 = t0.contiguous()
    ign = ignored_prim.to(torch.int32).contiguous()
    if ps.v4_res is not None:
        return packet.split_traverse(ps.v4_res, ps.v4_leaf, ps.wide_depth,
                                     o, d, t0, ign, occlusion)
    return packet.wide_traverse(ps.wide_rows, ps.wide_depth, o, d, t0, ign,
                                occlusion)


def _traverse(ps: PackedScene, o: Vec3, d: Vec3, t0, ignored_prim,
              occlusion: bool):
    """One wave through the traversal kernel.  Returns (t, prim, tri, bv,
    bw, stats) with prim/tri as int64."""
    t, prim, tri, bv, bw, stats = _walk(ps, _contiguous(o), _contiguous(d),
                                        t0, ignored_prim, occlusion)
    return t, prim.to(torch.int64), tri.to(torch.int64), bv, bw, stats


def occlusion_walk(ps: PackedScene, o: Vec3, d: Vec3, t0, ignored_prim):
    """The occlusion walk of a wave whose plane pass is done (``t0``
    shortened by it; ``o``, ``d`` and ``t0`` contiguous, as ``nee_sample``
    leaves them): the walk's prim, int32 (>= 0: a primitive blocks the
    query).  ``BUAS_TRAVERSAL=threaded`` sends the wave to the threaded
    walk."""
    if traverse.use_threaded():
        _, prim, *_ = traverse._traverse_bvh(ps, o, d, t0, ignored_prim,
                                             occlusion=True)
        return prim.to(torch.int32)
    return _walk(ps, o, d, t0, ignored_prim, occlusion=True)[1]


def intersect_shadow_ray(ps: PackedScene, ray_o: Vec3, ray_d: Vec3, max_t,
                         ignored_prim):
    """Occlusion query (intersection.cpp:600-604). True if anything blocks."""
    t_pl, plane_idx = _intersect_planes(ps, ray_o, ray_d, max_t)
    prim = occlusion_walk(ps, _contiguous(ray_o), _contiguous(ray_d), t_pl,
                          ignored_prim)
    return (prim >= 0) | (plane_idx >= 0)


def intersect_scene(ps: PackedScene, ray_o: Vec3, ray_d: Vec3,
                    max_t=None, ignored_prim=None) -> Hit:
    """Full closest-hit query + deferred normal (intersection.cpp:606-610):
    the plane pass, the walk, and the hit record (``ops/hit_kernel.py``:
    one kernel launch on the card, ``hit_record_plain`` on the CPU)."""
    if traverse.use_threaded():
        return traverse.intersect_scene_threaded(ps, ray_o, ray_d, max_t,
                                                 ignored_prim)
    t0 = torch.full_like(ray_o.x, BIG_T) if max_t is None else max_t
    if ignored_prim is None:
        ignored_prim = torch.full_like(t0, -1, dtype=torch.int64)

    t_pl, plane_idx = _intersect_planes(ps, ray_o, ray_d, t0)
    if t_pl.device.type == "cuda":
        o, d = _contiguous(ray_o), _contiguous(ray_d)
        walked = _walk(ps, o, d, t_pl, ignored_prim, occlusion=False)
        return hit_kernel.hit_record(ps, o, d, plane_idx, *walked)
    walked = _traverse(ps, ray_o, ray_d, t_pl, ignored_prim, occlusion=False)
    return hit_kernel.hit_record_plain(ps, ray_o, ray_d, plane_idx, *walked)
