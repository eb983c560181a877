"""The hit record of a closest-hit query (``csrc/hit.cu``).

``ops/traverse_wide.py``'s ``intersect_scene`` walks the wave, then builds
its ``traverse.Hit`` record: the hit id, material id and triangle, the hit
point and the deferred normal (reference intersection.cpp:526-591).  For
CUDA tensors that is ``hit_record``, one launch of the ``hit_record``
kernel on PyTorch's current stream, which never synchronises; for CPU
tensors it is ``hit_record_plain``, the same record in PyTorch, which the
CPU tests hold to the JAX package.  The wrapper raises for any other
device and never falls back.

Both take the rays, the plane pass's winner (``plane_idx``, int64) and the
walk's outputs (t, prim, tri, bary v and w, stats); the kernel reads prim
and tri as the walk wrote them (int32), the plain version as int64.  On the
card they agree bit for bit on every field of every lane, but for the
normal of a lane that hit nothing (``Hit``'s docstring).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.vec import Vec3, noz, where as vwhere
from ..models.scene import PRIM_SPHERE
from ..utils import trace
from . import cuda_lib
from .cuda_lib import vec_lanes as _vec, vec_ptrs as _ptrs
from .traverse import Hit

F32, I32, I64 = torch.float32, torch.int32, torch.int64
_P, _I = ctypes.c_void_p, ctypes.c_int64


class HitArgs(ctypes.Structure):
    """``hit::Args`` of csrc/hit.cuh, field for field."""

    _fields_ = [("n", _I), ("n_prims", _I), ("o", _P * 3), ("d", _P * 3),
                ("t", _P), ("bv", _P), ("bw", _P), ("prim", _P), ("tri", _P),
                ("plane_idx", _P), ("prim_nrm16", _P), ("wtri_nrm16", _P),
                ("plane_n", _P * 3), ("prim_mat", _P), ("plane_mat", _P),
                ("hit_id", _P), ("mat_id", _P), ("hit_tri", _P),
                ("p", _P * 3), ("nrm", _P * 3)]


_ARGS_CHECKED = False


def record_args(ps, o: Vec3, d: Vec3, plane_idx, t, prim, tri, bv, bw):
    """The kernel's checked arguments and its new outputs: (3, N) int64
    rows (hit id, material id, triangle) and (6, N) float32 rows (point,
    normal)."""
    n, dev = int(t.shape[0]), t.device
    cuda_lib.check_lanes(n, dev, _vec("o", o) + _vec("d", d) + [
        ("t", t, F32), ("bv", bv, F32), ("bw", bw, F32), ("prim", prim, I32),
        ("tri", tri, I32), ("plane_idx", plane_idx, I64)])
    K, P = int(ps.prim_type.shape[0]), int(ps.plane_mat.shape[0])
    for name, x, dt, shape in (
            ("prim_nrm16", ps.prim_nrm16, F32, (K, 16)),
            ("wtri_nrm16", ps.wtri_nrm16, F32, (None, 16)),
            ("prim_mat", ps.prim_mat, I64, (K,)),
            ("plane_mat", ps.plane_mat, I64, (P,))):
        cuda_lib.check_table(name, x, dt, shape, dev)
    for name in ("prim_nrm16", "wtri_nrm16"):  # read in 16-byte loads
        if getattr(ps, name).data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    for c, x in zip("xyz", ps.plane_n):
        cuda_lib.check_table(f"plane_n.{c}", x, F32, (P,), dev)
    ints = torch.empty((3, n), dtype=I64, device=dev)
    floats = torch.empty((6, n), dtype=F32, device=dev)
    args = HitArgs(
        n=n, n_prims=K, o=_ptrs(o), d=_ptrs(d), t=t.data_ptr(),
        bv=bv.data_ptr(), bw=bw.data_ptr(), prim=prim.data_ptr(),
        tri=tri.data_ptr(), plane_idx=plane_idx.data_ptr(),
        prim_nrm16=ps.prim_nrm16.data_ptr(),
        wtri_nrm16=ps.wtri_nrm16.data_ptr(), plane_n=_ptrs(ps.plane_n),
        prim_mat=ps.prim_mat.data_ptr(), plane_mat=ps.plane_mat.data_ptr(),
        hit_id=ints[0].data_ptr(), mat_id=ints[1].data_ptr(),
        hit_tri=ints[2].data_ptr(), p=_ptrs(floats[0:3]),
        nrm=_ptrs(floats[3:6]))
    return args, (ints, floats)


def as_hit(t, bv, bw, stats, outputs) -> Hit:
    """The ``Hit`` of the kernel's outputs (``record_args``)."""
    ints, floats = outputs
    return Hit(t=t, hit_id=ints[0], mat_id=ints[1], tri=ints[2], bary_v=bv,
               bary_w=bw, p=Vec3(*floats[0:3]), n=Vec3(*floats[3:6]),
               node_visits=stats[0], tri_tests=stats[1])


def _lib():
    """The kernel library, its ``hit::Args`` checked against ``HitArgs``
    once."""
    global _ARGS_CHECKED
    lib = cuda_lib.load()
    if not _ARGS_CHECKED:
        size = lib.hit_args_size()
        if size != ctypes.sizeof(HitArgs):
            raise RuntimeError(f"hit::Args is {size} bytes, HitArgs "
                               f"{ctypes.sizeof(HitArgs)}")
        _ARGS_CHECKED = True
    return lib


def hit_record(ps, o: Vec3, d: Vec3, plane_idx, t, prim, tri, bv, bw,
               stats) -> Hit:
    """The record of a walked wave on the card: ``o``, ``d`` the rays the
    walk read, ``plane_idx`` the plane pass's winner (-1 for none), t,
    prim, tri (int32), bv, bw and stats the walk's outputs."""
    args, outputs = record_args(ps, o, d, plane_idx, t, prim, tri, bv, bw)
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"no hit_record for device {dev}: the plain "
                         f"version (hit_record_plain) serves the CPU")
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hit_record_launch(ctypes.addressof(args), stream)
    cuda_lib.check(rc, "hit_record")
    trace.launch("hit_record")
    return as_hit(t, bv, bw, stats, outputs)


def hit_record_plain(ps, ray_o: Vec3, ray_d: Vec3, plane_idx, t, prim, tri,
                     bv, bw, stats) -> Hit:
    """``hit_record`` in PyTorch, prim and tri int64: every candidate
    normal of every lane from its rows (clamped to row 0 where it has
    none), then the one its hit selects."""
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
