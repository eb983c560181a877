"""Wide-BVH traversal: the kernel wrapper and its plain PyTorch version.

Counterpart of the kernel side of ``buas_pathtracer_tpu/ops/pallas_packet.py``
(``_kernel_v2`` and the grouped ``_kernel_v5``; both compute this function).
``wide_traverse`` launches ``csrc/wide_traverse.cu`` for CUDA tensors and
runs ``wide_traverse_plain`` for CPU tensors; there is no fallback from one
to the other.  The JAX package's Morton compaction, root prefilter and
routing ladder are TPU scheduling and are not ported (ROADMAP.md, queue 1).

Both versions walk each ray with its own stack, in the same order, with the
same arithmetic (the kernel is built with ``-fmad=false``), so on one device
they return the same hits; the rules are listed in the kernel source.
Outputs: t (float32), prim, tri (int32), bary v, w (float32), and a (2,)
int64 tensor of [node visits, triangle tests] summed over the rays.
"""

from __future__ import annotations

import torch

from ..core.vec import Vec3
from . import cuda_lib, intersect
from .wide_bvh import (KIND_INTERNAL, KIND_PRIM, KIND_TRIS, ROW_W, WIDE,
                       WIDE_LEAF)

STACK = 128  # per-ray stack capacity of the kernel (csrc/wide_traverse.cu)
BIG_T = 1e30  # in-kernel child-key sentinel (pallas_packet.BIG_T)
PRIM_SPHERE = 2

# launches per instantiation, counted where the kernel is launched
LAUNCHES = {"closest": 0, "occlusion": 0}


def stack_fits(depth: int) -> bool:
    """A per-ray walk holds at most (WIDE-1) deferred children per level
    plus the current node (pallas_packet.stack_fits, :1657)."""
    return depth * (WIDE - 1) + 1 <= STACK


def _check(rows, o: Vec3, d: Vec3, t0, ign, depth: int):
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != ROW_W:
        raise ValueError(f"rows must be float32 (R, {ROW_W}), got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if not stack_fits(depth):
        raise ValueError(f"tree depth {depth} needs a stack of "
                         f"{depth * (WIDE - 1) + 1} > {STACK}")
    n = t0.shape[0]
    named = [("rows", rows), ("o.x", o.x), ("o.y", o.y), ("o.z", o.z),
             ("d.x", d.x), ("d.y", d.y), ("d.z", d.z), ("t0", t0),
             ("ign", ign)]
    for name, x in named:
        if x.device != rows.device:
            raise ValueError(f"{name} on {x.device}, rows on {rows.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "rows":
            want = torch.int32 if name == "ign" else torch.float32
            if x.dtype != want or tuple(x.shape) != (n,):
                raise ValueError(f"{name} must be {want} ({n},), got "
                                 f"{x.dtype} {tuple(x.shape)}")


def wide_traverse(rows, depth: int, o: Vec3, d: Vec3, t0, ign,
                  occlusion: bool):
    """Closest-hit (or, with ``occlusion``, first-hit) walk of the row table.

    rows (R, 64) float32; o, d Vec3 of (N,) float32; t0 (N,) float32 (lanes
    with t0 < 0 pass through); ign (N,) int32 prim to ignore (-1: none)."""
    _check(rows, o, d, t0, ign, depth)
    if rows.device.type == "cpu":
        return wide_traverse_plain(rows, depth, o, d, t0, ign, occlusion)
    if rows.device.type != "cuda":
        raise ValueError(f"no wide_traverse for device {rows.device}")
    lib = cuda_lib.load()
    if lib.wide_traverse_max_stack() != STACK:
        raise RuntimeError("csrc/wide_traverse.cu STACK differs from "
                           "ops/packet.py STACK")
    n = t0.shape[0]
    dev = rows.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    bv = torch.empty(n, dtype=torch.float32, device=dev)
    bw = torch.empty(n, dtype=torch.float32, device=dev)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wide_traverse_launch(
            rows.data_ptr(), n, o.x.data_ptr(), o.y.data_ptr(),
            o.z.data_ptr(), d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
            t0.data_ptr(), ign.data_ptr(), int(bool(occlusion)),
            t.data_ptr(), prim.data_ptr(), tri.data_ptr(), bv.data_ptr(),
            bw.data_ptr(), stats.data_ptr(), stream)
    cuda_lib.check(rc, "wide_traverse")
    LAUNCHES["occlusion" if occlusion else "closest"] += 1
    return t, prim, tri, bv, bw, stats


def wide_traverse_plain(rows, depth: int, o: Vec3, d: Vec3, t0, ign,
                        occlusion: bool):
    """Plain PyTorch version of the kernel: every ray keeps an (N, cap)
    stack; each iteration pops one entry per ray that still has one and
    gathers one 64-float row for each of them."""
    n = t0.shape[0]
    dev = t0.device
    cap = depth * (WIDE - 1) + 1
    inv = intersect.safe_inv_dir(d)
    ign = ign.to(torch.int64)
    t = t0.clone()
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bv = torch.zeros(n, dtype=torch.float32, device=dev)
    bw = torch.zeros(n, dtype=torch.float32, device=dev)
    stk_node = torch.zeros((n, cap), dtype=torch.int64, device=dev)
    stk_key = torch.zeros((n, cap), dtype=torch.float32, device=dev)
    sp = (t0 >= 0.0).to(torch.int64)  # live rays start with the root pushed
    visits = torch.zeros((), dtype=torch.int64, device=dev)
    tests = torch.zeros((), dtype=torch.int64, device=dev)

    while True:
        a = torch.nonzero(sp > 0).squeeze(1)
        if a.numel() == 0:
            break
        sp[a] -= 1
        spa = sp[a]
        keep = stk_key[a, spa] < t[a]  # entries entered before a nearer hit
        a = a[keep]
        if a.numel() == 0:
            continue
        row = rows[stk_node[a, spa[keep]]]
        visits += a.numel()
        kind = row[:, 0].to(torch.int64)
        oa = Vec3(o.x[a], o.y[a], o.z[a])
        da = Vec3(d.x[a], d.y[a], d.z[a])

        # ---- internal: 8 child slabs, push hit children farthest first ----
        m = kind == KIND_INTERNAL
        if m.any():
            r = row[m]
            ai = a[m]
            ia = Vec3(inv.x[ai][:, None], inv.y[ai][:, None],
                      inv.z[ai][:, None])
            oi = Vec3(oa.x[m][:, None], oa.y[m][:, None], oa.z[m][:, None])
            box = r[:, 2:2 + 6 * WIDE].reshape(-1, WIDE, 6)
            t1x = (box[..., 0] - oi.x) * ia.x
            t2x = (box[..., 3] - oi.x) * ia.x
            t1y = (box[..., 1] - oi.y) * ia.y
            t2y = (box[..., 4] - oi.y) * ia.y
            t1z = (box[..., 2] - oi.z) * ia.z
            t2z = (box[..., 5] - oi.z) * ia.z
            tn = torch.maximum(torch.maximum(torch.minimum(t1x, t2x),
                                             torch.minimum(t1y, t2y)),
                               torch.minimum(t1z, t2z))
            tf = torch.minimum(torch.minimum(torch.maximum(t1x, t2x),
                                             torch.maximum(t1y, t2y)),
                               torch.maximum(t1z, t2z))
            k = torch.clamp(tn, min=0.0)
            h = (tn < tf) & (tf > 0.0) & (tn < t[ai][:, None]) & (k < BIG_T)
            key = torch.where(h, k, float("inf"))
            skey, order = torch.sort(key, dim=1, stable=True)  # ties: slot
            n_hit = h.sum(dim=1)
            base = r[:, 1].to(torch.int64)
            sp_i = sp[ai]
            for j in range(WIDE):
                mj = j < n_hit
                at = (sp_i + n_hit - 1 - j)[mj]
                stk_node[ai[mj], at] = base[mj] + order[mj, j]
                stk_key[ai[mj], at] = skey[mj, j]
            sp[ai] = sp_i + n_hit

        # ---- triangle leaf: up to 6 world-space triangles, in slot order ----
        m = (kind == KIND_TRIS) & (row[:, 3].to(torch.int64) != ign[a])
        if m.any():
            r = row[m]
            al = a[m]
            count = r[:, 1].to(torch.int64)
            tri_base = r[:, 2].to(torch.int64)
            inst = r[:, 3].to(torch.int64)
            tests += torch.clamp(count, max=WIDE_LEAF).sum()
            ol = Vec3(oa.x[m], oa.y[m], oa.z[m])
            dl = Vec3(da.x[m], da.y[m], da.z[m])
            tl, pl, trl = t[al], prim[al], tri[al]
            bvl, bwl = bv[al], bw[al]
            any_hit = torch.zeros_like(count, dtype=torch.bool)
            for kk in range(WIDE_LEAF):
                s = 8 + 9 * kk
                ax, ay, az = r[:, s], r[:, s + 1], r[:, s + 2]
                e1x, e1y, e1z = r[:, s + 3], r[:, s + 4], r[:, s + 5]
                e2x, e2y, e2z = r[:, s + 6], r[:, s + 7], r[:, s + 8]
                pvx = dl.y * e2z - dl.z * e2y
                pvy = dl.z * e2x - dl.x * e2z
                pvz = dl.x * e2y - dl.y * e2x
                det = e1x * pvx + e1y * pvy + e1z * pvz
                ok = (det <= -intersect.TRI_EPS) | (det >= intersect.TRI_EPS)
                inv_det = 1.0 / torch.where(ok, det, 1.0)
                tvx, tvy, tvz = ol.x - ax, ol.y - ay, ol.z - az
                v_ = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
                ok = ok & (v_ >= 0.0) & (v_ <= 1.0)
                qvx = tvy * e1z - tvz * e1y
                qvy = tvz * e1x - tvx * e1z
                qvz = tvx * e1y - tvy * e1x
                w_ = (dl.x * qvx + dl.y * qvy + dl.z * qvz) * inv_det
                ok = ok & (w_ >= 0.0) & (v_ + w_ <= 1.0)
                t_new = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
                ok = ok & (t_new >= intersect.TRI_EPS) & (tl >= t_new) \
                    & (kk < count)
                tl = torch.where(ok, t_new, tl)
                pl = torch.where(ok, inst, pl)
                trl = torch.where(ok, tri_base + kk, trl)
                bvl = torch.where(ok, v_, bvl)
                bwl = torch.where(ok, w_, bwl)
                any_hit = any_hit | ok
            t[al], prim[al], tri[al], bv[al], bw[al] = tl, pl, trl, bvl, bwl
            if occlusion:
                sp[al[any_hit]] = 0

        # ---- analytic prim: sphere / box through the inline inverse ----
        m = kind == KIND_PRIM
        if m.any():
            r = row[m]
            ap = a[m]
            prim_id = r[:, 1].to(torch.int64)
            ptype = r[:, 2].to(torch.int64)
            mi = [r[:, 4 + q] for q in range(12)]
            op = Vec3(oa.x[m], oa.y[m], oa.z[m])
            dp = Vec3(da.x[m], da.y[m], da.z[m])
            os_o = Vec3(mi[0] * op.x + mi[1] * op.y + mi[2] * op.z + mi[3],
                        mi[4] * op.x + mi[5] * op.y + mi[6] * op.z + mi[7],
                        mi[8] * op.x + mi[9] * op.y + mi[10] * op.z + mi[11])
            os_d = Vec3(mi[0] * dp.x + mi[1] * dp.y + mi[2] * dp.z,
                        mi[4] * dp.x + mi[5] * dp.y + mi[6] * dp.z,
                        mi[8] * dp.x + mi[9] * dp.y + mi[10] * dp.z)
            tp = t[ap]
            hs, ts_ = intersect.sphere(os_o, os_d, r[:, 16], tp)
            hb, tb_ = intersect.box(os_o, os_d,
                                    Vec3(r[:, 17], r[:, 18], r[:, 19]), tp)
            sph = ptype == PRIM_SPHERE
            ph = torch.where(sph, hs, hb) & (prim_id != ign[ap])
            t[ap] = torch.where(ph, torch.where(sph, ts_, tb_), tp)
            prim[ap] = torch.where(ph, prim_id, prim[ap])
            tri[ap] = torch.where(ph, -1, tri[ap])
            if occlusion:
                sp[ap[ph]] = 0

    stats = torch.stack([visits, tests])
    return (t, prim.to(torch.int32), tri.to(torch.int32), bv, bw, stats)
