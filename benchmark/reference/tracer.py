"""Ray queries by brute force over the scene's primitives.

Each ray is tested against every primitive whose chunk box it crosses:
triangles and analytic primitives are sorted along a Morton curve of their
centres and cut into chunks of ``CHUNK`` items, each chunk with its world
box padded outward (so the cull never drops a primitive a ray hits);
primitives much larger than the rest, and scenes with few analytic
primitives, are tested against every ray.  Planes are tested first, in
order.  The per-primitive arithmetic is the source's (intersection.cpp:
12-182): Moller-Trumbore with eps 1e-9 on world triangles, and spheres and
boxes in object space through the inverse transform, so t stays
world-parameterised.  A triangle at exactly the running distance wins, an
analytic primitive must be nearer (the source's ``>=`` and ``>``).  The
closest hit's normal is worked out once from the winner (intersection.cpp:
526-591).

``dtype`` sets the precision of the ray-primitive arithmetic: float32 is
the reference; bfloat16 is the control that the check must fail.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .scene import PRIM_MESH, PRIM_SPHERE, RefScene
from .vec import EPSILON, Vec3, noz, where as vwhere

BIG_T = 3.0e38
TRI_EPS = 1e-9
CHUNK = 64
RAY_BLOCK = 8192
CAND_BLOCK = 1 << 22
_NONE = torch.iinfo(torch.int64).max


class Hit(NamedTuple):
    t: torch.Tensor
    hit_id: torch.Tensor  # -1 miss, [0, K) primitive, K + i plane i
    mat_id: torch.Tensor
    p: Vec3
    n: Vec3

    @property
    def valid(self):
        return self.hit_id >= 0


def _safe_inv(c):
    s = torch.where(c >= 0.0, 1.0, -1.0).to(c.dtype)
    return s / torch.clamp(torch.abs(c), min=1e-18)


def tri_test(o: Vec3, d: Vec3, a: Vec3, e1: Vec3, e2: Vec3):
    """(ok, t, v, w) of Moller-Trumbore, before the distance test."""
    pvx = d.y * e2.z - d.z * e2.y
    pvy = d.z * e2.x - d.x * e2.z
    pvz = d.x * e2.y - d.y * e2.x
    det = e1.x * pvx + e1.y * pvy + e1.z * pvz
    ok = (det <= -TRI_EPS) | (det >= TRI_EPS)
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvx, tvy, tvz = o.x - a.x, o.y - a.y, o.z - a.z
    v = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    ok = ok & (v >= 0.0) & (v <= 1.0)
    qvx = tvy * e1.z - tvz * e1.y
    qvy = tvz * e1.x - tvx * e1.z
    qvz = tvx * e1.y - tvy * e1.x
    w = (d.x * qvx + d.y * qvy + d.z * qvz) * inv_det
    ok = ok & (w >= 0.0) & (v + w <= 1.0)
    t = (e2.x * qvx + e2.y * qvy + e2.z * qvz) * inv_det
    return ok & (t >= TRI_EPS), t, v, w


def _to_object(m, o: Vec3, d: Vec3):
    """(object-space origin, direction) through (…, 12) inverse rows."""
    mi = [m[..., q] for q in range(12)]
    oo = Vec3(mi[0] * o.x + mi[1] * o.y + mi[2] * o.z + mi[3],
              mi[4] * o.x + mi[5] * o.y + mi[6] * o.z + mi[7],
              mi[8] * o.x + mi[9] * o.y + mi[10] * o.z + mi[11])
    od = Vec3(mi[0] * d.x + mi[1] * d.y + mi[2] * d.z,
              mi[4] * d.x + mi[5] * d.y + mi[6] * d.z,
              mi[8] * d.x + mi[9] * d.y + mi[10] * d.z)
    return oo, od


def prim_test(o: Vec3, d: Vec3, inv, r, box_r, sphere):
    """(ok, t) of a sphere (``sphere`` True) or a box, before the distance
    test (intersection.cpp:44-105)."""
    oo, od = _to_object(inv, o, d)
    a = od.x * od.x + od.y * od.y + od.z * od.z
    b = od.x * oo.x + od.y * oo.y + od.z * oo.z
    c = oo.x * oo.x + oo.y * oo.y + oo.z * oo.z - r * r
    discr = b * b - a * c
    root = torch.sqrt(torch.clamp(discr, min=0.0))
    inv_a = 1.0 / torch.clamp(a, min=1e-30)
    tn = (-b - root) * inv_a
    tf = (-b + root) * inv_a
    ts = torch.where(tn >= 0.0, tn, tf)
    hs = (discr >= 0.0) & (ts >= EPSILON)
    ix, iy, iz = _safe_inv(od.x), _safe_inv(od.y), _safe_inv(od.z)
    nx, ny, nz = ix * oo.x, iy * oo.y, iz * oo.z
    kx = torch.abs(ix) * box_r[..., 0]
    ky = torch.abs(iy) * box_r[..., 1]
    kz = torch.abs(iz) * box_r[..., 2]
    bn = torch.maximum(torch.maximum(-nx - kx, -ny - ky), -nz - kz)
    bf = torch.minimum(torch.minimum(-nx + kx, -ny + ky), -nz + kz)
    tb = torch.where(bn >= 0.0, bn, bf)
    hb = (bn < bf) & (tb >= EPSILON)
    return torch.where(sphere, hs, hb), torch.where(sphere, ts, tb)


def _morton_chunks(lo: np.ndarray, hi: np.ndarray):
    """(order, chunk lo, chunk hi): items sorted along a Morton curve of
    their box centres, cut into chunks of CHUNK, each chunk's box padded
    outward."""
    n = lo.shape[0]
    c = 0.5 * (lo + hi)
    span = np.maximum(c.max(0) - c.min(0), 1e-12)
    q = np.clip(((c - c.min(0)) / span * 1023).astype(np.int64), 0, 1023)
    code = np.zeros(n, np.int64)
    for bit in range(10):
        for ax in range(3):
            code |= ((q[:, ax] >> bit) & 1) << (3 * bit + ax)
    order = np.argsort(code, kind="stable")
    nch = -(-n // CHUNK)
    pad_n = nch * CHUNK - n
    olo = np.concatenate([lo[order], np.repeat(lo[order][-1:], pad_n, 0)])
    ohi = np.concatenate([hi[order], np.repeat(hi[order][-1:], pad_n, 0)])
    clo = olo.reshape(nch, CHUNK, 3).min(1)
    chi = ohi.reshape(nch, CHUNK, 3).max(1)
    pad = 1e-4 * (1.0 + np.maximum(np.abs(clo), np.abs(chi)))
    return order, clo - pad, chi + pad


def _aabb_of_prim(p_type, fwd, r, box_r):
    if p_type == PRIM_SPHERE:
        olo, ohi = np.full(3, -r), np.full(3, r)
    else:
        olo, ohi = -box_r, box_r
    corners = np.array([[x, y, z] for x in (olo[0], ohi[0])
                        for y in (olo[1], ohi[1]) for z in (olo[2], ohi[2])])
    m = fwd.reshape(3, 4)
    w = corners @ m[:, :3].T + m[:, 3]
    return w.min(0), w.max(0)


class Tracer:
    def __init__(self, rs: RefScene, dtype=torch.float32):
        self.rs = rs
        self.dtype = dtype
        dev = rs.prim_type.device
        self.dev = dev
        self.n_tri = int(rs.tri_a.shape[0])
        ptype = rs.prim_type.cpu().numpy()
        fwd = rs.prim_fwd.cpu().numpy().astype(np.float64)
        pr = rs.prim_r.cpu().numpy().astype(np.float64)
        pbr = rs.prim_box_r.cpu().numpy().astype(np.float64)
        ana = np.nonzero(ptype != PRIM_MESH)[0]
        boxes = [_aabb_of_prim(ptype[i], fwd[i], pr[i], pbr[i]) for i in ana]
        diag = np.array([np.linalg.norm(h - lo) for lo, h in boxes])
        big = np.zeros(len(ana), bool)
        if len(ana) < 4 * CHUNK:
            big[:] = True
        else:
            big = diag > 16.0 * np.median(diag)
        self.always = torch.from_numpy(ana[big]).to(dev)
        self.groups = []  # (kind, members (C, CHUNK) int64 or -1, lo, hi)
        if self.n_tri:
            a = rs.tri_a.cpu().numpy().astype(np.float64)
            b = a + rs.tri_e1.cpu().numpy()
            c = a + rs.tri_e2.cpu().numpy()
            self.groups.append(("tri",) + self._chunked(
                np.arange(self.n_tri), np.minimum(np.minimum(a, b), c),
                np.maximum(np.maximum(a, b), c)))
        chunked = ana[~big]
        if len(chunked):
            lo = np.array([boxes[j][0] for j in np.nonzero(~big)[0]])
            hi = np.array([boxes[j][1] for j in np.nonzero(~big)[0]])
            self.groups.append(("prim",) + self._chunked(chunked, lo, hi))

    def _chunked(self, ids, lo, hi):
        order, clo, chi = _morton_chunks(lo, hi)
        members = np.full(len(clo) * CHUNK, -1, np.int64)
        members[:len(ids)] = ids[order]
        t = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
            a, np.float32)).to(self.dev)
        return (torch.from_numpy(members.reshape(-1, CHUNK)).to(self.dev),
                t(clo), t(chi))

    # -- arithmetic in the query precision ---------------------------------
    def _c(self, x):
        return x.to(self.dtype)

    def _cv(self, v: Vec3) -> Vec3:
        return Vec3(self._c(v.x), self._c(v.y), self._c(v.z))

    def _planes(self, o: Vec3, d: Vec3, t0):
        t = t0
        idx = torch.full_like(t0, -1, dtype=torch.int64)
        oc, dc = self._cv(o), self._cv(d)
        for i in range(self.rs.plane_n.shape[0]):
            n = [float(c) for c in self.rs.plane_n[i]]
            denom = n[0] * dc.x + n[1] * dc.y + n[2] * dc.z
            safe = torch.where(denom == 0.0, -1.0, denom).to(self.dtype)
            tp = ((float(self.rs.plane_d[i])
                   - (n[0] * oc.x + n[1] * oc.y + n[2] * oc.z)) / safe
                  ).to(torch.float32)
            hit = (denom < -EPSILON) & (tp >= EPSILON) & (tp < t)
            t = torch.where(hit, tp, t)
            idx = torch.where(hit, i, idx)
        return t, idx

    def _candidates(self, kind, ids, o: Vec3, d: Vec3):
        """(ok, t float32, key id) of rays (o, d) against items ``ids``,
        broadcast together."""
        rs = self.rs
        oc, dc = self._cv(o), self._cv(d)
        safe = torch.clamp(ids, min=0)
        if kind == "tri":
            a = self._cv(Vec3(*rs.tri_a[safe].unbind(-1)))
            e1 = self._cv(Vec3(*rs.tri_e1[safe].unbind(-1)))
            e2 = self._cv(Vec3(*rs.tri_e2[safe].unbind(-1)))
            ok, t, _, _ = tri_test(oc, dc, a, e1, e2)
            return ok & (ids >= 0), t.to(torch.float32), safe
        ok, t = prim_test(oc, dc, self._c(rs.prim_inv[safe]),
                          self._c(rs.prim_r[safe]),
                          self._c(rs.prim_box_r[safe]),
                          rs.prim_type[safe] == PRIM_SPHERE)
        return ok & (ids >= 0), t.to(torch.float32), self.n_tri + safe

    def _owner(self, key):
        """The primitive a candidate key belongs to."""
        tri = key < self.n_tri
        return torch.where(tri, self.rs.tri_prim[torch.clamp(
            key, max=max(self.n_tri - 1, 0))] if self.n_tri else key,
            key - self.n_tri)

    def _search(self, o: Vec3, d: Vec3, t0, ign):
        """Per ray: the smallest (t bits << 32 | key) of an accepted
        candidate (``_NONE`` if none), t0 the running distance."""
        n = t0.shape[0]
        best = torch.full((n,), _NONE, dtype=torch.int64, device=self.dev)

        def offer(ray, ok, t, key):
            tri = key < self.n_tri
            ok = ok & torch.where(tri, t <= t0[ray], t < t0[ray])
            if ign is not None:
                ok = ok & (self._owner(key) != ign[ray])
            packed = (t.view(torch.int32).to(torch.int64) << 32) | key
            packed = torch.where(ok, packed, _NONE)
            best.scatter_reduce_(0, ray.reshape(-1), packed.reshape(-1),
                                 "amin")

        live = torch.nonzero(t0 >= 0.0).squeeze(1)
        n_all = self.always.numel()
        step = max(1, CAND_BLOCK // max(n_all, 1))
        for s in range(0, live.numel() if n_all else 0, step):
            ray = live[s:s + step]
            r2 = ray[:, None].expand(-1, n_all)
            ok, t, key = self._candidates(
                "prim", self.always[None, :].expand_as(r2),
                Vec3(o.x[r2], o.y[r2], o.z[r2]),
                Vec3(d.x[r2], d.y[r2], d.z[r2]))
            offer(r2, ok, t, key)
        for kind, members, clo, chi in self.groups:
            for s in range(0, live.numel(), RAY_BLOCK):
                ray = live[s:s + RAY_BLOCK]
                hit = self._cull(ray, o, d, t0, clo, chi)
                ri, ci = torch.nonzero(hit, as_tuple=True)
                ri = ray[ri]
                step = max(1, CAND_BLOCK // CHUNK)
                for q in range(0, ri.numel(), step):
                    r2 = ri[q:q + step, None].expand(-1, CHUNK)
                    ok, t, key = self._candidates(
                        kind, members[ci[q:q + step]],
                        Vec3(o.x[r2], o.y[r2], o.z[r2]),
                        Vec3(d.x[r2], d.y[r2], d.z[r2]))
                    offer(r2, ok, t, key)
        return best

    def _cull(self, ray, o, d, t0, clo, chi):
        """(rays, chunks) whose padded box the ray crosses before t0."""
        tn = tf = None
        for ax, (oc, dc) in enumerate(((o.x, d.x), (o.y, d.y), (o.z, d.z))):
            inv = _safe_inv(dc[ray])[:, None]
            t1 = (clo[None, :, ax] - oc[ray][:, None]) * inv
            t2 = (chi[None, :, ax] - oc[ray][:, None]) * inv
            lo_, hi_ = torch.minimum(t1, t2), torch.maximum(t1, t2)
            tn = lo_ if tn is None else torch.maximum(tn, lo_)
            tf = hi_ if tf is None else torch.minimum(tf, hi_)
        return (tn <= tf) & (tf >= 0.0) & (tn <= t0[ray][:, None])

    # -- queries -----------------------------------------------------------
    def occluded(self, o: Vec3, d: Vec3, max_t, ignore_prim):
        t_pl, plane_idx = self._planes(o, d, max_t)
        best = self._search(o, d, t_pl, ignore_prim)
        return (best != _NONE) | (plane_idx >= 0)

    def closest(self, o: Vec3, d: Vec3, t0) -> Hit:
        rs = self.rs
        t_pl, plane_idx = self._planes(o, d, t0)
        best = self._search(o, d, t_pl, None)
        found = best != _NONE
        key = torch.where(found, best & 0xFFFFFFFF, 0)
        t = torch.where(found, (best >> 32).to(torch.int32).view(
            torch.float32), t_pl)
        is_tri = found & (key < self.n_tri)
        prim = torch.where(found, self._owner(key), -1)
        n_prims = rs.n_prims
        plane_won = (plane_idx >= 0) & ~found
        hit_id = torch.where(found, prim,
                             torch.where(plane_won, n_prims + plane_idx, -1))
        p = o + d * t

        # analytic normal: object-space hit point, box face or sphere point,
        # back by the inverse transpose
        primc = torch.clamp(prim, min=0)
        mi = rs.prim_inv[primc]
        oo, od = _to_object(mi, o, d)
        os_p = oo + od * t
        br = torch.clamp(rs.prim_box_r[primc], min=1e-30)
        rel = Vec3(os_p.x / br[:, 0], os_p.y / br[:, 1], os_p.z / br[:, 2])
        ax_, ay_, az_ = torch.abs(rel.x), torch.abs(rel.y), torch.abs(rel.z)
        x_big = (ax_ >= ay_) & (ax_ >= az_)
        y_big = ~x_big & (ay_ >= az_)
        n_box = Vec3(torch.where(x_big, torch.sign(rel.x), 0.0),
                     torch.where(y_big, torch.sign(rel.y), 0.0),
                     torch.where(x_big | y_big, 0.0, torch.sign(rel.z)))
        n_obj = vwhere(rs.prim_type[primc] == PRIM_SPHERE, os_p, n_box)
        m = [mi[:, q] for q in range(12)]
        n_ana = noz(Vec3(m[0] * n_obj.x + m[4] * n_obj.y + m[8] * n_obj.z,
                         m[1] * n_obj.x + m[5] * n_obj.y + m[9] * n_obj.z,
                         m[2] * n_obj.x + m[6] * n_obj.y + m[10] * n_obj.z))

        # mesh normal: the winner's barycentrics again, smooth or geometric
        if self.n_tri:
            tri = torch.clamp(key, max=self.n_tri - 1)
            _, _, v, w = tri_test(o, d, Vec3(*rs.tri_a[tri].unbind(-1)),
                                  Vec3(*rs.tri_e1[tri].unbind(-1)),
                                  Vec3(*rs.tri_e2[tri].unbind(-1)))
            u = 1.0 - v - w
            na = Vec3(*rs.tri_na[tri].unbind(-1))
            nb = Vec3(*rs.tri_nb[tri].unbind(-1))
            nc = Vec3(*rs.tri_nc[tri].unbind(-1))
            n_smooth = noz(na * u + nb * v + nc * w)
            n_mesh = vwhere(rs.tri_has_n[tri], n_smooth,
                            Vec3(*rs.tri_ng[tri].unbind(-1)))
            n = vwhere(is_tri, n_mesh, n_ana)
        else:
            n = n_ana
        plc = torch.clamp(plane_idx, min=0)
        if rs.plane_n.shape[0]:
            pn = torch.from_numpy(rs.plane_n).to(self.dev)[plc]
            n = vwhere(plane_won, Vec3(*pn.unbind(-1)), n)
            plane_mat = rs.plane_mat[plc]
        else:
            plane_mat = torch.zeros_like(plc)
        mat = torch.where(found, rs.prim_mat[primc],
                          torch.where(plane_won, plane_mat, 0))
        return Hit(t, hit_id, mat, p, n)
