"""Binary BVH construction and threaded flattening (host, numpy).

Counterpart of ``buas_pathtracer_tpu/ops/bvh.py``: a Wald-2007 binned-SAH
build (``build_bvh``, reference bvh.cpp:138-213) with the midpoint and
full-sweep SAH variants, and the threaded skip-link layout
(``ThreadedBVH``, ``flatten_world_bvh``) that the oracle walk
(``ops/traverse.py``) reads: nodes in DFS order, where a hit on an internal
node goes to ``i + 1`` and anything else jumps ``miss[i]`` past the
subtree, with the TLAS and every mesh-instance subtree grafted into one
array.  The default build method and the subtree flattener run the native
C++ code (``native/``); the numpy paths below serve without a toolchain.
The two builders give different trees (the JAX package's test accepts 99.5%
hit agreement between them), so byte-equal tables need the native builder
in both packages.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.vec import aabb_surface_area as _sa

N_BINS = 16
MAX_LEAF_SIZE = 4

# threaded node kinds (the JAX package's ops/bvh.py:32-34)
KIND_INTERNAL = 0
KIND_PRIM = 1  # analytic primitive leaf (sphere / box)
KIND_TRIS = 2  # triangle-group leaf


@dataclass
class BuildNodes:
    """Builder output (bvh.h:31-37): an implicit tree with ``left_first`` /
    ``count`` and min/max bounds."""

    lo: np.ndarray  # (N,3)
    hi: np.ndarray  # (N,3)
    left_first: np.ndarray  # (N,) int32: child pair start or first item
    count: np.ndarray  # (N,) int32: 0 => internal
    axis: np.ndarray  # (N,) int8 split axis
    order: np.ndarray  # (M,) int32 permutation of input items into leaf order


def build_bvh(lo: np.ndarray, hi: np.ndarray, method: str = "sah_binned",
              max_leaf_size: int = MAX_LEAF_SIZE) -> BuildNodes:
    """Top-down build over item AABBs (lo/hi: (M,3) float32)."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    if method == "sah_binned" and lo.shape[0] > 0:
        from ..native import build_bvh_native
        built = build_bvh_native(lo, hi, max_leaf_size)
        if built is not None:
            return built
    m = lo.shape[0]
    assert m > 0
    centers = 0.5 * (lo + hi)

    cap = max(2 * m, 4)
    n_lo = np.empty((cap, 3), np.float32)
    n_hi = np.empty((cap, 3), np.float32)
    n_left = np.zeros(cap, np.int32)
    n_count = np.zeros(cap, np.int32)
    n_axis = np.zeros(cap, np.int8)

    order = np.arange(m, dtype=np.int32)
    node_count = 1  # root at 0

    stack = [(0, 0, m)]  # (node_index, start, end)
    while stack:
        ni, s, e = stack.pop()
        idx = order[s:e]
        n_lo[ni] = lo[idx].min(axis=0)
        n_hi[ni] = hi[idx].max(axis=0)
        cnt = e - s

        split = None
        if cnt > max_leaf_size:
            split = _partition(lo, hi, centers, order, s, e, method,
                               max_leaf_size)
            if split is None:
                # degenerate centroid extent or SAH early-out on an oversized
                # range: force a median split so no leaf exceeds the limit
                split = (s + cnt // 2, 0)
        if split is None:
            n_left[ni] = s
            n_count[ni] = cnt
            continue

        mid, axis = split
        left = node_count
        node_count += 2
        n_left[ni] = left
        n_count[ni] = 0
        n_axis[ni] = axis
        stack.append((left + 1, mid, e))  # right first so left pops first
        stack.append((left, s, mid))

    return BuildNodes(
        n_lo[:node_count].copy(),
        n_hi[:node_count].copy(),
        n_left[:node_count].copy(),
        n_count[:node_count].copy(),
        n_axis[:node_count].copy(),
        order,
    )


def _partition(lo, hi, centers, order, s, e, method,
               max_leaf_size=MAX_LEAF_SIZE):
    """Returns (mid, axis) or None to make a leaf."""
    idx = order[s:e]
    c = centers[idx]
    cmin = c.min(axis=0)
    cmax = c.max(axis=0)
    ext = cmax - cmin
    axis = int(np.argmax(ext))
    if ext[axis] <= 1e-12:
        return None

    if method == "midpoint":
        pivot = 0.5 * (cmin[axis] + cmax[axis])
        mask = c[:, axis] < pivot
        k = int(mask.sum())
        if k == 0 or k == len(idx):
            return None
        order[s:e] = np.concatenate([idx[mask], idx[~mask]])
        return s + k, axis

    if method == "sah":
        # full sweep on the widest axis (bvh.cpp:63-131)
        o = np.argsort(c[:, axis], kind="stable")
        sidx = idx[o]
        slo, shi = lo[sidx], hi[sidx]
        lmin = np.minimum.accumulate(slo, axis=0)
        lmax = np.maximum.accumulate(shi, axis=0)
        rmin = np.minimum.accumulate(slo[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(shi[::-1], axis=0)[::-1]
        n = len(sidx)
        ks = np.arange(1, n)
        cost = _sa(lmin[:-1], lmax[:-1]) * ks + _sa(rmin[1:], rmax[1:]) * (n - ks)
        best = int(np.argmin(cost))
        leaf_cost = _sa(lo[idx].min(0), hi[idx].max(0)) * n
        if cost[best] >= leaf_cost and n <= max_leaf_size:
            return None
        order[s:e] = np.concatenate([sidx[: best + 1], sidx[best + 1:]])
        return s + best + 1, axis

    # binned SAH, 16 bins, Wald 2007 (bvh.cpp:138-213)
    scale = N_BINS * (1.0 - 1e-6) / ext[axis]
    bins = np.minimum(((c[:, axis] - cmin[axis]) * scale).astype(np.int32),
                      N_BINS - 1)
    bin_lo = np.full((N_BINS, 3), np.inf, np.float32)
    bin_hi = np.full((N_BINS, 3), -np.inf, np.float32)
    bin_n = np.zeros(N_BINS, np.int64)
    for b in range(N_BINS):
        sel = bins == b
        if sel.any():
            bin_lo[b] = lo[idx[sel]].min(axis=0)
            bin_hi[b] = hi[idx[sel]].max(axis=0)
            bin_n[b] = sel.sum()
    llo = np.minimum.accumulate(bin_lo, axis=0)
    lhi = np.maximum.accumulate(bin_hi, axis=0)
    rlo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
    rhi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
    ln = np.cumsum(bin_n)
    rn = bin_n.sum() - ln
    la = _sa(llo[:-1], lhi[:-1])
    ra = _sa(rlo[1:], rhi[1:])
    valid = (ln[:-1] > 0) & (rn[:-1] > 0)
    cost = np.where(valid, la * ln[:-1] + ra * rn[:-1], np.inf)
    best = int(np.argmin(cost))
    if not valid[best]:
        return None
    n = len(idx)
    leaf_cost = _sa(lo[idx].min(0), hi[idx].max(0)) * n
    if cost[best] >= leaf_cost and n <= max_leaf_size:
        return None
    mask = bins <= best
    order[s:e] = np.concatenate([idx[mask], idx[~mask]])
    return s + int(mask.sum()), axis


# ---------------------------------------------------------------------------
# Threaded (skip-link) flattening
# ---------------------------------------------------------------------------


@dataclass
class ThreadedBVH:
    """Unified flattened node arrays.  Walk: a hit internal node -> i + 1,
    anything else -> miss[i]; the last subtree's miss is the node count."""

    lo: np.ndarray  # (N,3) world space
    hi: np.ndarray  # (N,3)
    miss: np.ndarray  # (N,) int32
    kind: np.ndarray  # (N,) int8
    first: np.ndarray  # (N,) int32  (prim index | triangle start)
    count: np.ndarray  # (N,) int32
    inst: np.ndarray  # (N,) int32  (owning primitive index of tri leaves)


class _Emitter:
    """Collects nodes in DFS order; miss links are patched per subtree."""

    # Flat (zero-extent) boxes, such as axis-aligned quads, fail the strict
    # slab test (tn < tf), in the reference too (intersection.cpp:107-133):
    # every emitted node is padded by a tiny epsilon, which can only take
    # in more geometry.
    PAD = 1e-4

    def __init__(self):
        self.lo, self.hi, self.kind = [], [], []
        self.first, self.count, self.inst = [], [], []
        self.miss = []

    def emit(self, lo, hi, kind, first, count, inst):
        self.lo.append(np.asarray(lo, np.float32) - self.PAD)
        self.hi.append(np.asarray(hi, np.float32) + self.PAD)
        self.kind.append(kind)
        self.first.append(first)
        self.count.append(count)
        self.inst.append(inst)
        self.miss.append(-1)
        return len(self.kind) - 1

    @property
    def n(self):
        return len(self.kind)

    def finish(self) -> ThreadedBVH:
        n = self.n
        miss = np.asarray(self.miss, np.int32)
        miss[miss < 0] = n  # an unpatched link falls through to the end
        return ThreadedBVH(
            np.stack(self.lo) if n else np.zeros((0, 3), np.float32),
            np.stack(self.hi) if n else np.zeros((0, 3), np.float32),
            miss,
            np.asarray(self.kind, np.int8),
            np.asarray(self.first, np.int32),
            np.asarray(self.count, np.int32),
            np.asarray(self.inst, np.int32),
        )


def _emit_mesh_subtree_py(em: _Emitter, bnodes: BuildNodes, node_i: int,
                          fwd: np.ndarray, tri_base: int, inst: int):
    from ..core.vec import transform_aabb
    lo, hi = transform_aabb(fwd, bnodes.lo[node_i], bnodes.hi[node_i])
    cnt = int(bnodes.count[node_i])
    if cnt > 0:
        me = em.emit(lo, hi, KIND_TRIS,
                     tri_base + int(bnodes.left_first[node_i]), cnt, inst)
        em.miss[me] = em.n
        return
    me = em.emit(lo, hi, KIND_INTERNAL, 0, 0, inst)
    left = int(bnodes.left_first[node_i])
    _emit_mesh_subtree_py(em, bnodes, left, fwd, tri_base, inst)
    _emit_mesh_subtree_py(em, bnodes, left + 1, fwd, tri_base, inst)
    em.miss[me] = em.n


def _emit_mesh_subtree_native(em: _Emitter, bnodes: BuildNodes,
                              fwd: np.ndarray, tri_base: int,
                              inst: int) -> bool:
    """The whole subtree in one native call, appended in bulk; False
    without the native library."""
    from ..native import flatten_subtree_native
    n = int(bnodes.count.shape[0])
    lo = np.empty((n, 3), np.float32)
    hi = np.empty((n, 3), np.float32)
    miss = np.empty(n, np.int32)
    kind = np.empty(n, np.int8)
    first = np.empty(n, np.int32)
    count = np.empty(n, np.int32)
    insta = np.empty(n, np.int32)
    if not flatten_subtree_native(bnodes, fwd, _Emitter.PAD, tri_base, inst,
                                  em.n, KIND_INTERNAL, KIND_TRIS, lo, hi,
                                  miss, kind, first, count, insta):
        return False
    em.lo.extend(lo)
    em.hi.extend(hi)
    em.miss.extend(miss.tolist())
    em.kind.extend(kind.tolist())
    em.first.extend(first.tolist())
    em.count.extend(count.tolist())
    em.inst.extend(insta.tolist())
    return True


def flatten_world_bvh(
    tlas: Optional[BuildNodes],
    tlas_prim_ids: np.ndarray,
    item_lo: np.ndarray,
    item_hi: np.ndarray,
    prim_fwd: np.ndarray,
    prim_mesh_id: np.ndarray,
    mesh_bvhs: list,
    mesh_tri_offsets: list,
) -> ThreadedBVH:
    """Graft the TLAS and every mesh instance's subtree into one threaded
    array (the JAX package's ops/bvh.py:273).

    tlas: BuildNodes over the non-plane primitives (None without any);
    tlas_prim_ids: (M,) primitive index of each TLAS item; item_lo/hi:
    (M,3) their world boxes; prim_fwd: (K,3,4) world transforms;
    prim_mesh_id: (K,) mesh index (-1: analytic); mesh_bvhs: per mesh
    BuildNodes (object space, triangles in leaf order); mesh_tri_offsets:
    each mesh's first global triangle."""
    em = _Emitter()

    def emit_prim_leaf(item: int):
        prim_idx = int(tlas_prim_ids[item])
        mesh_id = int(prim_mesh_id[prim_idx])
        if mesh_id >= 0:
            args = (mesh_bvhs[mesh_id], prim_fwd[prim_idx],
                    int(mesh_tri_offsets[mesh_id]), prim_idx)
            if not _emit_mesh_subtree_native(em, *args):
                _emit_mesh_subtree_py(em, args[0], 0, *args[1:])
        else:
            me = em.emit(item_lo[item], item_hi[item], KIND_PRIM, prim_idx,
                         1, prim_idx)
            em.miss[me] = em.n

    def emit_tlas(node_i: int):
        cnt = int(tlas.count[node_i])
        if cnt > 0:
            s = int(tlas.left_first[node_i])
            for k in range(cnt):
                emit_prim_leaf(int(tlas.order[s + k]))
            return
        me = em.emit(tlas.lo[node_i], tlas.hi[node_i], KIND_INTERNAL, 0, 0,
                     -1)
        left = int(tlas.left_first[node_i])
        emit_tlas(left)
        emit_tlas(left + 1)
        em.miss[me] = em.n

    if tlas is not None:
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 100000))
        try:
            emit_tlas(0)
        finally:
            sys.setrecursionlimit(old_limit)
    return em.finish()
