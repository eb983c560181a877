"""8-wide BVH with self-describing 256-byte rows: the traversal structure.

Counterpart of ``buas_pathtracer_tpu/ops/wide_bvh.py``: ``build_wide_scene``,
``annotate_child_kinds``, the split tables of the big-scene path
(``split_for_dma``) and the row constants, producing tables byte-equal to the
JAX package's (``tests/test_torch_scene.py``, ``tests/test_torch_split.py``).

Each traversal step reads ONE row: an internal row tests 8 child AABBs, a
leaf row up to 6 world-space triangles, a prim row an analytic primitive
through its inline inverse transform.  Mesh triangles are pre-transformed to
world space per instance at pack time (the reference transforms the ray per
BVH leaf, intersection.cpp:472).

Row encoding (float32[64] per row; integer lanes hold exact float values):
  lane 0           kind: 0=internal, 1=tri leaf, 2=analytic prim, 3=empty
  internal         lane 1: child_base (children at child_base+0..7)
                   lanes 2+6c..7+6c: child c AABB lo.xyz, hi.xyz (world, padded)
                   lanes 50..57: child kinds (annotate_child_kinds); in the
                   split resident table, child links (split_for_dma)
  tri leaf         lane 1: count (<=6), lane 2: tri_base (global world-tri id),
                   lane 3: owning prim id (light-exclusion parity),
                   lanes 8+9k..16+9k: triangle k  a.xyz, e1.xyz, e2.xyz (world)
  prim             lane 1: prim id, lane 2: prim type, lanes 4..15: inverse
                   transform (3,4) row-major, lane 16: sphere radius,
                   lanes 17..19: box half extents

Builder: binary binned-SAH trees (ops/bvh.py / native C++) are collapsed
top-down into wide nodes by repeatedly expanding the largest-surface-area
candidate, grafting the TLAS and per-instance mesh subtrees into one table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.vec import aabb_surface_area as _sa
from . import bvh as bvh_mod

# The port builds the 8-wide layout only (the JAX package's default; its
# BUAS_WIDE=16 variant is not ported).  The CUDA traversal kernel
# (csrc/wide_traverse.cu) hard-codes these three numbers.
WIDE = 8
ROW_W = 64
WIDE_LEAF = 6  # triangles per leaf row: lanes 8 + 9k must fit ROW_W
# merged leaf rows of the split tables: lanes 8 + 9k, k < 12 -> 115 < 128
DMA_LEAF_K = 12
LEAF_ROW_W = 128

KIND_INTERNAL = 0
KIND_TRIS = 1
KIND_PRIM = 2
KIND_EMPTY = 3

PAD = 1e-4  # flat-geometry AABB epsilon: flat boxes would fail tn < tf


@dataclass
class WideScene:
    rows: np.ndarray  # (R, ROW_W) float32 (int lanes as exact float values)
    depth: int  # max wide-tree depth (stack bound for traversal)
    scene_lo: np.ndarray  # (3,) world bounds of all non-plane geometry
    scene_hi: np.ndarray
    # world-space per-triangle shading data, leaf-ordered globally
    tri_ng: np.ndarray  # (T, 3) geometric normal (unit)
    tri_na: np.ndarray  # (T, 3) smooth vertex normals (unit, zero if none)
    tri_nb: np.ndarray
    tri_nc: np.ndarray
    tri_has_n: np.ndarray  # (T,) bool


def _f(i: int) -> np.float32:
    """Encode a small integer as its exact float32 VALUE (not a bitcast).

    Bitcast patterns for small ints are float32 denormals, which
    flush-to-zero arithmetic silently zeroes; exact float values are safe
    up to 2**24 and decode with a plain float-to-int conversion."""
    assert 0 <= i < (1 << 24)
    return np.float32(i)


def annotate_child_kinds(rows: np.ndarray) -> np.ndarray:
    """Write each internal row's 8 child KIND codes into lanes 50..57
    (free in the 8-wide layout).  The JAX package's grouped TPU walk reads
    them; the port's kernel does not, but keeps them so the tables stay
    byte-equal.  Exact float values (0..3)."""
    if rows.shape[1] < 58 or WIDE != 8:
        return rows
    kind = rows[:, 0].astype(np.int32)
    internal = np.nonzero(kind == KIND_INTERNAL)[0]
    if internal.size:
        ch = rows[internal, 1].astype(np.int64)[:, None] + np.arange(WIDE)
        rows[internal, 50:50 + WIDE] = kind[ch].astype(np.float32)
    return rows


def split_for_dma(rows: np.ndarray):
    """Split the unified row table into a resident table and a leaf table.

    Counterpart of the JAX package's ``wide_bvh.split_for_dma``, byte-equal
    to it.  The RESIDENT table keeps the internal and analytic-prim rows and
    drops the EMPTY rows (8-child allocation padding, never reached: their
    point boxes fail every slab test).  The LEAF table holds the triangle
    leaves as dense 128-float rows: sibling leaf children with contiguous
    triangle ranges of one prim merge into one row of up to DMA_LEAF_K
    triangles, so a walk reads about half as many leaf rows.  Hit results
    are those of the unified walk: a merged child's box is the exact union
    of its members' boxes and its triangles keep their leaf order.

    Internal resident rows get per-child links in lanes 50+c (exact float
    values): a resident child -> its resident index, a leaf child ->
    ``-(leaf_index + 1)``, an EMPTY or merged-away child -> 0.  Lane 58
    holds the 8 child kinds packed 2 bits each; merged-away slots read
    KIND_EMPTY and carry a zero point box.  Lane 1 keeps the unified
    child_base, which no split walk reads.

    Returns ``(res_rows (Ri, 64), leaf_rows (L, 128))`` float32; needs an
    internal or prim root."""
    assert rows.shape[0] < (1 << 23)
    kind = rows[:, 0].astype(np.int32)
    is_leaf = kind == KIND_TRIS
    is_empty = kind == KIND_EMPTY
    keep = (~is_leaf) & (~is_empty)
    res_ids = np.cumsum(keep) - 1
    res_rows = rows[keep].copy()
    assert not is_leaf[0], "the split needs an internal/prim root"
    internal = np.nonzero(kind == KIND_INTERNAL)[0]
    ch = rows[internal, 1].astype(np.int64)[:, None] + np.arange(WIDE)
    ckind = kind[ch].copy()  # (I, 8), mutated by the merge below

    # ---- sibling-leaf merge into dense 128-float rows ----
    pi, ci = np.nonzero(ckind == KIND_TRIS)
    lrow = ch[pi, ci]  # original leaf row id per (parent, child-slot) entry
    base = rows[lrow, 2].astype(np.int64)
    cnt = rows[lrow, 1].astype(np.int64)
    prim = rows[lrow, 3].astype(np.int64)
    order = np.lexsort((base, pi))
    grp = np.empty(len(order), np.int64)
    off = np.empty(len(order), np.int64)
    gid = -1
    gcount = 0
    prev_p = prev_end = prev_prim = -1
    for e in order:
        p, b, n, pr = pi[e], base[e], cnt[e], prim[e]
        if (p == prev_p and pr == prev_prim and b == prev_end
                and gcount + n <= DMA_LEAF_K):
            off[e] = gcount
            grp[e] = gid
            gcount += n
        else:
            gid += 1
            grp[e] = gid
            off[e] = 0
            gcount = n
        prev_p, prev_end, prev_prim = p, b + n, pr
    n_groups = gid + 1
    leaf_rows = np.zeros((max(n_groups, 1), LEAF_ROW_W), np.float32)
    enc = np.where(is_empty[ch], 0, res_ids[ch])  # PRIM/INTERNAL links
    ri = res_ids[internal]
    first = off == 0
    for e in order:
        g = grp[e]
        n = int(cnt[e])
        src = rows[lrow[e]]
        leaf_rows[g, 8 + 9 * off[e]:8 + 9 * (off[e] + n)] = src[8:8 + 9 * n]
        leaf_rows[g, 1] += np.float32(n)
        p, c = pi[e], ci[e]
        if first[e]:
            leaf_rows[g, 0] = _f(KIND_TRIS)
            leaf_rows[g, 2] = src[2]  # tri_base (group-first: min base)
            leaf_rows[g, 3] = src[3]  # owning prim id (uniform in a group)
            enc[p, c] = -(g + 1)
        else:
            # merged-away slot: its box joins the group winner's (second
            # pass) and becomes a zero point box no slab test passes
            ckind[p, c] = KIND_EMPTY
            enc[p, c] = 0
    # second pass for AABB unions (winner slot per group = the first entry)
    win_slot = {}
    for e in order:
        g = grp[e]
        p, c = pi[e], ci[e]
        lo_l = slice(2 + 6 * c, 5 + 6 * c)
        hi_l = slice(5 + 6 * c, 8 + 6 * c)
        if first[e]:
            win_slot[g] = (ri[p], c)
        else:
            wr, wc = win_slot[g]
            wlo = slice(2 + 6 * wc, 5 + 6 * wc)
            whi = slice(5 + 6 * wc, 8 + 6 * wc)
            res_rows[wr, wlo] = np.minimum(res_rows[wr, wlo],
                                           res_rows[ri[p], lo_l])
            res_rows[wr, whi] = np.maximum(res_rows[wr, whi],
                                           res_rows[ri[p], hi_l])
            # zero-volume point box: tn == tf never satisfies tn < tf (an
            # inverted box would pass everywhere)
            res_rows[ri[p], lo_l] = np.float32(0.0)
            res_rows[ri[p], hi_l] = np.float32(0.0)

    res_rows[ri, 50:50 + WIDE] = enc.astype(np.float32)
    # lane 58: the 8 child kinds packed 2 bits each (exact as a float)
    kindbits = np.zeros(len(internal), np.int64)
    for c in range(WIDE):
        kindbits |= ckind[:, c].astype(np.int64) << (2 * c)
    res_rows[ri, 58] = kindbits.astype(np.float32)
    return res_rows, leaf_rows


def _transform_points(fwd: np.ndarray, p: np.ndarray) -> np.ndarray:
    """fwd (3,4) applied to p (...,3)."""
    return p @ fwd[:, :3].T + fwd[:, 3]


def _transform_aabbs(fwd: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """All-8-corners world AABB (scene.cpp:224-236), vectorized over (N,3)."""
    corners = np.stack([np.where([(c >> a) & 1 for a in range(3)], hi, lo)
                        for c in range(8)], axis=0)  # (8, N, 3)
    w = _transform_points(fwd, corners)
    return w.min(axis=0), w.max(axis=0)


def _subtree_ranges(b: "bvh_mod.BuildNodes"):
    """Per-node (first, count) of the subtree's leaf-ordered triangle range
    (contiguous by construction).  Iterative post-order: builder trees can
    be deep on degenerate input."""
    n = len(b.count)
    sf = np.zeros(n, np.int64)
    sc = np.zeros(n, np.int64)
    order = []
    st = [0]
    while st:
        nd = st.pop()
        order.append(nd)
        if b.count[nd] == 0:
            st.append(int(b.left_first[nd]))
            st.append(int(b.left_first[nd]) + 1)
    for nd in reversed(order):
        if b.count[nd] > 0:
            sf[nd] = b.left_first[nd]
            sc[nd] = b.count[nd]
        else:
            l = int(b.left_first[nd])
            sf[nd] = min(sf[l], sf[l + 1])
            sc[nd] = sc[l] + sc[l + 1]
    return sf, sc


class _Inst:
    """One mesh instance: world AABBs per binary node + world triangles."""

    def __init__(self, bnodes: bvh_mod.BuildNodes, fwd: np.ndarray,
                 tri_base: int, prim_idx: int):
        self.b = bnodes
        self.prim = prim_idx
        self.tri_base = tri_base
        self.lo, self.hi = _transform_aabbs(fwd, bnodes.lo, bnodes.hi)
        self.sa = _sa(self.lo, self.hi)
        # leaf-merge support: subtrees whose total fits one row terminate
        # as ONE full leaf (python fallback of the native collapse policy)
        self.sub_first, self.sub_count = _subtree_ranges(bnodes)


def build_wide_scene(
    prim_type: np.ndarray,
    prim_fwd: np.ndarray,  # (K, 3, 4)
    prim_r: np.ndarray,
    prim_inv: np.ndarray,  # (K, 3, 4)
    prim_box_r: np.ndarray,
    prim_mesh_id: np.ndarray,
    meshes: list,  # objects with .triangles (T,3,3), .normals, .has_normals
    real_prims: List[int],
    item_lo: np.ndarray,  # (len(real), 3) world AABBs per real prim
    item_hi: np.ndarray,
    bvh_method: str = "sah_binned",
) -> WideScene:
    # ---- per-mesh binary BVHs at wide leaf size, shared across instances ---
    mesh_bvhs: List[Optional[bvh_mod.BuildNodes]] = []
    for mesh in meshes:
        tv = np.asarray(mesh.triangles, np.float32)
        lo = tv.min(axis=1)
        hi = tv.max(axis=1)
        mesh_bvhs.append(bvh_mod.build_bvh(lo, hi, bvh_method, WIDE_LEAF))

    # ---- per-instance world triangle data, leaf-ordered ----
    insts: List[_Inst] = []
    inst_of_prim = {}
    tri_a, tri_e1, tri_e2 = [], [], []
    ng_l, na_l, nb_l, nc_l, has_l = [], [], [], [], []
    tri_cursor = 0
    for pi in real_prims:
        mid = int(prim_mesh_id[pi])
        if mid < 0:
            continue
        mesh = meshes[mid]
        b = mesh_bvhs[mid]
        fwd = prim_fwd[pi]
        tv = np.asarray(mesh.triangles, np.float32)[b.order]  # leaf order
        wa = _transform_points(fwd, tv[:, 0])
        wb = _transform_points(fwd, tv[:, 1])
        wc = _transform_points(fwd, tv[:, 2])
        e1 = wb - wa
        e2 = wc - wa
        ng = np.cross(e1, e2)
        ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-30)
        if mesh.has_normals:
            nrm = np.asarray(mesh.normals, np.float32)[b.order]
            a_invt = prim_inv[pi][:, :3].T  # (A^-1)^T applied to normals
            wn = nrm @ a_invt.T
            wn /= np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True), 1e-30)
            na, nb, nc = wn[:, 0], wn[:, 1], wn[:, 2]
            has = np.ones(len(tv), bool)
        else:
            na = nb = nc = np.zeros_like(wa)
            has = np.zeros(len(tv), bool)
        tri_a.append(wa)
        tri_e1.append(e1)
        tri_e2.append(e2)
        ng_l.append(ng)
        na_l.append(na)
        nb_l.append(nb)
        nc_l.append(nc)
        has_l.append(has)
        inst = _Inst(b, fwd, tri_cursor, pi)
        inst_of_prim[pi] = inst
        insts.append(inst)
        tri_cursor += len(tv)

    if tri_cursor == 0:
        tri_a = [np.zeros((1, 3), np.float32)]
        tri_e1 = [np.zeros((1, 3), np.float32)]
        tri_e2 = [np.zeros((1, 3), np.float32)]
        ng_l = [np.zeros((1, 3), np.float32)]
        na_l = nb_l = nc_l = ng_l
        has_l = [np.zeros(1, bool)]

    # ---- TLAS over real prims (leaf size 1: wide collapse expands items) ---
    rows: List[np.ndarray] = []

    def alloc(n=1) -> int:
        base = len(rows)
        for _ in range(n):
            r = np.zeros(ROW_W, np.float32)
            r[0] = _f(KIND_EMPTY)
            rows.append(r)
        return base

    # item index of each primitive (its first position in real_prims)
    item_of = {}
    for j, pi in enumerate(real_prims):
        item_of.setdefault(pi, j)

    # candidate refs: ('t', node) | ('m', inst, node) | ('p', prim_idx)
    #              | ('i', (prim_idx, ...)) — a multi-item TLAS leaf
    if len(real_prims) > 0:
        tlas = bvh_mod.build_bvh(item_lo, item_hi, bvh_method, 1) \
            if len(real_prims) > 1 else None

        def item_ref(pi):
            if pi in inst_of_prim:
                return ("m", inst_of_prim[pi], 0)
            return ("p", pi)

        def items_ref(items):
            if len(items) == 1:
                return item_ref(items[0])
            return ("i", tuple(items))

        def normalize(ref):
            """Resolve TLAS leaves to their underlying prim/mesh-root refs.

            A TLAS leaf can hold >1 item even at leaf size 1 when item
            centroids coincide (e.g. concentric nested-dielectric spheres,
            degenerate centroid extent).  ALL its items must survive as
            candidates — resolving only order[left_first] silently dropped
            the rest (round-1 ADVICE high finding)."""
            if ref[0] == "t":
                node = ref[1]
                if tlas is None:
                    return item_ref(real_prims[0])
                cnt = int(tlas.count[node])
                if cnt > 0:
                    lf = int(tlas.left_first[node])
                    items = [real_prims[int(tlas.order[lf + j])]
                             for j in range(cnt)]
                    return items_ref(items)
            return ref

        def expandable(ref):
            if ref[0] == "t":
                return True  # normalized TLAS refs are always internal
            if ref[0] == "i":
                return True  # item lists split until singular
            if ref[0] == "m":
                # subtrees that fit one leaf row terminate merged
                return (ref[1].b.count[ref[2]] == 0
                        and ref[1].sub_count[ref[2]] > WIDE_LEAF)
            return False

        def children(ref):
            if ref[0] == "t":
                left = int(tlas.left_first[ref[1]])
                return [normalize(("t", left)), normalize(("t", left + 1))]
            if ref[0] == "i":
                lst = ref[1]
                mid = len(lst) // 2
                return [items_ref(lst[:mid]), items_ref(lst[mid:])]
            inst, node = ref[1], ref[2]
            left = int(inst.b.left_first[node])
            return [("m", inst, left), ("m", inst, left + 1)]

        def aabb_of(ref):
            if ref[0] == "t":
                return tlas.lo[ref[1]], tlas.hi[ref[1]]
            if ref[0] == "m":
                return ref[1].lo[ref[2]], ref[1].hi[ref[2]]
            if ref[0] == "c":  # packed chunk row: own union AABB
                return ref[4], ref[5]
            if ref[0] == "i":
                js = [item_of[pi] for pi in ref[1]]
                return item_lo[js].min(axis=0), item_hi[js].max(axis=0)
            j = item_of[ref[1]]
            return item_lo[j], item_hi[j]

        def sa_of(ref):
            lo, hi = aabb_of(ref)
            return float(_sa(lo, hi))

        def fill_leaf_range(inst, first, cnt, idx):
            row = rows[idx]
            # builders guarantee leaves <= WIDE_LEAF (forced median split on
            # degenerate/early-out ranges); an oversized leaf here would
            # silently drop triangles, so fail loudly.
            assert cnt <= WIDE_LEAF, f"leaf of {cnt} tris > {WIDE_LEAF}"
            row[0] = _f(KIND_TRIS)
            row[1] = _f(cnt)
            row[2] = _f(inst.tri_base + first)
            row[3] = _f(inst.prim)
            k_inst = insts.index(inst)  # per-instance arrays, insts order
            a = tri_a[k_inst][first:first + cnt]
            e1 = tri_e1[k_inst][first:first + cnt]
            e2 = tri_e2[k_inst][first:first + cnt]
            for k in range(cnt):
                s = 8 + 9 * k
                row[s:s + 3] = a[k]
                row[s + 3:s + 6] = e1[k]
                row[s + 6:s + 9] = e2[k]
            return 1

        def fill_terminal(ref, idx):
            row = rows[idx]
            if ref[0] == "p":
                pi = ref[1]
                row[0] = _f(KIND_PRIM)
                row[1] = _f(int(pi))
                row[2] = _f(int(prim_type[pi]))
                row[4:16] = prim_inv[pi].reshape(12)
                row[16] = prim_r[pi]
                row[17:20] = prim_box_r[pi]
                return 1
            inst, node = ref[1], ref[2]
            # merged terminal: the whole subtree's contiguous range (equals
            # the node's own leaf range when the node IS a leaf)
            return fill_leaf_range(inst, int(inst.sub_first[node]),
                                   int(inst.sub_count[node]), idx)

        def chunk_groups_m(inst, node):
            """Balanced range chunking of a small mesh subtree (mirror of
            the native collapse policy): the contiguous leaf-ordered range
            cut into ceil(T/WIDE_LEAF) near-equal rows with AABBs
            recomputed from the triangles; returns [(first, cnt, lo, hi)]
            or None when they would not fit one wide node."""
            T = int(inst.sub_count[node])
            first = int(inst.sub_first[node])
            ng = -(-T // WIDE_LEAF)
            if ng > WIDE:
                return None
            base, extra = T // ng, T % ng
            k_inst = insts.index(inst)
            groups = []
            cur = first
            for g in range(ng):
                cnt = base + (1 if g < extra else 0)
                a = tri_a[k_inst][cur:cur + cnt]
                e1 = tri_e1[k_inst][cur:cur + cnt]
                e2 = tri_e2[k_inst][cur:cur + cnt]
                v = np.concatenate([a, a + e1, a + e2], axis=0)
                groups.append((cur, cnt, v.min(axis=0), v.max(axis=0)))
                cur += cnt
            return groups

        def emit_chunked(inst, node, idx):
            """One wide node over greedily-packed leaf rows for subtrees of
            <= WIDE*WIDE_LEAF triangles — kills the binary-topology
            cascades of 2-child internals over half-empty leaves (bench
            scene before: mean arity 4.34, leaf fill 4.5/6)."""
            groups = chunk_groups_m(inst, node)
            if not groups:
                return None
            child_base = alloc(WIDE)
            row = rows[idx]
            row[0] = _f(KIND_INTERNAL)
            row[1] = _f(child_base)
            for i in range(WIDE):
                s = 2 + 6 * i
                if i < len(groups):
                    first, cnt, lo, hi = groups[i]
                    row[s:s + 3] = lo - PAD
                    row[s + 3:s + 6] = hi + PAD
                    fill_leaf_range(inst, first, cnt, child_base + i)
                else:
                    row[s:s + 3] = 3.0e38
                    row[s + 3:s + 6] = 3.0e38
            return 2

        def emit_mesh_native(ref, idx) -> Optional[int]:
            """C++ fast path for a whole mesh subtree (wide_collapse.cpp).

            The native block's local row 0 is the subtree root; it replaces
            the already-allocated row ``idx`` and rows 1.. are appended, so
            links are pre-offset by len(rows)-1."""
            from ..native import wide_collapse_native
            inst, node = ref[1], ref[2]
            k_inst = insts.index(inst)
            res = wide_collapse_native(
                inst.lo, inst.hi, inst.b.left_first, inst.b.count, node,
                tri_a[k_inst], tri_e1[k_inst], tri_e2[k_inst],
                inst.tri_base, inst.prim, len(rows) - 1, PAD, WIDE, ROW_W)
            if res is None:
                return None
            block, depth = res
            rows[idx] = block[0]
            rows.extend(block[1:])
            return depth

        def emit_into(ref, idx) -> int:
            """Fill row ``idx`` for ``ref``; returns subtree wide-depth."""
            if ref[0] == "c":  # packed chunk row candidate
                return fill_leaf_range(ref[1], ref[2], ref[3], idx)
            if ref[0] == "m":
                d = emit_mesh_native(ref, idx)
                if d is not None:
                    return d
                inst, nd = ref[1], ref[2]
                if (inst.b.count[nd] == 0
                        and inst.sub_count[nd] <= WIDE * WIDE_LEAF):
                    d = emit_chunked(inst, nd, idx)
                    if d is not None:
                        return d
            if not expandable(ref):
                return fill_terminal(ref, idx)
            cands = children(ref)
            while True:
                best, best_sa = -1, -1.0
                for ci, c in enumerate(cands):
                    if expandable(c):
                        s = sa_of(c)
                        if s > best_sa:
                            best, best_sa = ci, s
                if best < 0:
                    break
                cd = cands[best]
                # small mesh subtrees expand into their packed chunk rows
                # INSIDE the parent's slots (mirrors the native collapse)
                if cd[0] == "m" and cd[1].b.count[cd[2]] == 0 \
                        and cd[1].sub_count[cd[2]] <= WIDE * WIDE_LEAF:
                    groups = chunk_groups_m(cd[1], cd[2])
                    if groups and len(cands) - 1 + len(groups) <= WIDE:
                        cands[best:best + 1] = [
                            ("c", cd[1], f, ct, lo, hi)
                            for (f, ct, lo, hi) in groups]
                        continue
                if len(cands) >= WIDE:
                    break
                cands[best:best + 1] = children(cd)
            child_base = alloc(WIDE)
            row = rows[idx]
            row[0] = _f(KIND_INTERNAL)
            row[1] = _f(child_base)
            depth = 0
            for c_i, cand in enumerate(cands):
                lo, hi = aabb_of(cand)
                s = 2 + 6 * c_i
                row[s:s + 3] = lo - PAD
                row[s + 3:s + 6] = hi + PAD
                depth = max(depth, emit_into(cand, child_base + c_i))
            for c_i in range(len(cands), WIDE):
                # empty slot: a DEGENERATE point box (lo == hi) so the strict
                # slab test tn < tf always misses.  (An inverted box lo > hi
                # would produce tn=-inf/tf=+inf — an always-HIT.)
                s = 2 + 6 * c_i
                row[s:s + 3] = 3.0e38
                row[s + 3:s + 6] = 3.0e38
            return depth + 1

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 100000))
        try:
            root_idx = alloc(1)
            root = normalize(("t", 0))
            depth = emit_into(root, root_idx)
        finally:
            sys.setrecursionlimit(old)
    else:
        alloc(1)  # empty-scene sentinel row (kind EMPTY -> immediate done)
        depth = 1

    if len(real_prims) > 0:
        scene_lo = item_lo.min(axis=0).astype(np.float32)
        scene_hi = item_hi.max(axis=0).astype(np.float32)
    else:
        scene_lo = np.zeros(3, np.float32)
        scene_hi = np.ones(3, np.float32)
    return WideScene(
        rows=annotate_child_kinds(np.stack(rows)),
        depth=max(depth, 1),
        scene_lo=scene_lo,
        scene_hi=scene_hi,
        tri_ng=np.concatenate(ng_l),
        tri_na=np.concatenate(na_l),
        tri_nb=np.concatenate(nb_l),
        tri_nc=np.concatenate(nc_l),
        tri_has_n=np.concatenate(has_l),
    )
