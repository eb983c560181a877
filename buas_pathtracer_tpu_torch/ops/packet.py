"""Wide-BVH traversal: the kernel wrappers and their plain PyTorch versions.

Counterpart of the kernel side of ``buas_pathtracer_tpu/ops/pallas_packet.py``.
``wide_traverse`` walks the unified row table (``_kernel_v2`` and the grouped
``_kernel_v5``, and the v1 ``_kernel``: all three compute this function) and
launches ``csrc/wide_traverse.cu``; ``split_traverse`` walks the split tables
of big scenes (``_kernel_v7`` and ``_kernel_v4``, which compute one function)
and launches ``csrc/split_traverse.cu``.  Each wrapper launches its kernel
for CUDA tensors and runs its plain version for CPU tensors; there is no
fallback from one to the other.  The wave ordering in front of them (sort
keys, root prefilter, routes) is ``ops/dispatch.py``; the JAX package's
compaction rungs and ladders are TPU budgets and have no counterpart.

Kernel and plain version walk each ray with its own stack, in the same
order, with the same arithmetic (the kernels are built with ``-fmad=false``),
so on one device they return the same hits and the same stats; the rules are
listed in ``csrc/walk.cuh``.  Outputs: t (float32), prim, tri (int32), bary
v, w (float32), and a (2,) int64 tensor of [rows read, triangle tests]
summed over the rays.

Both kernels run persistent warps (``csrc/walk.cuh``): the wrapper launches
``walk_grid`` blocks of ``WALK_THREADS`` and zeroes the ray counter the
warps fetch from; a warp refills once half its lanes are idle and steps
the node kind most of its lanes want.

Each walk runs inside the span ``pt.walk`` (``utils/trace.py``).  While the
tracer counts walks (spans on, in a traced frame), ``split_traverse``
launches the counted kernel of the same walk (``csrc/walk.cuh``, COUNT) in
place of the plain one: the same outputs and stats, and in a ``WalkCounts``
its live rays (t0 >= 0), its leaf-row fetches and a bitmap of the leaf rows
it fetched, which the tracer keeps and reads only after the frames.
Untraced frames launch the uncounted kernels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.vec import Vec3
from ..utils import trace
from . import cuda_lib, intersect
from .wide_bvh import (DMA_LEAF_K, KIND_EMPTY, KIND_INTERNAL, KIND_PRIM,
                       KIND_TRIS, LEAF_ROW_W, ROW_W, WIDE, WIDE_LEAF)

STACK = 128  # per-ray stack capacity of both traversal kernels
WALK_THREADS = 128  # threads per block of both kernels (csrc/walk.cuh)
LINK_LIMIT = 1 << 28  # rows per table: a link rides in 29 bits of a sort key
BIG_T = 1e30  # in-kernel child-key sentinel (pallas_packet.BIG_T)
PRIM_SPHERE = 2

# A unified row table larger than this is split (models/scene.py): the
# H100's 50 MB L2 cache.  The split tables drop the EMPTY padding rows and
# merge sibling leaves, so on the stress scene they fit L2 (42.6 MB) where
# the unified table (62.6 MB) does not.  (The JAX package splits at the
# TPU's 30 MB VMEM budget instead.)
RESIDENT_TABLE_LIMIT_BYTES = 50 * 1000 * 1000


def stack_fits(depth: int) -> bool:
    """A per-ray walk holds at most (WIDE-1) deferred children per level
    plus the current node (pallas_packet.stack_fits, :1657)."""
    return depth * (WIDE - 1) + 1 <= STACK


def walk_grid(n: int, resident_blocks: int) -> int:
    """Blocks of a persistent walk over ``n`` rays: the blocks resident on
    the card, or fewer when ``n`` rays fill fewer blocks of WALK_THREADS."""
    if resident_blocks < 1:
        raise RuntimeError("the card's occupancy query returned no blocks")
    return max(1, min(resident_blocks, -(-n // WALK_THREADS)))


def _check(tables, o: Vec3, d: Vec3, t0, ign, depth: int):
    """tables: [(name, tensor, row width)], all on one device."""
    dev = tables[0][1].device
    for name, tab, width in tables:
        if tab.dtype != torch.float32 or tab.dim() != 2 \
                or tab.shape[1] != width:
            raise ValueError(f"{name} must be float32 (R, {width}), got "
                             f"{tab.dtype} {tuple(tab.shape)}")
        if tab.shape[0] >= LINK_LIMIT:
            raise ValueError(f"{name} has {tab.shape[0]} rows, the walk "
                             f"links at most {LINK_LIMIT}")
    if not stack_fits(depth):
        raise ValueError(f"tree depth {depth} needs a stack of "
                         f"{depth * (WIDE - 1) + 1} > {STACK}")
    n = t0.shape[0]
    named = [(name, tab) for name, tab, _ in tables] + [
        ("o.x", o.x), ("o.y", o.y), ("o.z", o.z), ("d.x", d.x),
        ("d.y", d.y), ("d.z", d.z), ("t0", t0), ("ign", ign)]
    for k, (name, x) in enumerate(named):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, {tables[0][0]} on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if k >= len(tables):
            want = torch.int32 if name == "ign" else torch.float32
            if x.dtype != want or tuple(x.shape) != (n,):
                raise ValueError(f"{name} must be {want} ({n},), got "
                                 f"{x.dtype} {tuple(x.shape)}")


class WalkCounts:
    """A counted split walk's counters, in one int32 buffer on the walk's
    device, zeroed when made: the walk's ray counter (``next``), a pad, its
    live rays and leaf-row fetches as two int64 (``counts``), and a bitmap
    of the leaf rows it fetched (``leaf_bits``: row r is bit r % 32 of word
    r // 32).  The counted walk takes its ray counter from here, so it
    zeroes one buffer where an uncounted walk zeroes its counter."""

    def __init__(self, leaf_rows: int, device):
        self.leaf_rows = int(leaf_rows)
        self.buf = torch.zeros(6 + -(-self.leaf_rows // 32),
                               dtype=torch.int32, device=device)
        self.next = self.buf[:1]
        self.counts = self.buf[2:6].view(torch.int64)
        self.leaf_bits = self.buf[6:]
        self._read = None

    def mark(self, live: int, leaf_reads) -> None:
        """Fill the counters from a walk on the host: its live rays and its
        reads of each leaf row (int64 (L,))."""
        row = torch.nonzero(leaf_reads).squeeze(1)
        w = torch.zeros(self.leaf_bits.shape[0], dtype=torch.int64)
        w.index_add_(0, row >> 5, torch.ones_like(row) << (row & 31))
        self.counts.copy_(torch.tensor([live, int(leaf_reads.sum())]))
        self.leaf_bits.copy_((w - ((w >> 31) << 32)).to(torch.int32))

    def read(self) -> tuple:
        """(live rays, leaf-row fetches, distinct leaf rows); reads the
        buffer back (a wait on the card), so only once the walk is over."""
        if self._read is None:
            host = self.buf.cpu()
            live, fetches = host[2:6].view(torch.int64).tolist()
            rows = np.unpackbits(host[6:].numpy().view(np.uint8)).sum()
            self._read = (live, fetches, int(rows))
        return self._read


def _launch(name, key, tables, o: Vec3, d: Vec3, t0, ign, occlusion,
            steps=None, counted: Optional[WalkCounts] = None):
    """Allocate the outputs and the ray counter and launch ``csrc/<name>.cu``
    on the current stream; ``key`` names the launch counter
    (``utils/trace.py``).  ``steps``, an int64 (1,) tensor, if given, gets
    the warp steps that read a row added.  ``counted`` (split_traverse
    only), a ``WalkCounts`` on the rays' device, launches the counted walk,
    which fills it."""
    lib = cuda_lib.load()
    if getattr(lib, f"{name}_max_stack")() != STACK:
        raise RuntimeError(f"csrc/{name}.cu STACK differs from ops/packet.py")
    n = t0.shape[0]
    dev = t0.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    bv = torch.empty(n, dtype=torch.float32, device=dev)
    bw = torch.empty(n, dtype=torch.float32, device=dev)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    blocks_of = getattr(lib, f"{name}_blocks")
    tail = ()  # the split walk's counters and leaf bitmap, or none
    if counted is None:
        nxt = torch.zeros(1, dtype=torch.int32, device=dev)
        if name == "split_traverse":
            tail = (None, None)
    else:
        if name != "split_traverse" or counted.buf.device != dev:
            raise ValueError("counted walks are split walks, their counters "
                             "on the rays' device")
        nxt = counted.next
        tail = (counted.counts.data_ptr(), counted.leaf_bits.data_ptr())
        blocks_of = lib.split_traverse_counted_blocks
    if steps is not None and (steps.device != dev or steps.dtype != torch.int64
                              or steps.numel() != 1):
        raise ValueError("steps must be an int64 (1,) tensor on the rays' "
                         "device")
    with torch.cuda.device(dev):
        blocks = walk_grid(n, blocks_of(int(bool(occlusion))))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            *(x.data_ptr() for x in tables), n, o.x.data_ptr(),
            o.y.data_ptr(), o.z.data_ptr(), d.x.data_ptr(), d.y.data_ptr(),
            d.z.data_ptr(), t0.data_ptr(), ign.data_ptr(),
            int(bool(occlusion)), t.data_ptr(), prim.data_ptr(),
            tri.data_ptr(), bv.data_ptr(), bw.data_ptr(), stats.data_ptr(),
            nxt.data_ptr(), None if steps is None else steps.data_ptr(),
            *tail, blocks, stream)
    cuda_lib.check(rc, name)
    trace.launch(key)
    return t, prim, tri, bv, bw, stats


def wide_traverse(rows, depth: int, o: Vec3, d: Vec3, t0, ign,
                  occlusion: bool, steps=None):
    """Closest-hit (or, with ``occlusion``, first-hit) walk of the row table.

    rows (R, 64) float32; o, d Vec3 of (N,) float32; t0 (N,) float32 (lanes
    with t0 < 0 pass through); ign (N,) int32 prim to ignore (-1: none).
    ``steps`` (kernel only): see ``_launch``."""
    _check([("rows", rows, ROW_W)], o, d, t0, ign, depth)
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no wide_traverse for device {rows.device}")
    with trace.span("pt.walk"):
        if rows.device.type == "cpu":
            return wide_traverse_plain(rows, depth, o, d, t0, ign, occlusion)
        return _launch("wide_traverse",
                       "occlusion" if occlusion else "closest", [rows], o, d,
                       t0, ign, occlusion, steps)


def split_traverse(res, leaf, depth: int, o: Vec3, d: Vec3, t0, ign,
                   occlusion: bool, steps=None):
    """``wide_traverse`` over the split tables (ops/wide_bvh.split_for_dma):
    res (Ri, 64) float32 resident rows, leaf (L, 128) float32 leaf rows;
    the rays and outputs as in ``wide_traverse``."""
    _check([("res", res, ROW_W), ("leaf", leaf, LEAF_ROW_W)], o, d, t0, ign,
           depth)
    if res.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no split_traverse for device {res.device}")
    key = "split_occlusion" if occlusion else "split_closest"
    counted = None
    with trace.span("pt.walk"):
        if trace.counting_walks():
            counted = WalkCounts(leaf.shape[0], res.device)
        if res.device.type == "cuda":
            out = _launch("split_traverse", key, [res, leaf], o, d, t0, ign,
                          occlusion, steps, counted)
        elif counted is None:
            out = split_traverse_plain(res, leaf, depth, o, d, t0, ign,
                                       occlusion)
        else:
            reads = torch.zeros(leaf.shape[0], dtype=torch.int64)
            out = split_traverse_plain(res, leaf, depth, o, d, t0, ign,
                                       occlusion, leaf_reads=reads)
            counted.mark(int((t0 >= 0.0).sum()), reads)
    if counted is not None:
        trace.walk(key, t0.shape[0], counted)
    return out


class _Walk:
    """State of the plain walks: every ray's best hit and its own stack of
    (link, key) entries.  Each ``pop`` takes one entry from every ray that
    still has one, in the order the kernels take them."""

    def __init__(self, o: Vec3, d: Vec3, t0, ign, depth: int):
        n = t0.shape[0]
        dev = t0.device
        cap = depth * (WIDE - 1) + 1
        self.o, self.d = o, d
        self.inv = intersect.safe_inv_dir(d)
        self.ign = ign.to(torch.int64)
        self.t = t0.clone()
        self.prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
        self.tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
        self.bv = torch.zeros(n, dtype=torch.float32, device=dev)
        self.bw = torch.zeros(n, dtype=torch.float32, device=dev)
        self.stk_node = torch.zeros((n, cap), dtype=torch.int64, device=dev)
        self.stk_key = torch.zeros((n, cap), dtype=torch.float32, device=dev)
        # live rays start at the root; rays with t0 < 0 or a NaN component
        # (which would hit nothing) read no row
        nan = (torch.isnan(o.x) | torch.isnan(o.y) | torch.isnan(o.z)
               | torch.isnan(d.x) | torch.isnan(d.y) | torch.isnan(d.z))
        self.sp = ((t0 >= 0.0) & ~nan).to(torch.int64)
        self.visits = torch.zeros((), dtype=torch.int64, device=dev)
        self.tests = torch.zeros((), dtype=torch.int64, device=dev)

    def pop(self):
        """(rays, links) to visit this iteration; None when every stack is
        empty.  Entries entered before a nearer hit (key >= t) are dropped."""
        sp = self.sp
        a = torch.nonzero(sp > 0).squeeze(1)
        if a.numel() == 0:
            return None
        sp[a] -= 1
        spa = sp[a]
        keep = self.stk_key[a, spa] < self.t[a]
        a = a[keep]
        self.visits += a.numel()
        return a, self.stk_node[a, spa[keep]]

    def internal(self, ai, r, links, live=None):
        """8 child slabs of internal rows ``r`` for rays ``ai``; hit children
        (``live`` ones only, when given) are pushed farthest first, so the
        nearest pops first; equal keys keep slot order."""
        inv, o = self.inv, self.o
        ia = Vec3(inv.x[ai][:, None], inv.y[ai][:, None], inv.z[ai][:, None])
        oi = Vec3(o.x[ai][:, None], o.y[ai][:, None], o.z[ai][:, None])
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
        h = (tn < tf) & (tf > 0.0) & (tn < self.t[ai][:, None]) & (k < BIG_T)
        if live is not None:
            h = h & live
        key = torch.where(h, k, float("inf"))
        skey, order = torch.sort(key, dim=1, stable=True)  # ties: slot
        slinks = torch.gather(links, 1, order)
        n_hit = h.sum(dim=1)
        sp_i = self.sp[ai]
        for j in range(WIDE):
            mj = j < n_hit
            at = (sp_i + n_hit - 1 - j)[mj]
            self.stk_node[ai[mj], at] = slinks[mj, j]
            self.stk_key[ai[mj], at] = skey[mj, j]
        self.sp[ai] = sp_i + n_hit

    def leaf(self, al, r, slots: int, occlusion: bool):
        """Triangle leaf rows ``r`` (up to ``slots`` world-space triangles,
        tested in slot order) for rays ``al``; leaves of a ray's ignored
        prim are skipped."""
        m = r[:, 3].to(torch.int64) != self.ign[al]
        if not m.any():
            return
        r, al = r[m], al[m]
        count = r[:, 1].to(torch.int64)
        tri_base = r[:, 2].to(torch.int64)
        inst = r[:, 3].to(torch.int64)
        self.tests += torch.clamp(count, max=slots).sum()
        ol = Vec3(self.o.x[al], self.o.y[al], self.o.z[al])
        dl = Vec3(self.d.x[al], self.d.y[al], self.d.z[al])
        tl, pl, trl = self.t[al], self.prim[al], self.tri[al]
        bvl, bwl = self.bv[al], self.bw[al]
        any_hit = torch.zeros_like(count, dtype=torch.bool)
        for kk in range(slots):
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
        self.t[al], self.prim[al], self.tri[al] = tl, pl, trl
        self.bv[al], self.bw[al] = bvl, bwl
        if occlusion:
            self.sp[al[any_hit]] = 0

    def prims(self, ap, r, occlusion: bool):
        """Analytic prim rows ``r``: sphere / box through the inline
        inverse transform."""
        prim_id = r[:, 1].to(torch.int64)
        ptype = r[:, 2].to(torch.int64)
        mi = [r[:, 4 + q] for q in range(12)]
        op = Vec3(self.o.x[ap], self.o.y[ap], self.o.z[ap])
        dp = Vec3(self.d.x[ap], self.d.y[ap], self.d.z[ap])
        os_o = Vec3(mi[0] * op.x + mi[1] * op.y + mi[2] * op.z + mi[3],
                    mi[4] * op.x + mi[5] * op.y + mi[6] * op.z + mi[7],
                    mi[8] * op.x + mi[9] * op.y + mi[10] * op.z + mi[11])
        os_d = Vec3(mi[0] * dp.x + mi[1] * dp.y + mi[2] * dp.z,
                    mi[4] * dp.x + mi[5] * dp.y + mi[6] * dp.z,
                    mi[8] * dp.x + mi[9] * dp.y + mi[10] * dp.z)
        tp = self.t[ap]
        hs, ts_ = intersect.sphere(os_o, os_d, r[:, 16], tp)
        hb, tb_ = intersect.box(os_o, os_d,
                                Vec3(r[:, 17], r[:, 18], r[:, 19]), tp)
        sph = ptype == PRIM_SPHERE
        ph = torch.where(sph, hs, hb) & (prim_id != self.ign[ap])
        self.t[ap] = torch.where(ph, torch.where(sph, ts_, tb_), tp)
        self.prim[ap] = torch.where(ph, prim_id, self.prim[ap])
        self.tri[ap] = torch.where(ph, -1, self.tri[ap])
        if occlusion:
            self.sp[ap[ph]] = 0

    def result(self):
        stats = torch.stack([self.visits, self.tests])
        return (self.t, self.prim.to(torch.int32), self.tri.to(torch.int32),
                self.bv, self.bw, stats)


def wide_traverse_plain(rows, depth: int, o: Vec3, d: Vec3, t0, ign,
                        occlusion: bool):
    """Plain PyTorch version of ``wide_traverse``: every ray keeps an
    (N, cap) stack; each iteration pops one entry per ray that still has one
    and gathers one 64-float row for each of them."""
    w = _Walk(o, d, t0, ign, depth)
    slot = torch.arange(WIDE, device=t0.device)
    while (popped := w.pop()) is not None:
        a, node = popped
        if a.numel() == 0:
            continue
        row = rows[node]
        kind = row[:, 0].to(torch.int64)
        m = kind == KIND_INTERNAL
        if m.any():
            r = row[m]
            w.internal(a[m], r, r[:, 1].to(torch.int64)[:, None] + slot)
        m = kind == KIND_TRIS
        if m.any():
            w.leaf(a[m], row[m], WIDE_LEAF, occlusion)
        m = kind == KIND_PRIM
        if m.any():
            w.prims(a[m], row[m], occlusion)
    return w.result()


def split_traverse_plain(res, leaf, depth: int, o: Vec3, d: Vec3, t0, ign,
                         occlusion: bool,
                         leaf_reads: Optional[torch.Tensor] = None):
    """Plain PyTorch version of ``split_traverse``: the walk of
    ``wide_traverse_plain`` over signed links (>= 0: resident row, -(l+1):
    leaf row l).  An internal row's child links are lanes 50..57 and its
    child kinds the 2-bit fields of lane 58; EMPTY children (dropped padding
    and merged-away slots, whose link 0 is the root's) are never pushed.
    ``leaf_reads``, an int64 (L,) tensor, if given, counts the reads of
    every leaf row (the kernel reads the same rows)."""
    w = _Walk(o, d, t0, ign, depth)
    shift = 2 * torch.arange(WIDE, device=t0.device)
    while (popped := w.pop()) is not None:
        a, link = popped
        if a.numel() == 0:
            continue
        is_leaf = link < 0
        if is_leaf.any():
            lid = -link[is_leaf] - 1
            if leaf_reads is not None:
                leaf_reads.index_add_(0, lid, torch.ones_like(lid))
            w.leaf(a[is_leaf], leaf[lid], DMA_LEAF_K, occlusion)
        a, link = a[~is_leaf], link[~is_leaf]
        row = res[link]
        kind = row[:, 0].to(torch.int64)
        m = kind == KIND_INTERNAL
        if m.any():
            r = row[m]
            kinds = (r[:, 58].to(torch.int64)[:, None] >> shift) & 3
            w.internal(a[m], r, r[:, 50:50 + WIDE].to(torch.int64),
                       live=kinds != KIND_EMPTY)
        m = kind == KIND_PRIM
        if m.any():
            w.prims(a[m], row[m], occlusion)
    return w.result()
