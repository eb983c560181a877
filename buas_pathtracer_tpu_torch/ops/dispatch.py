"""Wave ordering: sort keys, the root prefilter and the traversal routes.

Counterpart of the dispatch layer of ``buas_pathtracer_tpu/ops/
pallas_packet.py``: ``_morton_key`` (:1719), ``_key6d`` (:1744),
``_compact_key`` (:1778) with its three ``BUAS_COMPACT_KEY`` layouts,
``root_prefilter`` (:1809) and ``block_coherence`` (:1842), all bit-exact,
and the routes of ``traverse_dispatch`` (:1890) in the port's terms.  Keys
are int32 tensors holding the JAX package's int32 values.

A wave goes to the walk kernel (``packet.wide_traverse``, or
``packet.split_traverse`` when the scene packed split tables) by one of
two routes:

- ``walk``, the natural route: the rays in the caller's order (pixel tiles
  for primary and bounce-0 shadow rays, the stage entry's key order inside
  the staged loop of ``integrators/advanced.py``).  Every wave of the port
  takes it;
- ``walk_sorted``, the key-sorted route: rays that pass ``root_prefilter``
  sorted by ``_compact_key``, moved with one packed gather, walked, and
  moved back with one gather; prefiltered and dead rays keep the miss
  outputs.  It returns ``walk``'s outputs for every ray.  On the H100 the
  sort and the two gathers cost more than the walk gains from the order
  (``chip_smoke.py --turns``, PERF.md), so no wave of the port takes it.

The JAX package's TPU routing (compaction rungs, ladders, the VMEM budget)
has no counterpart: the walk kernels fetch live rays themselves.
"""

from __future__ import annotations

import os

import torch

from ..core.vec import Vec3
from ..utils import trace
from . import intersect, packet
from .wide_bvh import KIND_INTERNAL, WIDE

BLOCK = 1024  # rays per coherence block (the JAX kernels' (8, 128) block)
DEAD_KEY = 0x7FFFFFFF
PREFILTERED_KEY = 0x7FFFFFFE


def _spread_table(bits: int, shifts) -> torch.Tensor:
    """(2^bits,) int64: bit b of the index moved to bit shifts[b]."""
    t = [0] * (1 << bits)
    for v in range(1 << bits):
        for b in range(bits):
            t[v] |= ((v >> b) & 1) << shifts[b]
    return torch.tensor(t, dtype=torch.int64)


# Morton: bit b of an axis to bit 3b.  6-D key: position bit b to bit
# 3 + b (b = 0), 9 (b = 1), 6 + 3b (b >= 2), direction bit b to bit 6b
# (the JAX package's interleave loop, each table for axis 0; axis i
# shifts left by i)
_MORTON8 = _spread_table(8, [3 * b for b in range(8)])
_POS6 = _spread_table(6, [3, 9, 12, 15, 18, 21])
_DIR2 = _spread_table(2, [0, 6])
_AXIS = torch.arange(3)[:, None]


def _quantize(o: Vec3, lo, hi, bits: int):
    """(3, N) int64: clip((c - lo) / ext * 2^bits, 0, 2^bits - 1),
    truncated, ext = max(hi - lo, 1e-6)."""
    lo = lo.to(torch.float32)[:, None]
    ext = torch.clamp(hi.to(torch.float32)[:, None] - lo, min=1e-6)
    o3 = torch.stack([o.x, o.y, o.z])
    return torch.clamp((o3 - lo) / ext * float(1 << bits), 0.0,
                       float((1 << bits) - 1)).to(torch.int64)


def _octant(d: Vec3):
    return ((d.x < 0).to(torch.int64) * 4 + (d.y < 0).to(torch.int64) * 2
            + (d.z < 0).to(torch.int64))


def _interleave(table, q):
    """OR over the three axes of table[q[i]] << i."""
    s = (trace.wait("key_tables", table.to, q.device)[q]
         << trace.wait("key_tables", _AXIS.to, q.device))
    return s[0] | s[1] | s[2]


def _morton_key(o: Vec3, d: Vec3, lo, hi):
    """8 bits an axis Morton code of the origin, direction octant minor:
    27 bits."""
    m = _interleave(_MORTON8, _quantize(o, lo, hi, 8))
    return ((m << 3) | _octant(d)).to(torch.int32)


def _key6d(o: Vec3, d: Vec3, lo, hi):
    """6-D Morton: 6 bits an axis of position and 2 bits an axis of
    direction, interleaved with the direction bits at the fine end: 24
    bits."""
    d3 = torch.stack([d.x, d.y, d.z])
    dq = torch.clamp((d3 * 0.5 + 0.5) * 4.0, 0.0, 3.0).to(torch.int64)
    out = (_interleave(_POS6, _quantize(o, lo, hi, 6))
           | _interleave(_DIR2, dq))
    return out.to(torch.int32)


def _compact_key(o: Vec3, d: Vec3, ign, lo, hi, occlusion: bool = False):
    """Sort key with the ignored prim's id (the sampled light of a shadow
    wave, -1 otherwise) in the major bits; ``ign`` None means -1.
    ``BUAS_COMPACT_KEY`` picks the layout: ``m6d`` (closest-hit default,
    ``_key6d``), ``oct_major`` (occlusion default: the octant ORed over the
    Morton code's top bits, bit-exact to the JAX package's form) or
    ``morton``."""
    mode = os.environ.get("BUAS_COMPACT_KEY",
                          "oct_major" if occlusion else "m6d")
    if mode == "m6d":
        mk = _key6d(o, d, lo, hi)
    else:
        mk = _morton_key(o, d, lo, hi)
        if mode == "oct_major":
            mk = ((mk & 7) << 18) | (mk >> 3)
    if ign is None:
        return mk
    return (((ign.to(torch.int32) + 1) & 0xF) << 27) | mk


def root_prefilter(rows, o: Vec3, d: Vec3, t0):
    """Slab test of the root's children: False for rays that hit none of
    them, which the walk's first pop would also find (the walk's own test
    adds conditions, so this keeps every ray the walk could hit).  A root
    that is not an internal row keeps every ray."""
    box = rows[0, 2:2 + 6 * WIDE].reshape(WIDE, 6)[:, :, None]  # (8, 6, 1)
    o3 = torch.stack([o.x, o.y, o.z])
    d3 = torch.stack([d.x, d.y, d.z])
    inv = torch.where(d3 >= 0.0, 1.0, -1.0) / torch.clamp(
        torch.abs(d3), min=intersect._INV_DIR_EPS)  # safe_inv_dir
    t1 = (box[:, 0:3] - o3) * inv  # (8, 3, N)
    t2 = (box[:, 3:6] - o3) * inv
    tn = torch.minimum(t1, t2).amax(dim=1)
    tf = torch.maximum(t1, t2).amin(dim=1)
    hit = ((tn < tf) & (tf > 0.0) & (tn < t0)).any(dim=0)
    return hit | (rows[0, 0] != KIND_INTERNAL)


def block_coherence(d: Vec3, t0):
    """Mean resultant length of the live directions within 1024-ray
    blocks, weighted by their live counts: ~1 for primary and shadow fans,
    ~0.3 for diffuse bounces.  A partial tail block is ignored."""
    nfull = (int(t0.shape[0]) // BLOCK) * BLOCK
    lf = (t0[:nfull] >= 0.0).to(torch.float32).reshape(-1, BLOCK)
    s = [(c[:nfull].reshape(-1, BLOCK) * lf).sum(dim=1)
         for c in (d.x, d.y, d.z)]
    cnt = lf.sum(dim=1)
    rlen = torch.sqrt(s[0] * s[0] + s[1] * s[1] + s[2] * s[2]) \
        / torch.clamp(cnt, min=1.0)
    return (rlen * cnt).sum() / torch.clamp(cnt.sum(), min=1.0)


def walk(ps, o: Vec3, d: Vec3, t0, ign, occlusion: bool):
    """The natural route: one wave in the caller's order through the
    scene's walk kernel (its plain version on CPU tensors).  o, d (N,)
    float32 contiguous, t0 (N,) float32, ign (N,) int32.  Returns (t, prim
    int32, tri int32, bv, bw, stats (2,) int64), the walk kernel's
    outputs."""
    if ps.v4_res is not None:
        return packet.split_traverse(ps.v4_res, ps.v4_leaf, ps.wide_depth,
                                     o, d, t0, ign, occlusion)
    return packet.wide_traverse(ps.wide_rows, ps.wide_depth, o, d, t0, ign,
                                occlusion)


def walk_sorted(ps, o: Vec3, d: Vec3, t0, ign, occlusion: bool):
    """The key-sorted route: ``walk``'s inputs and outputs, the live rays
    walked in ``_compact_key`` order."""
    live = (t0 >= 0.0) & root_prefilter(ps.wide_rows, o, d, t0)
    key = torch.where(live, _compact_key(o, d, ign, ps.scene_lo, ps.scene_hi,
                                         occlusion=occlusion),
                      torch.full_like(ign, DEAD_KEY))
    ids = torch.argsort(key, stable=True)
    # the columns move as int32 bit patterns, one gather each way
    i32, f32 = torch.int32, torch.float32
    cols = torch.stack([c.view(i32) for c in (
        o.x, o.y, o.z, d.x, d.y, d.z, torch.where(live, t0, -1.0))]
        + [ign]).index_select(1, ids)
    f = cols[:7].view(f32)
    out = walk(ps, Vec3(f[0], f[1], f[2]), Vec3(f[3], f[4], f[5]), f[6],
               cols[7], occlusion)
    inv = torch.empty_like(ids).scatter_(
        0, ids, torch.arange(ids.shape[0], device=ids.device))
    back = torch.stack([out[0].view(i32), out[1], out[2], out[3].view(i32),
                        out[4].view(i32)]).index_select(1, inv)
    t = torch.where(live, back[0].view(f32), t0)
    return (t, back[1], back[2], back[3].view(f32), back[4].view(f32),
            out[5])
