"""Binary BVH construction (host, numpy).

Counterpart of ``buas_pathtracer_tpu/ops/bvh.py`` (``build_bvh`` and
``BuildNodes``): a Wald-2007 binned-SAH build (reference bvh.cpp:138-213)
with the midpoint and full-sweep SAH variants.  The default method runs the
native C++ builder (``native/``); the numpy path below is the fallback when
no toolchain is present.  The two give different trees (the JAX package's
test accepts 99.5% hit agreement between them), so byte-equal tables need
the native builder in both packages.

The threaded skip-link flattener of the JAX package is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

N_BINS = 16
MAX_LEAF_SIZE = 4


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


def _sa(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])
