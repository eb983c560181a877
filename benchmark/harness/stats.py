"""The benchmark's arithmetic: percentiles, the union of device
intervals, and the least time of the port's kernels from their bytes.

Peaks are NVIDIA's published figures for one H100 SXM at its full 700 W
(data sheet): HBM3 at 3.35 TB/s.  A roofline share is stated against them,
with the card's power limit beside it.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

PEAK_BYTES_PER_S = 3.35e12

# the walk's bytes (the port's own count for its traversal kernels): a live
# ray reads o, d, t0 and the ignored prim (32 B) and writes t, prim, tri,
# v, w (20 B); a dead ray (t0 < 0) reads t0 and writes its 20 B; the table
# is read once; the stats (16 B) are written once
WALK_LIVE_RAY_BYTES = 52
WALK_DEAD_RAY_BYTES = 24
WALK_STATS_BYTES = 16
# the post pass reads a float4 accumulation pixel and writes RGBA8
POST_PIXEL_BYTES = 20


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted, non-overlapping cover of the intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def covered(intervals) -> float:
    """Total length of the union of the intervals."""
    return sum(b - a for a, b in union(intervals))


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def launches_per_frame(tr) -> float:
    """Kernels, copies and sets a traced frame."""
    return len(tr["device"]) / tr["frames"]


def idle_pct(tr) -> float:
    """The share of the traced span in which nothing ran on the device."""
    lo, hi = tr["span"]
    busy = covered(clip([(ts, ts + dur) for _, _, ts, dur in tr["device"]],
                        lo, hi))
    return 100.0 * (1.0 - busy / (hi - lo))


def walk_bytes(rays: int, live: int, table_bytes: int) -> int:
    return (live * WALK_LIVE_RAY_BYTES + (rays - live) * WALK_DEAD_RAY_BYTES
            + table_bytes + WALK_STATS_BYTES)


def post_bytes(h: int, w: int) -> int:
    return h * w * POST_PIXEL_BYTES


def least_seconds(nbytes: int) -> float:
    """The least time HBM bandwidth allows for ``nbytes``."""
    return nbytes / PEAK_BYTES_PER_S
