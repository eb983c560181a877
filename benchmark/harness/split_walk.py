"""The split walk (``split_traverse``, K4/K5) of scenes whose row table
passes the port's residence limit: its least bytes, and the program's own
counts of the walks in the traced frames.

While spans are on, the port's tracer keeps, for each split walk, its kernel
key, rays, live rays (t0 >= 0), leaf-row fetches (a lane fetching a row
counts once) and the distinct leaf rows it touched
(``FrameRecord.walk_counts``), counted by the walk itself.  A program
without those counts gives nothing to read: every function here then
returns None.

The least bytes of a split walk: ``stats.walk_bytes`` (52 B a live ray,
24 B a dead one, the resident rows once, 16 B of stats) and each distinct
leaf row it touched once, 512 B.  Every term is a byte that has to cross
HBM at least once, so the least time cannot exceed the walk's time.  (The
resident rows a walk touched are not counted: marking them in the walk
cost more than the 2% of its time that counting may take; PERF.md.)
"""

from __future__ import annotations

from typing import Dict, List, Optional

from . import program_trace, stats

LEAF_ROW_BYTES = 512  # 128 float32 lanes
SPLIT_KERNEL = "split_traverse"
WIDE_KEYS = ("closest", "occlusion")  # the unified walk's launch counters


def split_walk_bytes(rays: int, live: int, res_bytes: int,
                     leaf_rows: int) -> int:
    return (stats.walk_bytes(rays, live, res_bytes)
            + leaf_rows * LEAF_ROW_BYTES)


def _traced(rec) -> Optional[List]:
    recs = program_trace._window(rec)
    return None if recs is None else [r for r in recs if r.spans_on]


def traced_counts(rec) -> Optional[List[Dict]]:
    """The counts of every split walk of the window's traced frames (spans
    on), in launch order; None when the program keeps none."""
    out = []
    for r in _traced(rec) or []:
        if hasattr(r, "walk_counts"):
            out.extend(r.walk_counts())
    return out or None


def only_split_walks(rec) -> bool:
    """Did the traced frames walk the split tables alone (no launch of the
    unified walk)?"""
    recs = _traced(rec) or []
    return bool(recs) and not any(
        r.launches.get(k) for r in recs for k in WIDE_KEYS)


def kernel_us(rec) -> Optional[List[float]]:
    """The device us of each split walk kernel of the traced stretch, in
    launch order; None without a stretch or without split walks."""
    tr = rec.get("trace")
    if not tr or not tr.get("span"):
        return None
    us = [dur for name, cat, _, dur in tr["device"]
          if cat == "kernel" and SPLIT_KERNEL in name]
    return us or None


def stretch_walks(rec) -> Optional[List[Dict]]:
    """The traced stretch's split walks, each the harness's record of the
    call (rays, live rays, resident bytes) with the program's counts of
    the same walk (``leaf_rows``, ``leaf_fetches``): the program's counted
    walks whose rays and live rays run as the stretch's calls do, at one
    place only; None when they are not found once."""
    tr = rec.get("trace")
    counted = traced_counts(rec)
    if not tr or counted is None:
        return None
    calls = [c for c in tr["walks"] if c["kernel"] == SPLIT_KERNEL]
    if not calls:
        return None
    want = [(c["rays"], c["live"]) for c in calls]
    have = [(w["rays"], w["live"]) for w in counted]
    at = [i for i in range(len(have) - len(want) + 1)
          if have[i:i + len(want)] == want]
    if len(at) != 1:
        return None
    return [dict(c, leaf_rows=w["leaf_rows"], leaf_fetches=w["leaf_fetches"])
            for c, w in zip(calls, counted[at[0]:])]
