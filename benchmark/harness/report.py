"""The run's result line: the cell's metrics from their readers, the
device, the traced breakdown, and the compared numbers beside their
limits."""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import Dict

from . import stats
from .trace import FRAME


def metrics(cell, rec: Dict, trace: bool) -> Dict:
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]].read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(tr: Dict, labelled: Dict) -> Dict:
    """The device operations that took most time in the traced frames, and
    the device's idle time by what the host was doing then (the innermost
    host event over each gap's middle) in the frames that recorded the
    host, in seconds."""
    ops = defaultdict(float)
    for name, _, _, dur in tr["device"]:
        ops[name] += dur * 1e-6
    idle = defaultdict(float)
    host = sorted((h[2], h[2] + h[3], h[0]) for h in labelled["host"]
                  if h[0] != FRAME)
    starts = [h[0] for h in host]
    for a, b in stats.gaps([(ts, ts + dur)
                            for _, _, ts, dur in labelled["device"]],
                           *labelled["span"]):
        mid = 0.5 * (a + b)
        # host events nest, so the innermost one over ``mid`` is the
        # latest-starting one that still runs then
        label = "no host event (Python between calls)"
        for i in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 257), -1):
            if host[i][1] >= mid:
                label = host[i][2]
                break
        idle[label] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def result(cell, rec: Dict, trace: bool, kind: str, count: int) -> Dict:
    v = rec["verdict"]
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": bool(v["correct"]), "attempted": rec["frames"],
           "failed": 0, "metrics": metrics(cell, rec, trace),
           "device": device}
    tr = rec.get("trace")
    if trace and tr and tr["span"]:
        span = tr["span"]
        device["busy_s"] = stats.covered(stats.clip(
            [(ts, ts + dur) for _, _, ts, dur in tr["device"]],
            *span)) * 1e-6
        device["window_s"] = (span[1] - span[0]) * 1e-6
        device["power_limit_w"] = rec.get("power_limit_w")
        if rec.get("labelled") and rec["labelled"]["span"]:
            out["breakdown"] = breakdown(tr, rec["labelled"])
    out["checks"] = {k: {"value": v["values"][k], "limit": v["limits"][k]}
                     for k in v.get("values", {})}
    return out


def print_checks(out: Dict) -> None:
    """The compared numbers beside their limits, as the last lines on
    standard error."""
    print(f"correct {out['correct']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
