"""device_idle_pct: the share of the traced frames' span (on the
profiler's one timeline, from the marker before the first frame to the
marker before the padding frame) in which no kernel, copy or set ran on
the device, in %."""

from benchmark.harness import stats


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device"]:
        return None
    return stats.idle_pct(tr)
