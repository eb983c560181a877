"""live_lane_pct: live lanes over the lanes each bounce ran at, summed
over every bounce of the window's untraced frames (the frame record's
``bounces``), in %."""

from benchmark.harness import program_trace as pt


def read(rec):
    recs = pt.untraced(rec)
    if not recs:
        return None
    lanes = sum(n for r in recs for _, n, _ in r.bounces)
    live = sum(k for r in recs for _, _, k in r.bounces)
    return 100.0 * live / lanes if lanes else None
