"""frame_ms_p95: the 95th percentile of every frame of the window, in ms;
a frame runs from its start to its RGBA8 image on the host."""

from benchmark.harness import stats


def read(rec):
    if not rec["frame_s"]:
        return None
    return stats.percentile(rec["frame_s"], 95) * 1e3
