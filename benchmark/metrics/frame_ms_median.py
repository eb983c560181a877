"""frame_ms_median: the median frame of the window, in ms: a steadier
statistic beside the frame tail."""

import statistics


def read(rec):
    if not rec["frame_s"]:
        return None
    return statistics.median(rec["frame_s"]) * 1e3
