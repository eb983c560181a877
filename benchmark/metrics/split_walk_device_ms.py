"""split_walk_device_ms: device ms a frame of the work launched inside the
``pt.walk`` spans of the traced frames (``harness/program_trace.py``), when
every walk there is a split walk (``split_traverse``, K4/K5: the frames
launch no unified walk); None unless the program counted its split walks
there (``harness/split_walk.py``)."""

from benchmark.harness import program_trace as pt
from benchmark.harness import split_walk


def read(rec):
    if split_walk.traced_counts(rec) is None or \
            not split_walk.only_split_walks(rec):
        return None
    return pt.span_ms(rec, "pt.walk")
