"""shade_device_ms: device ms a frame of the bounces' shading: the work
launched inside the span ``pt.bounce`` and outside its child spans
(``pt.intersect``, ``pt.nee``, the live count's wait), in the
host-labelled stretch (``harness/program_trace.py``)."""

from benchmark.harness import program_trace as pt


def read(rec):
    return pt.span_ms(rec, "pt.bounce", own=True)
