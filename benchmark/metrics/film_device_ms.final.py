"""film_device_ms: device ms a frame of the work launched inside the span
``pt.film`` (the pass's splat and accumulation), in the host-labelled
stretch (``harness/program_trace.py``)."""

from benchmark.harness import program_trace as pt


def read(rec):
    return pt.span_ms(rec, "pt.film")
