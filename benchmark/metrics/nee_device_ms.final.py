"""nee_device_ms: device ms a frame of the work launched inside the span
``pt.nee`` (each bounce's light and env samples and its shadow wave with
its walk), in the host-labelled stretch (``harness/program_trace.py``)."""

from benchmark.harness import program_trace as pt


def read(rec):
    return pt.span_ms(rec, "pt.nee")
