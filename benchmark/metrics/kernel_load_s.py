"""kernel_load_s: set-up seconds loading, or building, the port's
kernel library and its native host library (the tracer's ``kernel_load``
phase)."""

from benchmark.harness import program_trace as pt


def read(rec):
    return pt.phase_s("kernel_load")
