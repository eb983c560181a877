"""dither_tile_s: set-up seconds making the post pass's blue-noise
dither tile, once a process (the tracer's ``dither_tile`` phase)."""

from benchmark.harness import program_trace as pt


def read(rec):
    return pt.phase_s("dither_tile")
