"""scene_pack_s: set-up seconds in ``Scene.pack`` (the tracer's
``scene_pack`` phase: the tables built on the host, split, uploaded; the
upload also creates the CUDA context).  ``pack_s`` less it is the scene
described through the ``Scene`` API."""

from benchmark.harness import program_trace as pt


def read(rec):
    return pt.phase_s("scene_pack")
