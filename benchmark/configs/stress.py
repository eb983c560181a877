"""Configuration ``stress``: the project's large-mesh benchmark frame.

Source: the repository's ``bench.py`` (:98-120, ``build_stress_scene``,
``BENCH_SCENE=stress``), the scale scene the project documents beside its
benchmark frame.  Two instances of a 327,680-triangle icosphere (655,360
triangles: grey and red diffuse), a box ground and one sphere light, seen by
a pinhole camera; the Advanced Pathtracer with NEE, MIS and Russian
roulette at 6 bounces, the stratified sampler and the Mitchell-Netravali
filter.  Its unified row table passes the port's residence limit, so the
scene packs split tables (resident rows and merged leaf rows) and every
wave takes ``split_traverse``; those tables and the per-triangle normal
rows are together larger than the H100's L2.  Nothing is cut.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import scene_data as sd

SOURCE = ("tpu-pathtracer bench.py:98-120 build_stress_scene, the project's "
          "documented large-mesh frame (two 327,680-triangle icospheres, box "
          "ground, one sphere light, 6 bounces)")
REDUCED: list = []
ASSUMED = {}


def describe(w: int, h: int) -> sd.SceneData:
    return scene(w, h, subdivisions=7)  # 327,680 triangles a mesh


def scene(w: int, h: int, subdivisions: int) -> sd.SceneData:
    """The stress scene with its icosphere subdivided ``subdivisions``
    times (the source's 7; the CPU tests take a coarser one)."""
    sc = sd.SceneData(name="stress")
    grey = sc.add_material(sd.diffuse((0.6, 0.6, 0.6), 1.2))
    red = sc.add_material(sd.diffuse((0.75, 0.25, 0.2), 1.4))
    light = sc.add_material(sd.emissive((60.0, 60.0, 55.0)))

    tri, nrm = sd.icosphere(subdivisions)
    mesh = sc.add_mesh_data(tri, nrm)
    sc.add_mesh(grey, mesh, sd.compose(sd.translate([-2.2, 2.0, 0]),
                                       sd.scale(2.0)))
    sc.add_mesh(red, mesh, sd.compose(sd.translate([2.2, 1.5, 1.0]),
                                      sd.scale(1.5)))
    sc.add_box(grey, (20, 1, 20), sd.translate([0, -1.0, 0]))
    sc.add_sphere(light, 1.5, sd.translate([0, 12.0, 4]))

    sc.camera = sd.camera((0, 3.5, -9), vfov=np.radians(50), aspect=w / h,
                          at=(0, 1.8, 0))
    sc.settings = dict(max_bounce_count=6, samples_per_pixel=1,
                       integrator="Advanced Pathtracer")
    return sc
