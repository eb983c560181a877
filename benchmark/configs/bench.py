"""Configuration ``bench``: the project's documented benchmark frame.

Source: the repository's ``bench.py`` (:68-95), the frame the project has
measured since its first release.  Three instances of a 20,480-triangle
icosphere (61,440 triangles: diffuse blue, metal, and glass with Beer
absorption), a checkered box ground and two sphere lights, seen by a pinhole
camera; the Advanced Pathtracer with NEE, MIS and Russian roulette at 8
bounces, the stratified sampler and the Mitchell-Netravali filter.  Its row
table (5.25 MB) stays resident, so every wave takes ``wide_traverse``.
Nothing is cut.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import scene_data as sd

SOURCE = ("tpu-pathtracer bench.py:68-95, the project's documented benchmark "
          "frame (three 20,480-triangle icospheres, box ground, two sphere "
          "lights, 8 bounces)")
REDUCED: list = []
ASSUMED = {}


def describe(w: int, h: int) -> sd.SceneData:
    sc = sd.SceneData(name="bench")
    ground = sc.add_material(sd.diffuse((0.55, 0.55, 0.55), 1.0, 0.0, True))
    blue = sc.add_material(sd.diffuse((0.25, 0.35, 0.8), 1.3))
    metal = sc.add_material(sd.material(albedo=(0.85, 0.85, 0.85), ior=1.5,
                                        metallic=1.0))
    glass = sc.add_material(sd.translucent((0.3, 0.1, 0.05), 1.5))
    light = sc.add_material(sd.emissive((80.0, 80.0, 72.0)))

    tri, nrm = sd.icosphere(subdivisions=5)  # 20,480 triangles
    mesh = sc.add_mesh_data(tri, nrm)
    sc.add_mesh(blue, mesh, sd.compose(sd.translate([0, 2.0, 0]),
                                       sd.scale(2.0)))
    sc.add_mesh(metal, mesh, sd.compose(sd.translate([-4.5, 1.5, 2]),
                                        sd.scale(1.5)))
    sc.add_mesh(glass, mesh, sd.compose(sd.translate([4.5, 1.5, -1]),
                                        sd.scale(1.5)))
    sc.add_box(ground, (30, 1, 30), sd.translate([0, -1.0, 0]))
    sc.add_sphere(light, 2.0, sd.translate([0, 14.0, 6]))
    sc.add_sphere(light, 1.0, sd.translate([-8, 10.0, -6]))

    sc.camera = sd.camera((0, 4, -12), vfov=np.radians(45), aspect=w / h,
                          at=(0, 1.8, 0))
    sc.settings = dict(max_bounce_count=8, samples_per_pixel=1,
                       integrator="Advanced Pathtracer")
    return sc
