"""The project's ``hero`` frame as plain data, for the tests of the
environment-lit check (no cell renders it yet).

The program's ``models/scenes.build_hero_scene``: three 20,480-triangle
icospheres (glass with Beer absorption, gold metal, blue diffuse), a ring
of seven 5,120-triangle satellites, a checkered 40 x 40 box ground and two
sphere lights, lit by the equirect map ``gallery/hero_sky.hdr`` with env
NEE, seen through a thin lens; the Advanced Pathtracer at 8 bounces.
``subdivisions`` coarsens the icospheres for the CPU tests; the source's
are (5, 4).
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import scene_data as sd

ENV_PATH = "gallery/hero_sky.hdr"


def describe(w: int, h: int, subdivisions=(5, 4)) -> sd.SceneData:
    sc = sd.SceneData(name="hero", env_path=ENV_PATH)
    ground = sc.add_material(sd.diffuse((0.62, 0.6, 0.58), 1.1, 0.0, True))
    blue = sc.add_material(sd.diffuse((0.2, 0.32, 0.78), 1.3))
    metal = sc.add_material(sd.material(albedo=(0.9, 0.82, 0.6), ior=1.5,
                                        metallic=1.0, roughness=0.04))
    glass = sc.add_material(sd.translucent((0.25, 0.08, 0.04), 1.52))
    red = sc.add_material(sd.diffuse((0.75, 0.12, 0.1), 1.4))
    light = sc.add_material(sd.emissive((120.0, 110.0, 95.0)))
    light2 = sc.add_material(sd.emissive((40.0, 55.0, 90.0)))

    hi = sc.add_mesh_data(*sd.icosphere(subdivisions[0]))
    lo = sc.add_mesh_data(*sd.icosphere(subdivisions[1]))
    sc.add_mesh(glass, hi, sd.compose(sd.translate([0.0, 2.1, 0.0]),
                                      sd.scale(2.1)))
    sc.add_mesh(metal, hi, sd.compose(sd.translate([-4.6, 1.6, 2.2]),
                                      sd.scale(1.6)))
    sc.add_mesh(blue, hi, sd.compose(sd.translate([4.4, 1.5, -0.8]),
                                     sd.scale(1.5)))
    for i in range(7):  # the ring of satellites
        a = i * 2 * np.pi / 7
        sc.add_mesh((red, blue, metal)[i % 3], lo, sd.compose(
            sd.translate([6.5 * np.cos(a), 0.55, 6.5 * np.sin(a)]),
            sd.scale(0.55)))
    sc.add_box(ground, (40, 1, 40), sd.translate([0, -1.0, 0]))
    sc.add_sphere(light, 1.6, sd.translate([5.0, 13.0, 7.0]))
    sc.add_sphere(light2, 1.0, sd.translate([-9.0, 8.0, -7.0]))

    sc.camera = sd.camera((0.5, 4.2, -12.5), vfov=np.radians(42),
                          aspect=w / h, lens_radius=0.12,
                          focus_distance=12.5, at=(0, 1.9, 0))
    sc.settings = dict(max_bounce_count=8, samples_per_pixel=1, env_nee=True)
    return sc
