"""Configuration ``week7_nicer``: upstream BUAS-Pathtracer's built-in scene
"Week 7, Nicer" (raytracer.cpp's scene list).

A field of 40,376 rotated boxes drawn from ``RandomState(1)`` (diffuse,
translucent at IOR 1.5 with Beer absorption, and metal), a metal sphere, a
ground plane and a distant sun sphere light; the Advanced Pathtracer at 12
bounces, a thin lens (radius 6, focus 10.8), lens distortion -0.5,
vignette 1.0, the Gaussian 3 filter and post contrast 0.1.  Its row table
(106,489 rows, 27.26 MB) stays resident.  It shares the integrator and the
walks with ``bench``, but its hits are boxes, its paths are deeper and its
glass boxes drive the dielectric stack.  Nothing is cut.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.harness import scene_data as sd

SOURCE = ("https://github.com/TheSandvichMaker/BUAS-Pathtracer raytracer.cpp "
          "built-in scene list: \"Week 7, Nicer\"")
REDUCED: list = []
ASSUMED = {}

DEG = math.pi / 180.0
PI = float(np.pi)


def _box_field(sc: sd.SceneData, seed: int):
    """The nicer box field: 201 x 201 cells less the 5 x 5 around the
    origin, one box a cell, every draw from one seeded stream."""
    r = np.random.RandomState(seed)
    for x in range(-100, 101):
        for y in range(-100, 101):
            if -2 <= x <= 2 and -2 <= y <= 2:
                continue
            rnd = r.rand(4)
            rnd2 = r.rand(4)
            rnd3 = r.rand(4)
            albedo = (0.25 + 0.75 * rnd3[0], 0.25 + 0.75 * rnd3[1],
                      0.25 + 0.75 * rnd3[2])
            if 0.67 < rnd3[3] < 0.90:
                mat = sc.add_material(sd.translucent(
                    (1.0 - albedo[0], 1.0 - albedo[1], 1.0 - albedo[2]), 1.5))
            elif rnd3[3] > 0.90:
                mat = sc.add_material(sd.material(albedo=albedo, ior=1.5,
                                                  metallic=1.0))
            else:
                mat = sc.add_material(sd.diffuse(albedo, 1.5, 0.25))
            xf = sd.compose(
                sd.translate([2.0 * (-0.5 + rnd[0] + x), 1.0,
                              2.0 * (-0.5 + rnd[1] + y)]),
                sd.rotate_y(PI * rnd[2]),
                sd.rotate_x(-0.25 + 0.5 * PI * rnd[3]))
            sc.add_box(mat, (0.25 + rnd2[0], 0.5 + rnd2[1], 0.25 + rnd2[2]),
                       xf)


def describe(w: int, h: int) -> sd.SceneData:
    sc = sd.SceneData(name="Week 7, Nicer", filter_name="Gaussian 3")
    cam = sd.camera((0, 8.0, -15), vfov=DEG * 39, aspect=w / h,
                    lens_radius=6.0, at=(0, 0, 0))
    cam["focus_distance"] = 10.8
    sc.camera = cam
    sc.settings = dict(lens_distortion=-0.5, vignette_strength=1.0,
                       caustics=False, integrator="Advanced Pathtracer")
    sc.post = dict(contrast=0.1)
    sc.sky_top = sc.sky_bot = (0.2, 0.7, 0.95)
    ground = sc.add_material(sd.diffuse((0.55, 0.55, 0.55), 1.0))
    sphere = sc.add_material(sd.material(albedo=(0.85, 0.85, 0.85), ior=1.5,
                                         metallic=1.0))
    sc.add_plane(ground, (0, 1, 0), 0.0)
    sc.add_sphere(sphere, 1.0, sd.translate([0, 1.0, 0]))
    sun = sc.add_material(sd.emissive((250.0, 175.0, 100.0)))
    sc.add_sphere(sun, 1000.0, sd.translate([-5000, 10000.0, -5000]))
    _box_field(sc, seed=1)
    return sc
