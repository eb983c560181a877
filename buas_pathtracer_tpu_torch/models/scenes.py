"""Built-in scenes of the port.

``build_bench_scene`` is the frame that the repository's ``bench.py``
measures (bench.py:68-95): three instances of a 20,480-triangle icosphere
(61,440 triangles), a box ground and two spherical lights, rendered with the
Advanced Pathtracer at 8 bounces and 1 spp.  ``build_stress_scene`` is
``bench.py``'s scale scene (bench.py:98-120, ``BENCH_SCENE=stress``): two
instances of a 327,680-triangle icosphere (655,360 triangles), a box ground
and one spherical light at 6 bounces; its unified row table exceeds the
residence limit, so it packs split tables and renders through the split
walk.  ``build_hero_scene`` is ``tools/hero_render.py``'s hero scene
(:17-67): three 20,480-triangle and seven 5,120-triangle icospheres, a box
ground, two spherical lights and the equirect sky ``gallery/hero_sky.hdr``,
at 8 bounces with environment-map NEE.  The JAX package's twelve built-in
scenes (its models/scenes.py) are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np

from ..core import vec
from ..utils.assets import load_environment_map
from ..utils.procgen import icosphere
from . import camera as cm
from .materials import Material
from .scene import Scene, SceneSettings


def build_bench_scene(w: int, h: int) -> Scene:
    sc = Scene(name="bench")
    ground = sc.add_diffuse_material((0.55, 0.55, 0.55), 1.0, 0.0, True)
    blue = sc.add_diffuse_material((0.25, 0.35, 0.8), 1.3)
    metal = sc.add_material(Material(albedo=(0.85, 0.85, 0.85), ior=1.5,
                                     metallic=1.0))
    glass = sc.add_translucent_material((0.3, 0.1, 0.05), 1.5)
    light = sc.add_emissive_material((80.0, 80.0, 72.0))

    mesh = icosphere(subdivisions=5)  # 20480 triangles
    sc.add_mesh(blue, mesh, vec.translate([0, 2.0, 0]) * vec.scale(2.0))
    sc.add_mesh(metal, mesh, vec.translate([-4.5, 1.5, 2]) * vec.scale(1.5))
    sc.add_mesh(glass, mesh, vec.translate([4.5, 1.5, -1]) * vec.scale(1.5))
    sc.add_box(ground, (30, 1, 30), vec.translate([0, -1.0, 0]))
    sc.add_sphere(light, 2.0, vec.translate([0, 14.0, 6]))
    sc.add_sphere(light, 1.0, vec.translate([-8, 10.0, -6]))

    cam = cm.make_camera(p=(0, 4, -12), vfov=np.radians(45), aspect=w / h)
    sc.camera = cm.aim_camera_at(cam, (0, 1.8, 0))
    sc.settings = SceneSettings(max_bounce_count=8, samples_per_pixel=1,
                                integrator="Advanced Pathtracer")
    return sc


def build_stress_scene(w: int, h: int) -> Scene:
    sc = Scene(name="stress")
    grey = sc.add_diffuse_material((0.6, 0.6, 0.6), 1.2)
    red = sc.add_diffuse_material((0.75, 0.25, 0.2), 1.4)
    light = sc.add_emissive_material((60.0, 60.0, 55.0))
    mesh = icosphere(subdivisions=7)  # 327,680 triangles
    sc.add_mesh(grey, mesh, vec.translate([-2.2, 2.0, 0]) * vec.scale(2.0))
    sc.add_mesh(red, mesh, vec.translate([2.2, 1.5, 1.0]) * vec.scale(1.5))
    sc.add_box(grey, (20, 1, 20), vec.translate([0, -1.0, 0]))
    sc.add_sphere(light, 1.5, vec.translate([0, 12.0, 4]))
    cam = cm.make_camera(p=(0, 3.5, -9), vfov=np.radians(50), aspect=w / h)
    sc.camera = cm.aim_camera_at(cam, (0, 1.8, 0))
    sc.settings = SceneSettings(max_bounce_count=6, samples_per_pixel=1,
                                integrator="Advanced Pathtracer")
    return sc


HERO_SKY = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "gallery", "hero_sky.hdr")


def build_hero_scene(w: int, h: int, env_path: str = HERO_SKY) -> Scene:
    """The hero scene with its environment map; raises when the map cannot
    be read (the scene is defined by its env lighting)."""
    sc = Scene(name="hero")
    ground = sc.add_diffuse_material((0.62, 0.6, 0.58), 1.1, 0.0, True)
    blue = sc.add_diffuse_material((0.2, 0.32, 0.78), 1.3)
    metal = sc.add_material(Material(albedo=(0.9, 0.82, 0.6), ior=1.5,
                                     metallic=1.0, roughness=0.04))
    glass = sc.add_translucent_material((0.25, 0.08, 0.04), 1.52)
    red = sc.add_diffuse_material((0.75, 0.12, 0.1), 1.4)
    light = sc.add_emissive_material((120.0, 110.0, 95.0))
    light2 = sc.add_emissive_material((40.0, 55.0, 90.0))

    hi = icosphere(subdivisions=5)  # 20,480 triangles
    lo = icosphere(subdivisions=4)  # 5,120 triangles
    sc.add_mesh(glass, hi, vec.translate([0.0, 2.1, 0.0]) * vec.scale(2.1))
    sc.add_mesh(metal, hi, vec.translate([-4.6, 1.6, 2.2]) * vec.scale(1.6))
    sc.add_mesh(blue, hi, vec.translate([4.4, 1.5, -0.8]) * vec.scale(1.5))
    for i in range(7):  # a ring of satellites
        a = i * 2 * np.pi / 7
        mat = (red, blue, metal)[i % 3]
        sc.add_mesh(mat, lo, vec.translate([6.5 * np.cos(a), 0.55,
                                            6.5 * np.sin(a)])
                    * vec.scale(0.55))
    sc.add_box(ground, (40, 1, 40), vec.translate([0, -1.0, 0]))
    sc.add_sphere(light, 1.6, vec.translate([5.0, 13.0, 7.0]))
    sc.add_sphere(light2, 1.0, vec.translate([-9.0, 8.0, -7.0]))

    env = load_environment_map(env_path)
    if env is None:
        raise FileNotFoundError(f"hero scene: cannot read the environment "
                                f"map {env_path}")
    sc.env_map = env

    cam = cm.make_camera(p=(0.5, 4.2, -12.5), vfov=np.radians(42),
                         aspect=w / h, lens_radius=0.12, focus_distance=12.5)
    sc.camera = cm.aim_camera_at(cam, (0, 1.9, 0))
    sc.settings = SceneSettings(max_bounce_count=8, samples_per_pixel=1,
                                env_nee=True)
    return sc
