"""Built-in scenes of the port.

The twelve built-in scene descriptions are the JAX package's
(``buas_pathtracer_tpu/models/scenes.py`` :75-350; reference
raytracer.cpp:798-1422): each is a function that fills a ``Scene``
(materials, primitives, camera, settings), registered in ``SCENES`` in the
reference's order.  ``load_scene`` applies the reference's defaults
(init_scene, raytracer.cpp:1424-1453) and then runs the description.
Asset files (``dragon_mcguire.obj``, ``*.hdr``) are looked up under
``DATA_DIR`` (``$BUAS_TPU_DATA``, else ``data/`` beside the package, read
once at import); a missing mesh is skipped and a missing HDR falls back to
the gradient sky.  Random content (the Week 7 box fields, the nested
marbles) comes from the JAX package's seeded numpy draws, so both packages
build the same scenes.

Beside them, three builders of the port's measured frames.
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
at 8 bounces with environment-map NEE.
"""

from __future__ import annotations

import math
import os
from dataclasses import replace
from typing import Callable, List, NamedTuple

import numpy as np

from ..core import vec
from ..core.vec import PI
from ..utils.assets import load_environment_map, load_mesh
from ..utils.procgen import icosphere
from . import camera as cm
from .materials import FLAG_CHECKERS, Material
from .scene import Scene, SceneSettings

DEG = math.pi / 180.0

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA_DIR = os.environ.get("BUAS_TPU_DATA", os.path.join(_ROOT, "data"))


def _data(name: str) -> str:
    return os.path.join(DATA_DIR, name)


def _camera(p, aim=None, at=None, vfov=60.0, aspect=16 / 9, lens_radius=0.0,
            focus_distance=1.0):
    c = cm.make_camera(p=p, vfov=DEG * vfov, aspect=aspect,
                       lens_radius=lens_radius, focus_distance=focus_distance)
    if at is not None:
        # aim_camera_at sets the focus distance to the target's distance
        c = cm.aim_camera_at(c, at)
    elif aim is not None:
        c = cm.aim_camera(c, aim)
    return c


def _load_mesh(scene: Scene, name: str):
    return load_mesh(_data(name), winding="ccw")


def _load_env(scene: Scene, name: str):
    scene.env_map = load_environment_map(_data(name))


T = vec.translate
S = vec.scale
RY = vec.rotate_y
RX = vec.rotate_x


# ---------------------------------------------------------------------------
# the twelve built-in scenes
# ---------------------------------------------------------------------------


def week_1_scene(sc: Scene, w: int, h: int):
    sc.camera = _camera((0, 4, -10), aim=(0, 0, -1), vfov=60, aspect=w / h)
    sc.settings = replace(sc.settings, lens_distortion=0.0, integrator="Whitted")
    sc.filter_name = "Box"
    sc.post_settings = replace(sc.post_settings, tonemapping=False)
    sc.ambient_light = (PI, PI, PI)
    ground = sc.add_diffuse_material((1, 1, 1), 1.0, 0.0, True, (0, 0, 0))
    sc.add_plane(ground, (0, 1, 0), 0.0)


def week_2_scene(sc: Scene, w: int, h: int):
    week_1_scene(sc, w, h)
    red = sc.add_diffuse_material((1.0, 0.0, 0.0), 1.0)
    sc.add_sphere(red, 4.0, T([0, 4, 0]))


def week_3_scene(sc: Scene, w: int, h: int):
    sc.camera = _camera((0, 4, -10), aim=(0, 0, -1), vfov=60, aspect=w / h)
    sc.settings = replace(sc.settings, lens_distortion=0.0, integrator="Whitted")
    sc.filter_name = "Box"
    sc.post_settings = replace(sc.post_settings, tonemapping=False)
    ground = sc.add_diffuse_material((1, 1, 1), 1.0, 0.0, True, (0, 0, 0))
    red = sc.add_diffuse_material((1.0, 0.0, 0.0), 1.0)
    light = sc.add_emissive_material((12500, 12500, 12500))
    sc.add_plane(ground, (0, 1, 0), 0.0)
    sc.add_sphere(red, 4.0, T([0, 4, 0]))
    sc.add_sphere(light, 0.1, T([8, 16, -8]))


def week_4_scene(sc: Scene, w: int, h: int):
    sc.camera = _camera((0, 4, -10), aim=(0, 0, -1), vfov=60, aspect=w / h)
    sc.settings = replace(sc.settings, lens_distortion=0.0, integrator="Whitted")
    sc.filter_name = "Box"
    sc.post_settings = replace(sc.post_settings, tonemapping=False)
    ground = sc.add_diffuse_material((1, 1, 1), 1.0, 0.0, True, (0, 0, 0))
    sphere = sc.add_material(Material(albedo=(0.5, 0.5, 0.5), ior=1.5,
                                      metallic=0.5, roughness=0.05))
    light = sc.add_emissive_material((12500, 12500, 12500))
    sc.add_plane(ground, (0, 1, 0), 0.0)
    sc.add_sphere(sphere, 4.0, T([0, 4, 0]))
    sc.add_sphere(light, 0.1, T([8, 16, -8]))


def week_5_scene(sc: Scene, w: int, h: int):
    sc.camera = _camera((-5, 8, -15), aim=(0, 0, -1), vfov=50, aspect=w / h)
    sc.settings = replace(sc.settings, lens_distortion=0.0, caustics=False,
                          max_bounce_count=12, integrator="Advanced Pathtracer")
    sc.filter_name = "Gaussian 3"
    sc.post_settings = replace(sc.post_settings, tonemapping=True)
    sc.bot_sky_color = sc.top_sky_color = (0.1, 0.7, 2.0)
    sc.ambient_light = sc.bot_sky_color
    ground = sc.add_diffuse_material((1.0, 0.0, 0.0), 1.0, 0.0, True, (1.0, 1.0, 0.0))
    glass = sc.add_translucent_material((0, 0, 0), 1.8)
    metal = sc.add_material(Material(albedo=(0.95, 0.95, 0.95), ior=1.5, metallic=0.8))
    air = sc.add_translucent_material((0, 0, 0), 1.0)
    light = sc.add_emissive_material((325000000, 325000000, 325000000))
    sc.add_box(ground, (16, 1, 20), T([0, -1.0, 16]))
    sc.add_sphere(glass, 4.0, T([-5, 8, 0]))
    sc.add_sphere(air, 3.8, T([-5, 8, 0]))
    sc.add_sphere(metal, 4.0, T([0, 5, 8]))
    sc.add_sphere(light, 10.0, T([-10000.0, 100000.0, -80000.0]))


def _cornellish_materials(sc: Scene):
    ground = sc.add_diffuse_material((0.55, 0.55, 0.55), 1.0)
    white = sc.add_diffuse_material((0.75, 0.75, 0.75), 1.1, 0.25)
    red = sc.add_diffuse_material((0.95, 0.1, 0.1), 1.0)
    green = sc.add_diffuse_material((0.1, 0.95, 0.1), 1.0)
    blue = sc.add_diffuse_material((0.1, 0.1, 0.95), 1.0)
    glass = sc.add_translucent_material((0.15, 0.15, 0.15), 1.5)
    sc.add_translucent_material((0.0, 0.1, 0.1), 1.6)  # red_material (unused)
    sc.add_translucent_material((0.0, 0.0, 0.0), 1.0)  # air (unused)
    return ground, white, red, green, blue, glass


def week_6_scene(sc: Scene, w: int, h: int):
    sc.camera = _camera((0, 7.5, -25), aim=(0, 0, -1), vfov=45, aspect=w / h,
                        lens_radius=10.0, focus_distance=19.77)
    sc.settings = replace(sc.settings, lens_distortion=0.0, integrator="Whitted")
    ground, white, red, green, blue, glass = _cornellish_materials(sc)
    metal = sc.add_material(Material(albedo=(0.85, 0.85, 0.85), ior=0.2, metallic=1.0))
    mixed = sc.add_material(Material(albedo=(0.05, 0.05, 0.95), ior=1.5, metallic=0.15))
    wlight = sc.add_emissive_material((60.0, 60.0, 60.0))
    sc.add_emissive_material((100.0, 20.0, 0.0))
    sc.add_emissive_material((6.0, 18.0, 30.0))
    sc.add_emissive_material((3.0, 30.0, 6.0))
    sc.add_box(metal, (2.0, 6.0, 2.0), T([-3, 3, 1]) * RY(-0.125 * PI))
    sc.add_sphere(glass, 2.0, T([-3, 2.3, -5]))
    sc.add_sphere(mixed, 2.0, T([3, 2.0, -4]))
    sc.add_plane(ground, (0, 1, 0), 0.0)
    sc.add_plane(ground, (0, -1, 0), -15.0)
    sc.add_plane(ground, (0, 0, -1), -8.0)
    sc.add_plane(blue, (0, 0, 1), -8.0)
    sc.add_plane(red, (1, 0, 0), -7.5)
    sc.add_plane(green, (-1, 0, 0), -7.5)
    sc.add_sphere(wlight, 1.5, T([0, 13.4, -2]))


def _box_field(sc: Scene, seed: int, nicer: bool):
    r = np.random.RandomState(seed)
    for x in range(-100, 101):
        for y in range(-100, 101):
            if -2 <= x <= 2 and -2 <= y <= 2:
                continue
            rnd = r.rand(4)
            rnd2 = r.rand(4)
            rnd3 = r.rand(4)
            albedo = (0.25 + 0.75 * rnd3[0], 0.25 + 0.75 * rnd3[1], 0.25 + 0.75 * rnd3[2])
            if nicer and 0.67 < rnd3[3] < 0.90:
                mat = sc.add_translucent_material(
                    (1.0 - albedo[0], 1.0 - albedo[1], 1.0 - albedo[2]), 1.5)
            elif nicer and rnd3[3] > 0.90:
                mat = sc.add_material(Material(albedo=albedo, ior=1.5, metallic=1.0))
            else:
                mat = sc.add_diffuse_material(albedo, 1.5, 0.25 if nicer else 0.75)
            m = T([2.0 * (-0.5 + rnd[0] + x), 1.0, 2.0 * (-0.5 + rnd[1] + y)]) \
                * RY(PI * rnd[2]) * RX(-0.25 + 0.5 * PI * rnd[3])
            sc.add_box(mat, (0.25 + rnd2[0], 0.5 + rnd2[1], 0.25 + rnd2[2]), m)


def week_7_scene(sc: Scene, w: int, h: int):
    sc.camera = _camera((0, 7.0, -15), at=(0, 0, 0), vfov=39, aspect=w / h,
                        lens_radius=0.0)
    sc.camera = sc.camera._replace(focus_distance=10.8)
    sc.settings = replace(sc.settings, lens_distortion=0.0, integrator="Whitted",
                          vignette_strength=0.0, caustics=False)
    sc.bot_sky_color = sc.top_sky_color = (0.2, 0.7, 0.95)
    sc.filter_name = "Gaussian 3"
    ground = sc.add_diffuse_material((0.55, 0.55, 0.55), 1.0)
    sphere = sc.add_material(Material(albedo=(0.85, 0.85, 0.85), ior=1.5, metallic=1.0))
    sc.add_plane(ground, (0, 1, 0), 0.0)
    sc.add_sphere(sphere, 1.0, T([0, 1.0, 0]))
    wlight = sc.add_emissive_material((30.0, 30.0, 30.0))
    sc.add_sphere(wlight, 30.0, T([-50, 100.0, -50]))
    _box_field(sc, seed=2, nicer=False)


def week_7_nicer_scene(sc: Scene, w: int, h: int):
    sc.camera = _camera((0, 8.0, -15), at=(0, 0, 0), vfov=39, aspect=w / h,
                        lens_radius=6.0)
    sc.camera = sc.camera._replace(focus_distance=10.8)
    sc.settings = replace(sc.settings, lens_distortion=-0.5, vignette_strength=1.0,
                          caustics=False, integrator="Advanced Pathtracer")
    sc.post_settings = replace(sc.post_settings, contrast=0.1)
    sc.bot_sky_color = sc.top_sky_color = (0.2, 0.7, 0.95)
    sc.filter_name = "Gaussian 3"
    ground = sc.add_diffuse_material((0.55, 0.55, 0.55), 1.0)
    sphere = sc.add_material(Material(albedo=(0.85, 0.85, 0.85), ior=1.5, metallic=1.0))
    sc.add_plane(ground, (0, 1, 0), 0.0)
    sc.add_sphere(sphere, 1.0, T([0, 1.0, 0]))
    wlight = sc.add_emissive_material((250.0, 175.0, 100.0))
    sc.add_sphere(wlight, 1000.0, T([-5000, 10000.0, -5000]))
    _box_field(sc, seed=1, nicer=True)


def cornell_box_scene(sc: Scene, w: int, h: int):
    sc.camera = _camera((0, 7.5, -25), aim=(0, 0, -1), vfov=45, aspect=w / h,
                        lens_radius=10.0, focus_distance=19.77)
    sc.settings = replace(sc.settings, lens_distortion=1.0,
                          integrator="Advanced Pathtracer")
    ground, white, red, green, blue, glass = _cornellish_materials(sc)
    metal = sc.add_material(Material(albedo=(0.85, 0.75, 0.45), ior=0.2, metallic=1.0))
    mixed = sc.add_material(Material(albedo=(0.05, 0.05, 0.95), ior=1.5, metallic=0.15))
    wlight = sc.add_emissive_material((60.0, 60.0, 60.0))
    sc.add_emissive_material((100.0, 20.0, 0.0))
    sc.add_emissive_material((6.0, 18.0, 30.0))
    sc.add_emissive_material((3.0, 30.0, 6.0))
    sc.add_box(metal, (2.5, 8.0, 2.5), T([-3, 4, 1]) * RY(-0.125 * PI))
    sc.add_box(metal, (0.5, 2.0, 0.5), T([-5, 2, -5]))
    sc.add_sphere(glass, 2.0, T([-5, 6.0, -5]))
    dragon = _load_mesh(sc, "dragon_mcguire.obj")
    if dragon is not None:
        sc.add_mesh(mixed, dragon, T([5, 2.0, -3]) * S(10.0) * RY(0.25 * PI))
    sc.add_plane(ground, (0, 1, 0), 0.0)
    sc.add_plane(ground, (0, -1, 0), -15.0)
    sc.add_plane(ground, (0, 0, -1), -8.0)
    sc.add_plane(red, (1, 0, 0), -10.5)
    sc.add_plane(green, (-1, 0, 0), -10.5)
    sc.add_sphere(wlight, 1.5, T([0, 13.4, -2]))


def dragon_scene(sc: Scene, w: int, h: int):
    sc.camera = _camera((-25, 6, 0), at=(1, 5, 0), vfov=40, aspect=w / h,
                        lens_radius=6.0)
    ground = sc.add_diffuse_material((0.55, 0.55, 0.55), 1.0, 0.0, True)
    sc.add_diffuse_material((0.55, 0.85, 0.55), 1.0, 0.0, True, (0.65, 0.15, 0.65))
    sc.add_diffuse_material((0.25, 0.35, 0.55), 1.3)
    blue_glass = sc.add_translucent_material((0.98, 0.35, 0.15), 1.5)
    red_glass = sc.add_translucent_material((0.15, 0.35, 0.95), 1.5)
    sc.add_translucent_material((0.98, 0.35, 0.15), 1.5)
    sc.add_translucent_material((0.0, 0.0, 0.0), 1.5)
    sc.add_translucent_material((0.0, 0.0, 0.0), 1.0)
    sc.add_translucent_material((0.0, 0.1, 0.2), 1.5)
    rough = sc.add_material(Material(albedo=(0.15, 0.5, 0.8), ior=1.3, roughness=0.75))
    metal = sc.add_material(Material(albedo=(0.85, 0.85, 0.85), metallic=1.0))
    wlight = sc.add_emissive_material((80.0, 80.0, 72.0))
    blight = sc.add_emissive_material((6.0, 18.0, 30.0))
    rlight = sc.add_emissive_material((100.0, 20.0, 0.0))
    sc.add_emissive_material((3.0, 30.0, 6.0))
    _load_env(sc, "ballroom_2k.hdr")
    dragon = _load_mesh(sc, "dragon_mcguire.obj")
    if dragon is not None:
        sc.add_mesh(blue_glass, dragon, T([0, 6.0, 0]) * S(14.0))
        sc.add_mesh(red_glass, dragon, T([-5, 3.7, 0]) * S(6.0))
        sc.add_mesh(rough, dragon, T([-5, 3.7, -7]) * S(6.0))
        sc.add_mesh(metal, dragon, T([-5, 3.7, 7]) * S(6.0))
    sc.add_box(ground, (10, 1, 10), T([0, 1.0, 0]))
    sc.add_box(ground, (40, 1, 40), T([8.0, -1.0, 0]))
    sc.add_sphere(blight, 2, T([-5.0, 25.0, 5]))
    sc.add_sphere(rlight, 2, T([5.0, 35.0, 8]))
    sc.add_sphere(wlight, 2, T([0.0, 15.0, 12]))


def platforms_scene(sc: Scene, w: int, h: int):
    sc.camera = _camera((0, 3, -18), at=(0, 0, 0), vfov=40, aspect=w / h,
                        lens_radius=10.0)
    sc.camera = sc.camera._replace(focus_distance=15.0)
    sc.settings = replace(sc.settings, lens_distortion=2.0, caustics=False)
    _load_env(sc, "boiler_room_2k.hdr")
    sc.add_diffuse_material((0.8, 0.1, 0.1), 1.0, 0.0, True, (0.8, 0.8, 0.1))
    marble = sc.add_translucent_material((0.5, 0.25, 0.0), 1.5)
    sc.add_diffuse_material((0.85, 0.85, 0.35), 1.5)
    sc.add_translucent_material((0.0, 0.0, 0.0), 1.0)
    pedestal = sc.add_diffuse_material((0.5, 0.5, 0.5), 1.0)
    checker = sc.add_material(Material(flags=FLAG_CHECKERS, albedo=(0.5, 0.5, 0.5),
                                       checker_color=(0.25, 0.25, 0.25), ior=1.1))
    for rough in (0.0, 0.10, 0.20, 0.4):
        sc.add_material(Material(albedo=(0.95, 0.95, 0.95), ior=1.5,
                                 metallic=1.0, roughness=rough))
    for x in (-9.0, -3.0, 3.0, 9.0):
        sc.add_sphere(marble, 2.5, T([x, 0.0, 0.0]))
    sc.add_box(checker, (50.0, 1.0, 50.0), T([0.0, -10.0, 0.0]))
    sc.add_box(pedestal, (10.0, 1.0, 10.0), T([-35.0, -6.5, 0.0]))
    sc.add_box(pedestal, (10.0, 1.0, 10.0), T([35.0, 3.5, 0.0]))
    sc.add_box(pedestal, (10.0, 1.0, 10.0), T([0.0, 9.5, -35.0]))
    sc.add_box(pedestal, (10.0, 1.0, 10.0), T([0.0, 0.5, 35.0]))
    pink = sc.add_emissive_material((500.0, 50.0, 500.0))
    red = sc.add_emissive_material((500.0, 50.0, 50.0))
    green = sc.add_emissive_material((50.0, 500.0, 50.0))
    blue = sc.add_emissive_material((50.0, 50.0, 500.0))
    sc.add_sphere(blue, 2, T([-35.0, 3.5, 0.0]))
    sc.add_sphere(red, 2, T([35.0, 13.5, 0.0]))
    sc.add_sphere(pink, 2, T([0.0, 19.5, -35.0]))
    sc.add_sphere(green, 2, T([0.0, 10.5, 35.0]))
    sc.add_sphere(green, 0.25, T([0.0, 20.0, 0.0]))


def nested_dielectrics_scene(sc: Scene, w: int, h: int):
    sc.camera = _camera((-25, 6, 0), at=(1, 5, 0), vfov=40, aspect=w / h,
                        lens_radius=6.0)
    sc.add_translucent_material((0.0, 0.0, 0.0), 1.5)
    sc.add_translucent_material((0.6, 0.3, 0.0), 1.5)
    sc.add_translucent_material((0.0, 0.0, 0.0), 1.0)
    ground = sc.add_diffuse_material((0.55, 0.55, 0.55), 1.0, 0.0, True)
    wlight = sc.add_emissive_material((80.0, 80.0, 72.0))
    _load_env(sc, "epping_forest_02_2k.hdr")
    sc.add_box(ground, (10, 1, 10), T([0, 1.0, 0]))
    sc.add_box(ground, (40, 1, 40), T([8.0, -1.0, 0]))
    floor_height = 2.0
    r = np.random.RandomState(0xD1CE)  # reference seeds from SDL_GetTicks()
    marble_count = int(r.randint(20, 40))
    for _ in range(marble_count):
        absorption = 0.25 + 0.75 * r.rand(3)
        marble_mat = sc.add_translucent_material(tuple(absorption), 1.5)
        mx, mz = 8.0 * (2.0 * r.rand(2) - 1.0)
        radius = 0.6 + r.rand()
        mp = np.array([mx, floor_height + radius, mz])
        sc.add_sphere(marble_mat, radius, T(mp))
        for _b in range(int(r.randint(5, 12))):
            r1 = 2.0 * r.rand(4) - 1.0
            br = 0.05 + (0.5 + 0.5 * r1[3]) * 0.15
            max_off = radius - br - 0.05
            off = max_off * r.rand()
            bp = mp + off * r1[:3]
            sc.add_sphere(ground, br, T(bp))
    sc.add_sphere(wlight, 2, T([0.0, 15.0, 12]))


class SceneDescription(NamedTuple):
    name: str
    f: Callable


SCENES: List[SceneDescription] = [
    SceneDescription("Dragon", dragon_scene),
    SceneDescription("Cornell Box", cornell_box_scene),
    SceneDescription("Floating Platforms", platforms_scene),
    SceneDescription("Nested Dielectrics", nested_dielectrics_scene),
    SceneDescription("Week 1", week_1_scene),
    SceneDescription("Week 2", week_2_scene),
    SceneDescription("Week 3", week_3_scene),
    SceneDescription("Week 4", week_4_scene),
    SceneDescription("Week 5", week_5_scene),
    SceneDescription("Week 6", week_6_scene),
    SceneDescription("Week 7", week_7_scene),
    SceneDescription("Week 7, Nicer", week_7_nicer_scene),
]


def find_scene(name: str) -> SceneDescription:
    for s in SCENES:
        if s.name == name:
            return s
    return SCENES[0]


def load_scene(name_or_desc, w: int, h: int) -> Scene:
    """clear_scene + init_scene defaults + description (load_scene,
    raytracer.cpp:1455-1470)."""
    desc = (name_or_desc if isinstance(name_or_desc, SceneDescription)
            else find_scene(str(name_or_desc)))
    sc = Scene(name=desc.name)
    sc.filter_name = "Mitchell Netravali"  # init_scene default
    sc.camera = cm.make_camera(aspect=w / h)
    desc.f(sc, w, h)
    return sc


# ---------------------------------------------------------------------------
# the port's measured frames
# ---------------------------------------------------------------------------


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


HERO_SKY = os.path.join(_ROOT, "gallery", "hero_sky.hdr")


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
