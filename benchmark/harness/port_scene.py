"""Hand a configuration's ``SceneData`` to the program through its public
``Scene`` API: materials, planes, primitives and meshes in the order the
data lists them, the camera, the settings, the post settings and the
environment map, read by the program's own loader as its scene builders
read it.  The program registers lights and packs the scene itself."""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from buas_pathtracer_tpu_torch.core.vec import Affine, Vec3
from buas_pathtracer_tpu_torch.models.camera import Camera
from buas_pathtracer_tpu_torch.models.materials import Material
from buas_pathtracer_tpu_torch.models.mesh import Mesh
from buas_pathtracer_tpu_torch.models.scene import (PostProcessSettings,
                                                    Scene, SceneSettings)
from buas_pathtracer_tpu_torch.utils.assets import load_environment_map

from .scene_data import SceneData


def _camera(c) -> Camera:
    return Camera(Vec3(*c["p"]), Vec3(*c["x"]), Vec3(*c["y"]), Vec3(*c["z"]),
                  c["vfov"], c["aspect"], c["lens_radius"],
                  c["focus_distance"], c["film_distance"], c["half_film_w"],
                  c["half_film_h"])


def build(data: SceneData) -> Scene:
    sc = Scene(name=data.name, filter_name=data.filter_name,
               camera=_camera(data.camera),
               settings=replace(SceneSettings(), **data.settings),
               post_settings=replace(PostProcessSettings(), **data.post),
               top_sky_color=tuple(data.sky_top),
               bot_sky_color=tuple(data.sky_bot))
    for m in data.materials[1:]:  # slot 0 (air) comes with the Scene
        sc.add_material(Material(
            flags=m["flags"], albedo=m["albedo"],
            checker_color=m["checker_color"], emission_color=m["emission"],
            ior=m["ior"], metallic=m["metallic"], roughness=m["roughness"],
            is_participating_medium=m["is_medium"], absorb=m["absorb"]))
    for p in data.planes:
        sc.add_plane(p["mat"], p["n"], p["d"])
    # one Mesh a described mesh, shared by its instances (the program
    # reorders its triangles in place, so it gets copies)
    meshes = [Mesh(triangles=np.array(m["triangles"], np.float32),
                   normals=None if m["normals"] is None
                   else np.array(m["normals"], np.float32))
              for m in data.meshes]
    for p in data.prims:
        xf = Affine(p["fwd"], p["inv"])
        if p["type"] == "sphere":
            sc.add_sphere(p["mat"], p["r"], xf)
        elif p["type"] == "box":
            sc.add_box(p["mat"], p["box_r"], xf)
        elif p["type"] == "mesh":
            sc.add_mesh(p["mat"], meshes[p["mesh"]], xf)
        else:
            raise ValueError(f"unknown primitive type {p['type']!r}")
    if data.env_path is not None:
        env = load_environment_map(data.env_file)
        if env is None:  # never the gradient sky in the map's place
            raise FileNotFoundError(f"{data.name}: cannot read the "
                                    f"environment map {data.env_path}")
        sc.env_map = env
    return sc
