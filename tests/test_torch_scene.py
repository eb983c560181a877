"""Scene packing of the PyTorch port against the JAX package: the packed
tables are byte-equal (native builders and numpy fallbacks alike), primary
rays agree to 1e-6, and ``from_jax_arrays`` round-trips the JAX tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import buas_pathtracer_tpu.native as jnative
from buas_pathtracer_tpu.core import vec as jvec
from buas_pathtracer_tpu.models import camera as jcm
from buas_pathtracer_tpu.models.scene import Scene as JScene
from buas_pathtracer_tpu.utils.procgen import icosphere as jico
import buas_pathtracer_tpu_torch.native as tnative
from buas_pathtracer_tpu_torch.core import vec as tvec
from buas_pathtracer_tpu_torch.models import camera as tcm
from buas_pathtracer_tpu_torch.models.scene import Scene as TScene
from buas_pathtracer_tpu_torch.models.scene import from_jax_arrays
from buas_pathtracer_tpu_torch.models.scenes import build_bench_scene
from buas_pathtracer_tpu_torch.utils.procgen import icosphere as tico

J = (JScene, jvec, jcm, jico)
T = (TScene, tvec, tcm, tico)


def scene_spheres(Scene, vec, cm, icosphere):  # tests/test_golden.py:29-44
    sc = Scene(name="g-spheres")
    grey = sc.add_diffuse_material((0.6, 0.6, 0.6), 1.2)
    red = sc.add_diffuse_material((0.8, 0.2, 0.2), 1.4)
    glass = sc.add_translucent_material((0.2, 0.1, 0.0), 1.5)
    li = sc.add_emissive_material((15, 14, 12))
    sc.add_plane(grey, (0, 1, 0), 0.0)
    sc.add_sphere(red, 1.0, vec.translate([-1.2, 1, 4]))
    sc.add_sphere(glass, 0.9, vec.translate([1.2, 0.9, 3]))
    sc.add_sphere(li, 0.6, vec.translate([0, 4, 2]))
    sc.top_sky_color = (0.4, 0.55, 0.8)
    sc.bot_sky_color = (0.9, 0.9, 0.9)
    sc.camera = cm.aim_camera_at(
        cm.make_camera(p=(0, 1.8, -3), vfov=np.radians(55), aspect=1.0),
        (0, 1.0, 3.5))
    return sc


def scene_mesh(Scene, vec, cm, icosphere):  # tests/test_golden.py:47-62
    sc = Scene(name="g-mesh")
    grey = sc.add_diffuse_material((0.55, 0.55, 0.55), 1.2, 0.0, True)
    blue = sc.add_diffuse_material((0.2, 0.3, 0.8), 1.4)
    li = sc.add_emissive_material((20, 20, 20))
    sc.add_plane(grey, (0, 1, 0), 0.0)
    sc.add_mesh(blue, icosphere(subdivisions=2),
                vec.translate([0, 1.2, 3]) * vec.scale(1.2))
    sc.add_box(grey, (0.5, 0.5, 0.5),
               vec.translate([1.8, 0.5, 4]) * vec.rotate_y(0.6))
    sc.add_sphere(li, 0.5, vec.translate([-2, 4, 1]))
    sc.camera = cm.aim_camera_at(
        cm.make_camera(p=(0, 2, -2.5), vfov=np.radians(55), aspect=1.0),
        (0.3, 1.0, 3.2))
    return sc


def scene_packet(Scene, vec, cm, icosphere):  # tests/test_pallas_packet.py:23-43
    sc = Scene(name="packet-parity")
    grey = sc.add_diffuse_material((0.6, 0.6, 0.6), 1.2)
    red = sc.add_diffuse_material((0.8, 0.2, 0.2), 1.4)
    glass = sc.add_translucent_material((0.1, 0.05, 0.02), 1.5)
    mesh = icosphere(subdivisions=2)
    sc.add_mesh(grey, mesh, vec.translate([0, 1.2, 2.5]))
    sc.add_mesh(red, mesh, vec.translate([-2.2, 1.0, 4.0]) * vec.scale(0.8))
    sc.add_sphere(glass, 0.9, vec.translate([2.0, 1.0, 3.0]))
    sc.add_box(grey, (8, 0.5, 8), vec.translate([0, -0.5, 3.0]))
    sc.camera = cm.aim_camera_at(
        cm.make_camera(p=(0, 2.0, -3.0), vfov=np.radians(55), aspect=1.0),
        (0, 1.0, 2.5))
    return sc


SCENES = {"spheres": scene_spheres, "mesh": scene_mesh,
          "packet": scene_packet}
TABLES = ["wide_rows", "wtri_nrm16", "mat16", "prim_nrm16", "light16",
          "scene_lo", "scene_hi", "plane_d", "prim_fwd", "prim_inv", "prim_r"]
# the env tables the JAX package packs in the port's dtypes (the alias
# indices differ in dtype: exact floats there, int64 here)
ENV_TABLES_PACKED = ["env_pixels", "env_cdf_marginal", "env_cdf_conditional",
                     "env_alias_prob", "env_pdf_num"]


def _assert_tables_equal(jps, tps):
    assert int(jps.wide_depth_arr.shape[0]) == tps.wide_depth
    for name in TABLES:
        a = np.ascontiguousarray(np.asarray(getattr(jps, name)))
        b = getattr(tps, name).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), f"{name} differs"
    for name in ("plane_mat", "prim_type", "prim_mat", "light_prim"):
        np.testing.assert_array_equal(np.asarray(getattr(jps, name)),
                                      getattr(tps, name).numpy())
    for name in ("mat_albedo", "mat_emission", "plane_n", "sky_top"):
        for cj, ct in zip(getattr(jps, name), getattr(tps, name)):
            assert np.asarray(cj).tobytes() == ct.numpy().tobytes(), name


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_byte_equal(name):
    build = SCENES[name]
    _assert_tables_equal(build(*J).pack(), build(*T).pack(device="cpu"))


@pytest.mark.parametrize("name", ["mesh", "packet"])
def test_pack_byte_equal_numpy_fallback(name, monkeypatch):
    """With BUAS_NO_NATIVE set, both packages take their numpy builders;
    those give another tree than the native ones, but the same as each
    other."""
    monkeypatch.setenv("BUAS_NO_NATIVE", "1")
    for mod in (jnative, tnative):  # forget a library loaded earlier
        monkeypatch.setattr(mod, "_tried", False)
        monkeypatch.setattr(mod, "_lib", None)
    assert not jnative.available() and not tnative.available()
    build = SCENES[name]
    jps, tps = build(*J).pack(), build(*T).pack(device="cpu")
    _assert_tables_equal(jps, tps)
    monkeypatch.undo()
    rows = build(*T).pack(device="cpu").wide_rows  # native builders again
    assert rows.shape != tps.wide_rows.shape or not torch.equal(
        rows, tps.wide_rows)


def test_bench_scene_table():
    """The bench frame's table: 20,489 rows of 64 floats, depth 7, resident
    (5.2 MB), and byte-equal to the JAX package's (bench.py:68-95)."""
    import sys
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import bench
    jps = bench.build_bench_scene(1920, 1080).pack()
    tps = build_bench_scene(1920, 1080).pack(device="cpu")
    assert tuple(tps.wide_rows.shape) == (20489, 64) and tps.wide_depth == 7
    _assert_tables_equal(jps, tps)


def test_from_jax_arrays_round_trip():
    jps = scene_mesh(*J).pack()
    arrays = {k: np.asarray(v) for k, v in jps._asdict().items()
              if v is not None}
    rt = from_jax_arrays(arrays, "cpu")  # the threaded tables come along
    own = scene_mesh(*T).pack(device="cpu", threaded=True)
    for name in rt._fields:
        a, b = getattr(rt, name), getattr(own, name)
        if a is None or isinstance(a, int):  # no split tables: both None
            assert a == b, name
        elif isinstance(a, tvec.Vec3):
            for ca, cb in zip(a, b):
                assert torch.equal(ca, cb), name
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), name


def test_env_map_refused():
    """An environment map, once refused, packs: the map and its sampling
    tables equal the JAX package's (tests/test_torch_envmap.py has the
    rest)."""
    env = np.ones((4, 8, 3), np.float32)
    jsc, tsc = scene_spheres(*J), scene_spheres(*T)
    jsc.env_map, tsc.env_map = env, env
    jps, tps = jsc.pack(), tsc.pack(device="cpu")
    for name in ("env_pixels", "env_alias_prob", "env_pdf_num"):
        assert (np.asarray(getattr(jps, name)).tobytes()
                == getattr(tps, name).numpy().tobytes()), name


@pytest.mark.parametrize("lens", [0.0, 1.0])
def test_generate_rays_match(lens):
    jsc, tsc = scene_mesh(*J), scene_mesh(*T)
    w, h = 48, 32
    rng = np.random.default_rng(5)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    aa = rng.uniform(size=(2, px.size)).astype(np.float32)
    dof = rng.uniform(size=(2, px.size)).astype(np.float32)
    jr = jcm.generate_rays(jsc.camera, jnp.asarray(px, jnp.int32),
                           jnp.asarray(py, jnp.int32), w, h,
                           jnp.asarray(aa[0]), jnp.asarray(aa[1]),
                           jnp.asarray(dof[0]), jnp.asarray(dof[1]),
                           lens, 0.0, 6.0, 0.5, 0.25)
    tr = tcm.generate_rays(tsc.camera, torch.from_numpy(px),
                           torch.from_numpy(py), w, h,
                           *map(torch.from_numpy, (aa[0], aa[1], dof[0],
                                                   dof[1])),
                           lens, 0.0, 6.0, 0.5, 0.25)
    for a, b in zip(list(jr.o) + list(jr.d) + [jr.vignette],
                    list(tr.o) + list(tr.d) + [tr.vignette]):
        np.testing.assert_allclose(np.broadcast_to(np.asarray(a), px.shape),
                                   np.broadcast_to(np.asarray(b), px.shape),
                                   atol=1e-6, rtol=0)
