"""The built-in scenes of the PyTorch port against the JAX package: the
registry, and every packed field byte-equal, without assets and with
synthetic assets (an icosphere OBJ with vertex normals and three procedural
HDRs, written from seeded code under a temporary data directory that both
packages' ``DATA_DIR`` point at).  The frames of the scenes are in
``test_torch_scenes_render*.py``, the env-lit asset frames in
``test_torch_scenes_env.py`` and the Week 7 pair, whose 40,378 boxes take
seconds to pack, in ``test_torch_scenes_week7*.py``, so that the test
workers share them out."""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from buas_pathtracer_tpu.core import vec as jvec
from buas_pathtracer_tpu.models import scenes as jscenes
from buas_pathtracer_tpu.models.scene import Scene as JScene
from buas_pathtracer_tpu.runtime.render import render as jrender
from buas_pathtracer_tpu_torch.core import vec as tvec
from buas_pathtracer_tpu_torch.models import scenes as tscenes
from buas_pathtracer_tpu_torch.models.scene import PackedScene
from buas_pathtracer_tpu_torch.models.scene import Scene as TScene
from buas_pathtracer_tpu_torch.models.scene import from_jax_arrays
from buas_pathtracer_tpu_torch.runtime.render import render as trender
from test_torch_render import assert_image_close

ASSET_SCENES = ["Dragon", "Cornell Box", "Floating Platforms",
                "Nested Dielectrics"]
WEEK7 = ["Week 7", "Week 7, Nicer"]
NO_ASSET_SCENES = [d.name for d in jscenes.SCENES if d.name not in WEEK7]
# the synthetic assets of the CPU tests: a 5,120-triangle icosphere and
# 64x128 skies
ASSET_SUBDIVISIONS = 4
ASSET_SKY = (64, 128)


def use_synthetic_assets(tmp_path, monkeypatch):
    """Write the synthetic assets under ``tmp_path`` and point both
    packages' ``DATA_DIR`` at them (read once at import, so the module
    attribute is patched, not the environment)."""
    d = str(tmp_path / "data")
    chip_smoke.write_synthetic_assets(d, ASSET_SUBDIVISIONS, *ASSET_SKY)
    monkeypatch.setattr(jscenes, "DATA_DIR", d)
    monkeypatch.setattr(tscenes, "DATA_DIR", d)
    return d


def assert_packs_equal(jps, tps: PackedScene):
    """Every field of the port's pack byte-equal to the JAX pack's, read
    through ``from_jax_arrays`` (Vec3 fields per component; index fields,
    int32 or exact floats there, as int64 values).  The JAX package always
    packs the threaded tables, so the port's pack is made with
    ``threaded=True``."""
    ref = from_jax_arrays({k: np.asarray(v) for k, v in jps._asdict().items()
                           if v is not None}, "cpu")
    for name in PackedScene._fields:
        a, b = getattr(ref, name), getattr(tps, name)
        if name == "wide_depth":
            assert a == b, name
            continue
        assert (a is None) == (b is None), name
        if a is None:
            continue
        for x, y in (zip(a, b) if isinstance(a, tvec.Vec3) else ((a, b),)):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert x.numpy().tobytes() == y.numpy().tobytes(), \
                f"{name} differs"


@pytest.fixture
def no_assets(tmp_path, monkeypatch):
    """Both packages' ``DATA_DIR`` at an empty directory: the scenes as the
    repository ships them, without their asset files."""
    empty = str(tmp_path / "none")
    monkeypatch.setattr(jscenes, "DATA_DIR", empty)
    monkeypatch.setattr(tscenes, "DATA_DIR", empty)


def build_pair(name, w=64, h=36):
    return jscenes.load_scene(name, w, h), tscenes.load_scene(name, w, h)


def camera_values(cam):
    """A camera's scalars, a Vec3 as x, y, z (either package's camera)."""
    out = []
    for f in cam:
        out += [float(c) for c in f] if isinstance(f, tuple) else [float(f)]
    return out


def check_frame(name, w, h, bounces, unjitted=False):
    """One frame of the scene, ``bounces`` bounces, through both packages:
    within the goldens' tolerance (``test_torch_render.assert_image_close``)
    with the same rays traced.  ``unjitted``: the JAX ops run one by one
    (``jax.disable_jit``), for env-lit frames, whose jitted form XLA fuses
    differently (ROADMAP queue 3)."""
    j, t = build_pair(name, w, h)
    j.settings = replace(j.settings, max_bounce_count=bounces)
    t.settings = replace(t.settings, max_bounce_count=bounces)
    with jax.disable_jit(unjitted):
        ref, _, jstats = jrender(j, w, h, frames=1, filter_name=j.filter_name)
    img, _, tstats = trender(t, w, h, frames=1, filter_name=t.filter_name,
                             device="cpu")
    assert_image_close(img, np.asarray(ref))
    assert float(tstats[0]) == float(np.asarray(jstats)[0])
    return img


def test_registry():
    assert [d.name for d in tscenes.SCENES] == [d.name for d in
                                                 jscenes.SCENES]
    assert len(tscenes.SCENES) == 12
    assert [d.f.__name__ for d in tscenes.SCENES] == [
        d.f.__name__ for d in jscenes.SCENES]
    assert tscenes.find_scene("Week 3").name == "Week 3"
    # an unknown name falls back to the first scene, as the reference does
    assert tscenes.find_scene("no such scene") is tscenes.SCENES[0]
    assert tscenes.load_scene("no such scene", 8, 8).name == "Dragon"
    desc = tscenes.find_scene("Week 2")
    assert tscenes.load_scene(desc, 8, 8).name == "Week 2"
    assert tscenes.DEG == jscenes.DEG


@pytest.mark.parametrize("name", NO_ASSET_SCENES)
def test_scene_settings_equal(name, no_assets):
    """load_scene's defaults and each description's settings, camera,
    filter, sky and lights match the JAX package's."""
    j, t = build_pair(name)
    assert j.name == t.name and j.filter_name == t.filter_name
    assert j.settings.__dict__ == t.settings.__dict__
    assert j.post_settings.__dict__ == t.post_settings.__dict__
    assert camera_values(j.camera) == camera_values(t.camera)
    assert (j.top_sky_color, j.bot_sky_color, j.ambient_light) == \
        (t.top_sky_color, t.bot_sky_color, t.ambient_light)
    assert j.lights == t.lights and j.n_lights == t.n_lights
    assert j.has_medium == t.has_medium
    assert (j.env_map is None) and (t.env_map is None)


@pytest.mark.parametrize("name", NO_ASSET_SCENES)
def test_pack_byte_equal_without_assets(name, no_assets):
    j, t = build_pair(name)
    assert not t.meshes and t.env_map is None
    assert_packs_equal(j.pack(), t.pack(device="cpu", threaded=True))


@pytest.mark.parametrize("name", ASSET_SCENES)
def test_pack_byte_equal_with_synthetic_assets(name, tmp_path, monkeypatch):
    use_synthetic_assets(tmp_path, monkeypatch)
    j, t = build_pair(name)
    if name in ("Dragon", "Cornell Box"):
        assert len(t.meshes) == len(j.meshes) > 0
        assert t.meshes[0].triangle_count == 20 * 4 ** ASSET_SUBDIVISIONS
        assert t.meshes[0].normals is not None
    if name != "Cornell Box":
        assert t.env_map is not None and t.env_map.shape == ASSET_SKY + (3,)
        np.testing.assert_array_equal(t.env_map, j.env_map)
    assert_packs_equal(j.pack(), t.pack(device="cpu", threaded=True))


def test_csg_difference_packs_equal():
    """The CSG stub packs as PRIM_CSG with a zero AABB and is never hit."""
    def build(Scene, vec):
        sc = Scene(name="csg")
        m = sc.add_diffuse_material((0.5, 0.5, 0.5), 1.2)
        a = sc.add_sphere(m, 1.0, vec.translate([0, 1, 3]))
        b = sc.add_box(m, (0.5, 0.5, 0.5), vec.translate([0.5, 1, 3]))
        sc.add_csg_difference(m, a, b, vec.translate([2, 0, 0]))
        sc.add_sphere(m, 0.5, vec.translate([-2, 1, 3]))
        return sc
    j, t = build(JScene, jvec), build(TScene, tvec)
    assert t.prims[2]["type"] == 5 and t.prims[2]["csg_a"] == 0
    tps = t.pack(device="cpu", threaded=True)
    assert_packs_equal(j.pack(), tps)
    assert int(tps.prim_type[2]) == 5


def test_pack_comparison_catches_a_difference(no_assets):
    """One float of one table changed by an ulp fails the comparison."""
    j, t = build_pair("Week 6")
    jps, tps = j.pack(), t.pack(device="cpu", threaded=True)
    rows = tps.wide_rows.clone()
    rows.view(torch.int32)[1, 5] += 1
    with pytest.raises(AssertionError, match="wide_rows differs"):
        assert_packs_equal(jps, tps._replace(wide_rows=rows))
