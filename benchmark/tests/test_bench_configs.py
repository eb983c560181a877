"""Each configuration's scene, handed to the program through its public
Scene API, packs byte-equal to the program's own builder of that scene,
with the same camera, settings, post settings and filter; so does the
env-lit hero frame, environment map and tables included; a map that cannot
be read stops the build; and the reference's defaults are the program's."""

import dataclasses

import numpy as np
import pytest

from benchmark.configs import bench, week7_nicer
from benchmark.harness import port_scene
from benchmark.tests import hero_scene
from benchmark.reference import scene as ref_scene
from buas_pathtracer_tpu_torch.models import scenes
from buas_pathtracer_tpu_torch.models.scene import (PostProcessSettings,
                                                    SceneSettings)

W, H = 1920, 1080


def _same(ours, theirs):
    a, b = ours._pack_arrays(), theirs._pack_arrays()
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert ours.camera == theirs.camera
    assert ours.settings == theirs.settings
    assert ours.post_settings == theirs.post_settings
    assert ours.filter_name == theirs.filter_name
    assert ours.lights == theirs.lights
    assert (ours.top_sky_color, ours.bot_sky_color, ours.ambient_light) == (
        theirs.top_sky_color, theirs.bot_sky_color, theirs.ambient_light)


@pytest.mark.parametrize("cfg, build", [
    (bench, lambda: scenes.build_bench_scene(W, H)),
    (week7_nicer, lambda: scenes.load_scene("Week 7, Nicer", W, H)),
], ids=["bench", "week7_nicer"])
def test_config_packs_byte_equal_to_the_programs_scene(cfg, build):
    _same(port_scene.build(cfg.describe(W, H)), build())


def test_the_hero_frame_packs_byte_equal_with_its_map():
    ours = port_scene.build(hero_scene.describe(W, H))
    theirs = scenes.build_hero_scene(W, H)
    assert ours.env_map is not None and ours.settings.env_nee
    _same(ours, theirs)


@pytest.mark.parametrize("env_path", ["gallery/no_such_map.hdr",
                                      "benchmark/README.md"],
                         ids=["missing", "not_a_map"])
def test_an_unreadable_map_stops_the_build(env_path):
    data = hero_scene.describe(W, H, (1, 1))
    data.env_path = env_path
    with pytest.raises(FileNotFoundError, match="environment map"):
        port_scene.build(data)


def test_configs_state_their_source_and_cuts():
    for cfg in (bench, week7_nicer):
        assert cfg.SOURCE and cfg.REDUCED == [] and cfg.ASSUMED == {}


def test_reference_defaults_are_the_programs():
    assert ref_scene.DEFAULT_SETTINGS == dataclasses.asdict(SceneSettings())
    assert ref_scene.DEFAULT_POST == dataclasses.asdict(PostProcessSettings())
