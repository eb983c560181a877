"""The other integrators of the PyTorch port, and the hero scene.

Whitted and Normals against the repository's goldens
(tests/goldens/spheres_whitted.npz, mesh_normals.npz: the scenes and
settings of tests/test_golden.py), Distances and Ground Truth against the
JAX package at 32x32 on the same seeds, and ``build_hero_scene`` packed
byte-equal to ``tools/hero_render.hero_scene``'s ``Scene.pack()``.

Tolerance: the goldens' rtol = atol = 2e-3 (tests/test_golden.py:88-90),
with the port's rule for live renders (test_torch_render.py): at most 1% of
pixels outside, mean relative error at most 1e-3."""

import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from buas_pathtracer_tpu.models.scene import SceneSettings as JSettings
from buas_pathtracer_tpu.runtime.render import render as jrender
from buas_pathtracer_tpu_torch.core import sampler as tsmp
from buas_pathtracer_tpu_torch.integrators import whitted as twht
from buas_pathtracer_tpu_torch.models import scenes as tscenes
from buas_pathtracer_tpu_torch.models.scene import SceneSettings as TSettings
from buas_pathtracer_tpu_torch.runtime.render import render as trender
from test_torch_render import assert_image_close
from test_torch_scene import (ENV_TABLES_PACKED, J, T, _assert_tables_equal,
                              scene_mesh, scene_spheres)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,build,integrator,frames", [
    ("spheres_whitted", scene_spheres, "Whitted", 4),
    ("mesh_normals", scene_mesh, "Normals", 1)])
def test_matches_golden(name, build, integrator, frames):
    sc = build(*T)
    sc.settings = TSettings(samples_per_pixel=1, max_bounce_count=4,
                            integrator=integrator)
    img, _, _ = trender(sc, 32, 32, frames=frames, device="cpu")
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["hdr"]
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, golden, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("integrator,build", [
    ("Distances", scene_mesh), ("Ground Truth Iterative", scene_spheres),
    ("Ground Truth Recursive", scene_mesh)])
def test_matches_jax(integrator, build):
    jsc, tsc = build(*J), build(*T)
    jsc.settings = JSettings(samples_per_pixel=1, max_bounce_count=4,
                             integrator=integrator)
    tsc.settings = TSettings(samples_per_pixel=1, max_bounce_count=4,
                             integrator=integrator)
    ref, _, jstats = jrender(jsc, 32, 32, frames=2)
    img, _, tstats = trender(tsc, 32, 32, frames=2, device="cpu")
    assert_image_close(img, np.asarray(ref))
    assert float(tstats[0]) == float(np.asarray(jstats)[0])


def test_whitted_without_medium_drops_queued_lanes():
    """A scene with no medium never splits: the queued lanes stay dormant,
    so the frame with them equals the frame without them."""
    sc = scene_mesh(*T)
    assert not sc.has_medium and scene_spheres(*T).has_medium
    ps = sc.pack(device="cpu")
    n = 64
    s = tsmp.make_sampler(torch.arange(n), torch.arange(n), 0,
                          strategy=tsmp.Strategy.STRATIFIED)
    r = np.random.RandomState(3)
    o = [torch.from_numpy(np.full(n, c, np.float32)) for c in (0, 2, -2.5)]
    d = r.randn(3, n).astype(np.float32)
    d[2] = np.abs(d[2]) + 1.0
    d /= np.linalg.norm(d, axis=0)
    o, d = twht.Vec3(*o), twht.Vec3(*map(torch.from_numpy, d))
    st = TSettings(max_bounce_count=4)
    a = twht.whitted(ps, st, s, o, d, n_lights=sc.n_lights, has_medium=True)
    b = twht.whitted(ps, st, s, o, d, n_lights=sc.n_lights, has_medium=False)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert a[1].state.shape == b[1].state.shape == (n,)


def test_blue_noise_frame_finite():
    """A frame through the renderer with the blue-noise sampler."""
    sc = scene_spheres(*T)
    sc.settings = TSettings(samples_per_pixel=1, max_bounce_count=3,
                            sampling_strategy=tsmp.Strategy.BLUE_NOISE)
    img, _, stats = trender(sc, 16, 16, device="cpu")
    assert np.isfinite(img).all() and float(stats[0]) >= 256


@pytest.fixture(scope="module")
def hero_packed():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import hero_render
    finally:
        sys.path.pop(0)
    return (hero_render.hero_scene(1920, 1080).pack(),
            tscenes.build_hero_scene(1920, 1080).pack(device="cpu"))


def test_hero_scene_packs_byte_equal(hero_packed):
    jps, tps = hero_packed
    _assert_tables_equal(jps, tps)
    for name in ENV_TABLES_PACKED:
        a = np.ascontiguousarray(np.asarray(getattr(jps, name)))
        assert a.tobytes() == getattr(tps, name).numpy().tobytes(), name
    np.testing.assert_array_equal(
        np.asarray(jps.env_alias_idx).astype(np.int64),
        tps.env_alias_idx.numpy())
    assert tuple(tps.env_pixels.shape) == (256, 512, 3)


def test_hero_scene_settings_and_missing_map(tmp_path):
    sc = tscenes.build_hero_scene(64, 36)
    assert sc.settings == replace(TSettings(), max_bounce_count=8,
                                  samples_per_pixel=1, env_nee=True)
    assert sc.n_lights == 2 and sc.has_medium
    with pytest.raises(FileNotFoundError, match="environment map"):
        tscenes.build_hero_scene(64, 36, str(tmp_path / "absent.hdr"))
