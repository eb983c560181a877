"""Whole frames of the PyTorch port against the JAX package: live renders of
the golden scenes (tests/test_golden.py) at 32x32, 4 bounces, 2 frames, the
stored goldens at 8 frames, and the film splat.

Tolerance: rtol = atol = 2e-3 per value, the goldens' own.  Paths may
still part ways: a last-bit difference (XLA's fused arithmetic, ``sin`` /
``cos`` / ``exp`` implementations) can flip one Russian-roulette or Fresnel
decision and send a single path elsewhere.  So at most 1% of pixels may lie
outside the tolerance, and the mean relative error must stay <= 1e-3.  (On
this machine the renders measure well inside the tolerance everywhere.)"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buas_pathtracer_tpu.core import vec as jvec
from buas_pathtracer_tpu.models import camera as jcm
from buas_pathtracer_tpu.models.scene import Scene as JScene
from buas_pathtracer_tpu.models.scene import SceneSettings as JSettings
from buas_pathtracer_tpu.ops import filters as jfilters
from buas_pathtracer_tpu.runtime import film as jfilm
from buas_pathtracer_tpu.runtime.render import render as jrender
from buas_pathtracer_tpu.utils.procgen import icosphere as jico
from buas_pathtracer_tpu_torch.core import vec as tvec
from buas_pathtracer_tpu_torch.models import camera as tcm
from buas_pathtracer_tpu_torch.models.scene import Scene as TScene
from buas_pathtracer_tpu_torch.models.scene import SceneSettings as TSettings
from buas_pathtracer_tpu_torch.ops import filters as tfilters
from buas_pathtracer_tpu_torch.runtime import film as tfilm
from buas_pathtracer_tpu_torch.runtime.render import render as trender
from buas_pathtracer_tpu_torch.utils.procgen import icosphere as tico
from test_torch_scene import scene_mesh, scene_spheres

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
J = (JScene, jvec, jcm, jico)
T = (TScene, tvec, tcm, tico)
SCENES = {"spheres_advanced": scene_spheres, "mesh_advanced": scene_mesh}


def assert_image_close(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref)
    outside = (diff > 2e-3 + 2e-3 * np.abs(ref)).any(axis=-1)
    assert outside.mean() <= 0.01, f"{outside.mean():.4f} of pixels outside"
    assert (diff / np.maximum(np.abs(ref), 1e-3)).mean() <= 1e-3


def _port_render(name, frames):
    sc = SCENES[name](*T)
    sc.settings = TSettings(samples_per_pixel=1, max_bounce_count=4)
    return trender(sc, 32, 32, frames=frames, device="cpu")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_jax_live(name):
    jsc = SCENES[name](*J)
    jsc.settings = JSettings(samples_per_pixel=1, max_bounce_count=4)
    ref, _, jstats = jrender(jsc, 32, 32, frames=2)
    img, _, tstats = _port_render(name, 2)
    assert_image_close(img, np.asarray(ref))
    # same rays traced (primary + bounce + shadow); node/triangle counts
    # follow each walk's own rules and are not compared
    assert float(tstats[0]) == float(np.asarray(jstats)[0])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_golden(name):
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["hdr"]
    img, accum, _ = _port_render(name, 8)
    assert_image_close(img, golden)
    assert accum.dtype == torch.float32 and tuple(accum.shape) == (32, 32, 4)


@pytest.mark.parametrize("filt", ["Mitchell Netravali", "Box", "Gaussian 3"])
def test_splat_pass_matches_jax(filt):
    rng = np.random.default_rng(9)
    h, w = 24, 40
    col = rng.uniform(0, 3, (3, h, w)).astype(np.float32)
    jx, jy = (rng.uniform(-0.5, 0.5, (2, h, w))).astype(np.float32)
    ref = jfilm.splat_pass(jvec.Vec3(*map(jnp.asarray, col)),
                           jnp.asarray(jx), jnp.asarray(jy),
                           jfilters.find_filter(filt))
    out = tfilm.splat_pass(tvec.Vec3(*map(torch.from_numpy, col)),
                           torch.from_numpy(jx), torch.from_numpy(jy),
                           tfilters.find_filter(filt))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    a = out.numpy()
    np.testing.assert_allclose(
        tfilm.resolve(out).numpy(), np.asarray(jfilm.resolve(jnp.asarray(a))),
        rtol=1e-6, atol=1e-6)


def test_unported_integrator_raises():
    """No registry name raises any more: the six JAX names each map to
    their integrator, an unknown name to the Advanced Pathtracer
    (integrators.cpp:834-845)."""
    from buas_pathtracer_tpu.runtime import render as jr
    from buas_pathtracer_tpu_torch.runtime import render as tr
    assert sorted(tr.INTEGRATORS) == sorted(jr.INTEGRATORS)
    for name in jr.INTEGRATORS:
        assert (tr.find_integrator(name).__name__
                == jr.find_integrator(name).__name__), name
    assert tr.find_integrator("no such integrator") is tr.adv.advanced
    sc = scene_spheres(*T)
    sc.settings = TSettings(integrator="Whitted", max_bounce_count=2)
    img, _, _ = trender(sc, 8, 8, device="cpu")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
