"""The port's Advanced Pathtracer against the JAX package's single loop
under the ``SceneSettings`` that change the bounce's paths, one field a
case, on tests/test_torch_loop.py's open scene with a second light
(``lamp``), so that picking a light has a choice.

No other port test holds these against the JAX package: the default
settings (the Stratified sampler among them) are test_torch_loop.py's and
test_torch_render.py's, and ``caustics=False`` is the Week 5 and Floating
Platforms scenes' (test_torch_scenes_render*.py).  Tolerance: the goldens'
rtol = atol = 2e-3 with the port's rule for live renders, and the same rays
traced (``test_torch_loop.assert_matches_jax``).  Env-lit JAX frames run op
by op (``jax.disable_jit``)."""

import pytest

from buas_pathtracer_tpu.core import sampler as jsmp
from buas_pathtracer_tpu_torch.core import sampler as tsmp
from test_torch_loop import _render, assert_matches_jax, jax_render

# (env map, settings) by case name
CASES = {
    "no_mis": (False, dict(use_mis=False)),
    "reference_mis": (False, dict(reference_mis=True)),
    "no_russian_roulette": (False, dict(russian_roulette=False)),
    "uniform_light_pick": (False, dict(importance_sample_lights=False)),
    "uniform_hemisphere": (False, dict(importance_sample_diffuse=False)),
    "uniform_sampler": (False, dict(sampling_strategy=tsmp.Strategy.UNIFORM)),
    "blue_noise_sampler": (False, dict(
        sampling_strategy=tsmp.Strategy.BLUE_NOISE)),
    "no_nee": (False, dict(next_event_estimation=False)),
    "two_bounces": (False, dict(max_bounce_count=2)),
    "twelve_bounces": (False, dict(max_bounce_count=12)),
    "env_without_env_nee": (True, dict(env_nee=False)),
    "env_no_mis": (True, dict(use_mis=False)),
    "env_uniform_hemisphere": (True, dict(importance_sample_diffuse=False)),
    "env_no_nee": (True, dict(next_event_estimation=False)),
}


def test_strategies_numbered_alike():
    """The cases hand the port's strategy numbers to the JAX package."""
    for s in tsmp.Strategy:
        assert int(jsmp.Strategy[s.name]) == int(s)


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_loop_settings_match_jax(case):
    env, settings = CASES[case]
    assert_matches_jax(_render(env=env, lamp=True, **settings),
                       jax_render(env=env, lamp=True, **settings))
