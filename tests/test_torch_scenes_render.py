"""Frames of the built-in scenes without their asset files, through the
PyTorch port and the JAX package: 64x36, 4 bounces, one frame, each scene
with its own integrator, filter and camera, within the goldens' tolerance
(``test_torch_scenes.check_frame``).  Week 2-6 are in
``test_torch_scenes_render_weeks.py``, so that two test workers share the
JAX package's compiles."""

import pytest

from test_torch_scenes import check_frame, no_assets  # noqa: F401


@pytest.mark.parametrize("name", ["Dragon", "Cornell Box",
                                  "Floating Platforms", "Nested Dielectrics",
                                  "Week 1"])
def test_frame_without_assets(name, no_assets):  # noqa: F811
    check_frame(name, 64, 36, 4)
