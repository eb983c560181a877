"""Frames of Week 2-6, as ``test_torch_scenes_render.py`` renders the
other scenes: 64x36, 4 bounces, one frame, through the PyTorch port and
the JAX package, within the goldens' tolerance."""

import pytest

from test_torch_scenes import check_frame, no_assets  # noqa: F401


@pytest.mark.parametrize("name", ["Week 2", "Week 3", "Week 4", "Week 5",
                                  "Week 6"])
def test_frame_without_assets(name, no_assets):  # noqa: F811
    check_frame(name, 64, 36, 4)
