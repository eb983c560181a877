"""Env-lit frames of the built-in scenes with synthetic assets (procedural
HDR skies; ``test_torch_scenes.use_synthetic_assets``), through the PyTorch
port and the JAX package's ops run one by one: 32x18, 2 bounces, env NEE,
within the goldens' tolerance.  Dragon's meshes make its un-jitted frame
take about a minute, so Dragon is held by its packed tables
(``test_torch_scenes.py``) and rendered without assets."""

import pytest

from test_torch_scenes import check_frame, use_synthetic_assets


@pytest.mark.parametrize("name", ["Floating Platforms", "Nested Dielectrics"])
def test_env_frame_with_synthetic_assets(name, tmp_path, monkeypatch):
    use_synthetic_assets(tmp_path, monkeypatch)
    check_frame(name, 32, 18, 2, unjitted=True)
