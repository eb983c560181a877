"""Post-processing of the PyTorch port against the JAX package's
``_post_process_jnp`` (runtime/post.py:73), on the inputs of
tests/test_pallas_post.py: NaN (cyan), negative-weight (magenta) and
zero-weight pixels, and its three settings.

At most 1 LSB may differ, on at most 0.1% of the values: torch's and XLA's
CPU ``exp`` and ``pow`` are different implementations that round some
results differently in the last bit, and a value sitting on an integer
boundary before the u8 truncation then lands one step apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buas_pathtracer_tpu.models.scene import PostProcessSettings as JPost
from buas_pathtracer_tpu.runtime import post as jpost
from buas_pathtracer_tpu_torch.models.scene import PostProcessSettings as TPost
from buas_pathtracer_tpu_torch.ops import post_kernel
from buas_pathtracer_tpu_torch.runtime import post as tpost

SETTINGS = [
    dict(),
    dict(exposure=0.7, contrast=0.4, midpoint=0.4),
    dict(tonemapping=False, srgb_transform=False, dither=False),
]


def _accum(h=40, w=200):
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 4, (h, w, 4)).astype(np.float32)
    a[..., 3] = rng.uniform(0.5, 8, (h, w))
    a[3, 7] = np.nan          # cyan path
    a[9, 11, 3] = -1.0        # magenta path
    a[0, 0, 3] = 0.0          # zero-weight path
    return a


def test_dither_tile_equal():
    np.testing.assert_array_equal(tpost._dither_tile_np(64),
                                  jpost._dither_tile(64))


@pytest.mark.parametrize("kw", SETTINGS, ids=["default", "contrast",
                                              "linear"])
def test_post_plain_matches_jax(kw):
    a = _accum()
    ref = np.asarray(jpost._post_process_jnp(jnp.asarray(a), JPost(**kw), 0))
    out = tpost.post_process(torch.from_numpy(a), TPost(**kw),
                             device="cpu").numpy()
    assert out.dtype == np.uint8 and out.shape == ref.shape
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    np.testing.assert_array_equal(out[3, 7, :3], [0, 255, 255])
    assert out[9, 11, 0] == 255 and out[9, 11, 1] == 0
    np.testing.assert_array_equal(out[0, 0], [0, 0, 0, 255])
    assert (out[..., 3] == 255).all()


def test_post_wrapper_checks_inputs():
    tile = tpost.dither_tile("cpu")
    with pytest.raises(ValueError, match="accum"):
        post_kernel.post_rgba8(torch.zeros((4, 4, 3)), tile, TPost())
    with pytest.raises(ValueError, match="tile"):
        post_kernel.post_rgba8(torch.zeros((4, 4, 4)), tile[:8], TPost())


@pytest.mark.gpu
@pytest.mark.parametrize("kw", SETTINGS, ids=["default", "contrast",
                                              "linear"])
def test_post_kernel_matches_plain_on_card(kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = torch.from_numpy(_accum(1080, 1920)).cuda()
    tile = tpost.dither_tile(a.device)
    before = post_kernel.LAUNCHES["post_rgba8"]
    k = post_kernel.post_rgba8(a, tile, TPost(**kw))
    p = post_kernel.post_rgba8_plain(a, tile, TPost(**kw))
    assert post_kernel.LAUNCHES["post_rgba8"] == before + 1
    diff = (k.to(torch.int16) - p.to(torch.int16)).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 0).float().mean()) >= 0.9999
