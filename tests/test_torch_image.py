"""Image writers of the PyTorch port against the JAX package: the BMP and
PNG files are byte-equal for the same seeded arrays, odd widths included."""

import numpy as np
import pytest

from buas_pathtracer_tpu.utils import image as jimage
from buas_pathtracer_tpu_torch.utils import image as timage

SHAPES = [(1, 1), (7, 13), (18, 32), (33, 17), (2, 255)]


def _image(h, w, c, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c)).astype(
        np.uint8)


def _pair(writer, tmp_path, img):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    getattr(jimage, writer)(a, img)
    getattr(timage, writer)(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read(), fb.read()


@pytest.mark.parametrize("h,w", SHAPES)
def test_bmp_byte_equal(h, w, tmp_path):
    ref, out = _pair("write_bmp", tmp_path, _image(h, w, 4, h * 31 + w))
    assert out == ref
    assert out[:2] == b"BM" and len(out) == 54 + h * w * 4


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("h,w", SHAPES)
def test_png_byte_equal(h, w, channels, tmp_path):
    ref, out = _pair("write_png", tmp_path,
                     _image(h, w, channels, h * 7 + w + channels))
    assert out == ref and out[:8] == b"\x89PNG\r\n\x1a\n"


def test_png_clips_other_dtypes(tmp_path):
    """A float or int array is clipped to [0, 255] and cast, as in the JAX
    package's writer."""
    img = np.random.RandomState(5).uniform(-40, 300, (9, 11, 3))
    ref, out = _pair("write_png", tmp_path, img)
    assert out == ref
    ref, out = _pair("write_png", tmp_path, img.astype(np.int32))
    assert out == ref
