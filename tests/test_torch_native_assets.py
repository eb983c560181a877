"""The PyTorch port's native host code (``native/src/obj_parser.cpp``: OBJ
parsing and the Radiance HDR RLE decode) against the JAX package's native
code and against the port's own Python and numpy readers, and the
``BUAS_NO_NATIVE=1`` routing to the latter."""

import os

import numpy as np
import pytest

import buas_pathtracer_tpu.native as jnative
import buas_pathtracer_tpu_torch.native as tnative
from buas_pathtracer_tpu.utils import assets as jassets
from buas_pathtracer_tpu_torch.utils import assets as tassets
from buas_pathtracer_tpu_torch.utils import image as timage
from test_torch_obj import CASES, _assert_mesh_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERO_SKY = os.path.join(ROOT, "gallery", "hero_sky.hdr")
# a bad coordinate: the Python parsers zero that field (0, 1, 0.5), the
# native ones the rest of the line (0, 0, 0)
BAD_V = "v x 1 0.5\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"
OBJ_CASES = dict(CASES, bad_v=BAD_V)


@pytest.fixture
def no_native(monkeypatch):
    """Both packages without their native library."""
    monkeypatch.setenv("BUAS_NO_NATIVE", "1")
    for mod in (jnative, tnative):  # forget a library loaded earlier
        monkeypatch.setattr(mod, "_tried", False)
        monkeypatch.setattr(mod, "_lib", None)
    assert not jnative.available() and not tnative.available()


@pytest.mark.parametrize("winding", ["ccw", "cw"])
@pytest.mark.parametrize("case", sorted(OBJ_CASES))
def test_native_obj_matches_jax_native(case, winding):
    """The port's ``parse_obj`` (native first) equals the JAX package's
    ``parse_obj`` (native first), byte for byte, on every case."""
    assert tnative.available() and jnative.available()
    text = OBJ_CASES[case]
    ref = jassets.parse_obj(text, winding)
    _assert_mesh_equal(tassets.parse_obj(text, winding), ref)
    raw = tnative.parse_obj_native(text.encode(), winding == "cw")
    jraw = jnative.parse_obj_native(text.encode(), winding == "cw")
    assert (raw is None) == (jraw is None)
    if raw is not None:
        for a, b in zip(raw, jraw):
            assert (a is None) == (b is None)
            assert a is None or a.tobytes() == b.tobytes()


def test_bad_v_line_native_against_python():
    """Where the two parsers differ: native zeroes the rest of the line."""
    nat = tassets.parse_obj(BAD_V)
    py = tassets._parse_obj_py(BAD_V)
    assert nat.triangles[0, 0].tolist() == [0.0, 0.0, 0.0]
    assert py.triangles[0, 0].tolist() == [0.0, 1.0, 0.5]
    _assert_mesh_equal(py, jassets._parse_obj_py(BAD_V))


def _rle_scanlines(rgbe):
    """Adaptive-RLE payload of (h, w, 4) uint8 RGBE: per scanline the
    0x0202 header and four component streams of runs and literals."""
    h, w, _ = rgbe.shape
    out = bytearray()
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            row = rgbe[y, :, c].tolist()
            x = 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run >= 3:
                    out += bytes([128 + run, row[x]])
                    x += run
                    continue
                n = 1
                while x + n < w and n < 128 and not (
                        x + n + 2 < w and row[x + n] == row[x + n + 1]
                        == row[x + n + 2]):
                    n += 1
                out += bytes([n] + row[x:x + n])
                x += n
    return bytes(out)


def _rle_source():
    rng = np.random.default_rng(4)
    rgbe = rng.integers(0, 256, (16, 40, 4)).astype(np.uint8)
    rgbe[:, 5:30, :] = rgbe[:, 5:6, :]  # long runs
    rgbe[3, :, 3] = 5  # exponent <= 9: black
    return rgbe


def _hdr_files(tmp_path):
    """Flat, RLE and the gallery's hero sky, as bytes."""
    flat = str(tmp_path / "flat.hdr")
    timage.write_hdr(flat, timage.procedural_sky_hdr(24, 48))
    rle = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 16 +X 40\n"
           + _rle_scanlines(_rle_source()))
    files = {"flat": open(flat, "rb").read(), "rle": rle}
    files["hero_sky"] = open(HERO_SKY, "rb").read()
    return files


def test_native_hdr_matches_jax_and_numpy(tmp_path):
    """Native decode = the JAX package's decode = the port's numpy
    scanline decoder, byte for byte."""
    for name, data in _hdr_files(tmp_path).items():
        out = tassets.parse_hdr(data)
        ref = jassets.parse_hdr(data)
        assert out is not None and out.dtype == np.float32, name
        assert out.tobytes() == ref.tobytes(), name
        pos = data.index(b"\n-Y ") + 1
        pos = data.index(b"\n", pos) + 1
        h, w = out.shape[:2]
        rgbe = tassets._decode_scanlines(
            np.frombuffer(data, np.uint8, offset=pos), w, h)
        assert tassets._decode_rgbe(rgbe).tobytes() == out.tobytes(), name
        nat = tnative.hdr_decode_native(data[pos:], w, h)
        assert nat.tobytes() == rgbe.tobytes(), name
        if name == "rle":
            assert np.array_equal(nat, _rle_source())


def test_truncated_hdr_refused_natively(tmp_path, monkeypatch):
    """With the library loaded its verdict is final: a truncated payload
    gives None, and the numpy decoder is not asked."""
    data = _hdr_files(tmp_path)["rle"][:-50]
    called = []
    monkeypatch.setattr(tassets, "_decode_scanlines",
                        lambda *a: called.append(1))
    assert tassets.parse_hdr(data) is None
    assert not called


def test_no_native_routing(no_native, tmp_path, monkeypatch):
    """BUAS_NO_NATIVE=1: the Python OBJ parser and the numpy decoder, with
    the JAX package's Python results."""
    py = tassets.parse_obj(BAD_V)
    assert py.triangles[0, 0].tolist() == [0.0, 1.0, 0.5]
    _assert_mesh_equal(py, jassets.parse_obj(BAD_V))
    for case in sorted(OBJ_CASES):
        _assert_mesh_equal(tassets.parse_obj(OBJ_CASES[case]),
                           jassets._parse_obj_py(OBJ_CASES[case]))
    assert tnative.parse_obj_native(b"", False) is False
    assert tnative.hdr_decode_native(b"", 1, 1) is None
    real = tassets._decode_scanlines
    called = []

    def spy(*a):
        called.append(1)
        return real(*a)

    monkeypatch.setattr(tassets, "_decode_scanlines", spy)
    for name, data in _hdr_files(tmp_path).items():
        assert tassets.parse_hdr(data).tobytes() == \
            jassets.parse_hdr(data).tobytes(), name
    assert len(called) == 3
