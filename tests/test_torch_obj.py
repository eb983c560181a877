"""OBJ loading of the PyTorch port against the JAX package: the port's
Python parser equals the JAX package's Python parser exactly (every
tolerance rule of the reference's parser), and the JAX package's native
parser on icosphere OBJ text written with repr floats."""

import os

import numpy as np
import pytest

import chip_smoke
from buas_pathtracer_tpu.utils import assets as jassets
from buas_pathtracer_tpu.utils.procgen import icosphere as jico
from buas_pathtracer_tpu_torch.utils import assets as tassets

TRI = "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
CASES = {
    "v_vt_vn": (TRI + "vt 0 0\nvt 1 0\nvt 0 1\nvn 0 0 1\nvn 0 0.5 1\n"
                "vn 0.25 0 1\nf 1/1/1 2/2/2 3/3/3\n"),
    "positions_only": TRI + "f 1 2 3\n",
    "v_slash_slash_vn": TRI + "vn 0 0 1\nf 1//1 2//1 3//1\n",
    "negative_indices": (TRI + "v 1 1 0\nvn 0 0 1\nvn 0 0 -1\n"
                         "f -4//-2 -3//-1 -2//-2\nf -1 -2 -3\n"),
    "quad_fan": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n",
    "ngon_fan": ("".join(f"v {c!r} {s!r} 0.5\n" for c, s in zip(
        np.cos(np.linspace(0, 6, 7)).tolist(),
        np.sin(np.linspace(0, 6, 7)).tolist())) + "f 1 2 3 4 5 6 7\n"),
    "floats_and_junk": ("# comment\n\n  v 0.1 1e-3 -2.5e+2  \nv 1 0 x\n"
                        "v 0.3333333333333333 7 0\no name\ns off\n"
                        "vt 0.5 0.25 0.125\nvt 1 1\nvt 0 1\n"
                        "f 1/1 2/2 3/3\n"),
    "32_corners": ("".join(f"v {i} {i * i} 1\n" for i in range(32))
                   + "f " + " ".join(str(i + 1) for i in range(32)) + "\n"),
    # rejections: more than 32 corners, fewer than 3, texcoord / normal
    # counts that do not match the triangles, no face at all
    "33_corners": ("".join(f"v {i} 0 0\n" for i in range(33))
                   + "f " + " ".join(str(i + 1) for i in range(33)) + "\n"),
    "two_corners": TRI + "f 1 2\n",
    "vt_mismatch": TRI + "vt 0 0\nf 1/1 2/1 3/1\nf 1 2 3\n",
    "vn_mismatch": TRI + "vn 0 0 1\nf 1 2 3\nf 1//1 2//1 3//1\n",
    "no_faces": TRI,
    "empty": "",
}


def _assert_mesh_equal(a, b):
    """Both None, or every array present in both and byte-equal."""
    assert (a is None) == (b is None)
    if a is None:
        return
    for name in ("triangles", "normals", "texcoords"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert x.tobytes() == y.tobytes(), f"{name} differs"


@pytest.mark.parametrize("winding", ["ccw", "cw"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_python_parser_equal(case, winding):
    text = CASES[case]
    ref = jassets._parse_obj_py(text, winding)
    _assert_mesh_equal(tassets._parse_obj_py(text, winding), ref)
    _assert_mesh_equal(tassets.parse_obj(text, winding), ref)


def test_rejections_and_winding():
    """The cases meant to be rejected are, and cw reverses each corner
    order (the reference's winding flip)."""
    for case in ("33_corners", "two_corners", "vt_mismatch", "vn_mismatch",
                 "no_faces", "empty"):
        assert tassets.parse_obj(CASES[case]) is None, case
    ccw = tassets.parse_obj(CASES["quad_fan"], "ccw")
    cw = tassets.parse_obj(CASES["quad_fan"], "cw")
    assert ccw.triangle_count == 2
    np.testing.assert_array_equal(cw.triangles, ccw.triangles[:, ::-1])


@pytest.mark.parametrize("subdivisions", [1, 3])
def test_matches_native_parser_on_icosphere(subdivisions, tmp_path):
    """Icosphere OBJ text with repr floats: the port's parser and the JAX
    package's native parser give byte-equal meshes, through load_mesh."""
    text = chip_smoke.obj_text(jico(subdivisions=subdivisions))
    path = str(tmp_path / "ico.obj")
    with open(path, "w") as f:
        f.write(text)
    ref = jassets.load_mesh(path)
    assert ref is not None and ref.normals is not None
    _assert_mesh_equal(tassets.load_mesh(path), ref)
    _assert_mesh_equal(tassets.parse_obj(text), jassets.parse_obj(text))
    assert ref.triangle_count == 20 * 4 ** subdivisions


def test_missing_file(tmp_path):
    path = str(tmp_path / "missing.obj")
    assert not os.path.exists(path)
    assert tassets.load_mesh(path) is None
    assert jassets.load_mesh(path) is None
