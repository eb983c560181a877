"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and no
quiet CPU fallback when the caller asks for the card."""

import ast
import os

import jax  # noqa: F401  (both frameworks load in one process, as elsewhere)
import numpy as np
import pytest
import torch

import buas_pathtracer_tpu_torch as port
from buas_pathtracer_tpu_torch.core import vec
from buas_pathtracer_tpu_torch.models.scene import PostProcessSettings, Scene
from buas_pathtracer_tpu_torch.runtime import film, post, render

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(port.__file__))
FORBIDDEN = ("jax", "jaxlib", "buas_pathtracer_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _bad_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in FORBIDDEN:  # the port's own prefix differs at top level
                bad.append(name)
    return bad


def test_sources_found():
    srcs = _sources()
    assert len(srcs) > 20
    assert any(s.endswith("chip_smoke.py") for s in srcs)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    assert _bad_imports(path) == []


def test_checker_catches_forbidden(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\n"
                 "from buas_pathtracer_tpu.core import vec\n"
                 "import buas_pathtracer_tpu_torch\n"
                 "from . import x\n")
    assert _bad_imports(str(p)) == ["jax.numpy", "buas_pathtracer_tpu.core"]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_scene():
    sc = Scene()
    m = sc.add_diffuse_material((0.5, 0.5, 0.5), 1.2)
    sc.add_sphere(m, 1.0, vec.translate([0, 0, 3]))
    return sc


def test_pack_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tiny_scene().pack()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _tiny_scene().pack(device="cuda")


def test_render_frame_without_card_raises(no_card):
    sc = _tiny_scene()
    ps = sc.pack(device="cpu")
    accum = film.new_accumulation_buffer(4, 4, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render.render_frame(ps, sc.settings, sc.camera, accum, 0, h=4, w=4,
                            n_lights=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render.render(sc, 4, 4)


def test_post_process_without_card_raises(no_card):
    accum = torch.from_numpy(np.ones((4, 4, 4), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        post.post_process(accum, PostProcessSettings())
    out = post.post_process(accum, PostProcessSettings(), device="cpu")
    assert out.dtype == torch.uint8 and tuple(out.shape) == (4, 4, 4)


def test_cpu_tensors_refused_on_card_request(no_card):
    """A CPU scene handed to a card render is refused, not run on the CPU."""
    sc = _tiny_scene()
    ps = sc.pack(device="cpu")
    accum = film.new_accumulation_buffer(4, 4, "cpu")
    with pytest.raises(RuntimeError):
        render.render_frame(ps, sc.settings, sc.camera, accum, 0, h=4, w=4,
                            n_lights=0, device="cuda")
