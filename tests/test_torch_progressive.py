"""Progressive rendering and checkpoints of the PyTorch port: the JAX
package's own checks (tests/test_checkpoint.py, and the per-pass cancel and
split passes of tests/test_viewer.py) run on the port, where resume and
split passes are bit-identical; and a checkpoint written by either package
resumes in the other and finishes within the goldens' tolerance
(rtol = atol = 2e-3, ``test_torch_render.assert_image_close``) of the
other's uninterrupted render."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from buas_pathtracer_tpu.core import vec as jvec
from buas_pathtracer_tpu.models import camera as jcm
from buas_pathtracer_tpu.models.scene import Scene as JScene
from buas_pathtracer_tpu.models.scene import SceneSettings as JSettings
from buas_pathtracer_tpu.runtime import checkpoint as jckpt
from buas_pathtracer_tpu.runtime.progressive import \
    ProgressiveRenderer as JRenderer
from buas_pathtracer_tpu_torch.core import vec as tvec
from buas_pathtracer_tpu_torch.models import camera as tcm
from buas_pathtracer_tpu_torch.models.scene import Scene as TScene
from buas_pathtracer_tpu_torch.models.scene import SceneSettings as TSettings
from buas_pathtracer_tpu_torch.runtime import checkpoint as tckpt
from buas_pathtracer_tpu_torch.runtime import film
from buas_pathtracer_tpu_torch.runtime import progressive as tprog
from buas_pathtracer_tpu_torch.runtime.progressive import \
    ProgressiveRenderer as TRenderer
from buas_pathtracer_tpu_torch.runtime.render import render_frame
from test_torch_render import assert_image_close

J = (JScene, jvec, jcm, JSettings)
T = (TScene, tvec, tcm, TSettings)


def small_scene(Scene, vec, cm, Settings, spp=1, bounces=3):
    """tests/test_checkpoint.py's scene."""
    sc = Scene(name="ckpt")
    m = sc.add_diffuse_material((0.7, 0.7, 0.7), 1.2)
    li = sc.add_emissive_material((10, 10, 10))
    sc.add_plane(m, (0, 1, 0), 0.0)
    sc.add_sphere(m, 1.0, vec.translate([0, 1, 3]))
    sc.add_sphere(li, 0.5, vec.translate([0, 4, 2]))
    sc.camera = cm.aim_camera_at(
        cm.make_camera(p=(0, 2, -3), aspect=1.0), (0, 1, 3))
    sc.settings = Settings(samples_per_pixel=spp, max_bounce_count=bounces)
    return sc


def port(w=16, h=16, **kw):
    return TRenderer(small_scene(*T, **kw), w, h, device="cpu")


def test_resume_bitwise_identical(tmp_path):
    p = str(tmp_path / "ckpt.npz")
    r1 = port()
    for _ in range(2):
        r1.render_one_frame()
    tckpt.checkpoint_renderer(r1, p)
    for _ in range(2):
        r1.render_one_frame()
    straight = r1.resolve_hdr()

    r2 = port()
    assert tckpt.resume_into(r2, p) == 2
    assert r2.accum.device == r2.device
    for _ in range(2):
        r2.render_one_frame()
    np.testing.assert_array_equal(straight, r2.resolve_hdr())


def test_mismatch_refused(tmp_path):
    p = str(tmp_path / "ckpt.npz")
    r1 = port()
    r1.render_one_frame()
    tckpt.checkpoint_renderer(r1, p)
    with pytest.raises(ValueError, match="settings differ"):
        tckpt.resume_into(port(bounces=5), p)
    with pytest.raises(ValueError, match="renderer is 8x8"):
        tckpt.resume_into(port(8, 8), p)
    r4 = port()
    r4.new_camera = r4.new_camera._replace(focus_distance=3.0)
    with pytest.raises(ValueError, match="camera differs"):
        tckpt.resume_into(r4, p)


def test_take_picture_resumes_from_checkpoint(tmp_path):
    """A take_picture interrupted mid-render resumes from its checkpoint
    and gives the image of an uninterrupted run, bit for bit, in the
    accumulation and in the written file."""
    ck = str(tmp_path / "pic.ckpt.npz")
    r1 = port()
    r1.take_picture(6, str(tmp_path / "a.png"), checkpoint_every=2,
                    checkpoint_path=ck)
    r2 = port()  # the "preempted" run picks up the 6-spp checkpoint
    r2.take_picture(8, str(tmp_path / "b.png"), checkpoint_path=ck)
    r3 = port()
    r3.take_picture(8, str(tmp_path / "c.png"))
    assert r2.frame_count == r3.frame_count == 8
    assert torch.equal(r2.accum, r3.accum)
    with open(tmp_path / "b.png", "rb") as f2, \
            open(tmp_path / "c.png", "rb") as f3:
        assert f2.read() == f3.read()
    r3.take_picture(8, str(tmp_path / "c.bmp"))
    with open(tmp_path / "c.bmp", "rb") as f:
        assert f.read(2) == b"BM"


def test_filter_change_commits_and_resets():
    """A filter change resets the accumulation at the next frame boundary
    and the frame renders with the new filter."""
    r = port()
    r.render_one_frame()
    assert r.frame_count == 1
    r.new_filter = "Lanczos 4"
    r.render_one_frame()
    assert r.frame_count == 1 and r.filter_name == "Lanczos 4"
    sc = small_scene(*T)
    sc.filter_name = "Lanczos 4"
    ref = TRenderer(sc, 16, 16, device="cpu")
    ref.render_one_frame()
    np.testing.assert_array_equal(r.resolve_hdr(), ref.resolve_hdr())


def test_camera_change_commits_and_resets():
    r = port()
    r.render_one_frame()
    r.render_one_frame()
    assert r.frame_count == 2
    r.new_camera = tcm.aim_camera_at(r.new_camera, (0.5, 1, 3))
    r.render_one_frame()
    assert r.frame_count == 1 and r.camera is r.new_camera


def test_per_pass_cancellation(monkeypatch):
    """A settings change between sample passes aborts the frame after the
    pass in which it landed (tests/test_viewer.py:149)."""
    r = port(spp=6, bounces=2)
    passes = []
    orig = tprog.ProgressiveRenderer._render_pass

    def spy(self, settings):
        passes.append(int(settings.samples_per_pixel))
        if len(passes) == 2:  # the "UI thread" edits mid-frame
            self.new_settings = replace(self.new_settings, max_bounce_count=3)
        return orig(self, settings)

    monkeypatch.setattr(tprog.ProgressiveRenderer, "_render_pass", spy)
    r.render_one_frame()
    assert passes == [1, 1], f"frame did not abort between passes: {passes}"
    assert r.frame_count == 2
    r.render_one_frame()  # commits the change and restarts
    assert r.settings.max_bounce_count == 3
    assert r.frame_count == 6


def test_per_pass_split_matches_fused():
    """Passes one sample at a time give the fused render_frame's image bit
    for bit (tests/test_viewer.py:201), and the same stats."""
    sc = small_scene(*T, spp=4, bounces=2)
    r = TRenderer(sc, 16, 16, device="cpu")
    r.render_one_frame()
    ps = sc.pack(device="cpu")
    accum = film.new_accumulation_buffer(16, 16, "cpu")
    accum, stats = render_frame(ps, sc.settings, sc.camera, accum, 0, h=16,
                                w=16, n_lights=sc.n_lights, device="cpu")
    assert torch.equal(r.accum, accum)
    np.testing.assert_array_equal(r.last_stats, stats.numpy())
    assert r.frame_count == 4


def test_resolve_hdr_and_stats_match_jax():
    j = JRenderer(small_scene(*J), 16, 16)
    t = port()
    for _ in range(2):
        j.render_one_frame()
        t.render_one_frame()
    assert_image_close(t.resolve_hdr(), j.resolve_hdr())
    assert t.last_stats[0] == float(j.last_stats[0])  # rays traced
    assert t.frame_count == j.frame_count == 2
    # the u8 display image within 1 LSB (the post tests' rule)
    diff = np.abs(t.display_rgba8().astype(int)
                  - np.asarray(j.display_rgba8()).astype(int))
    assert diff.max() <= 1


def test_checkpoint_format_equal(tmp_path):
    """The two packages write the same keys with the same dtypes and
    shapes, the camera leaves equal."""
    j, t = JRenderer(small_scene(*J), 16, 16), port()
    j.render_one_frame()
    t.render_one_frame()
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.checkpoint_renderer(j, pj)
    tckpt.checkpoint_renderer(t, pt)
    with np.load(pj) as zj, np.load(pt) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape
            if k.startswith("cam_") or k in ("n_cam", "frame_count",
                                             "settings"):
                assert zj[k].tobytes() == zt[k].tobytes(), k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(writer, tmp_path):
    """Two frames in one package, a checkpoint, two more frames in the
    other: within tolerance of the finishing package's uninterrupted four
    frames."""
    p = str(tmp_path / "ckpt.npz")
    first = JRenderer(small_scene(*J), 16, 16) if writer == "jax" else port()
    for _ in range(2):
        first.render_one_frame()
    (jckpt if writer == "jax" else tckpt).checkpoint_renderer(first, p)

    if writer == "jax":
        resumed, straight, ck = port(), port(), tckpt
    else:
        resumed = JRenderer(small_scene(*J), 16, 16)
        straight = JRenderer(small_scene(*J), 16, 16)
        ck = jckpt
    assert ck.resume_into(resumed, p) == 2
    for _ in range(2):
        resumed.render_one_frame()
    for _ in range(4):
        straight.render_one_frame()
    assert resumed.frame_count == straight.frame_count == 4
    assert_image_close(np.asarray(resumed.resolve_hdr()),
                       np.asarray(straight.resolve_hdr()))


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRenderer(small_scene(*T), 8, 8)
