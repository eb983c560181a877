"""The port's viewer (``buas_pathtracer_tpu_torch.app.viewer``), as
tests/test_viewer.py drives the JAX package's: the real ThreadingHTTPServer
and render thread on an ephemeral port, a 48x32 Cornell Box on the CPU
(``device="cpu"``), every endpoint class the page uses.  Beside it: the
sampler-debug images and the PNG encoder byte-equal to the JAX package's,
``FrameHistory`` equal to the JAX package's, the focus pick equal to the
walk's t for the picked ray, and no viewer without a card."""

import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import chip_smoke
from buas_pathtracer_tpu.app import sampler_debug as jsd
from buas_pathtracer_tpu.app import viewer as jviewer
from buas_pathtracer_tpu.utils.timing import FrameHistory as JHistory
from buas_pathtracer_tpu_torch.app import sampler_debug as tsd
from buas_pathtracer_tpu_torch.app import viewer as tviewer
from buas_pathtracer_tpu_torch.app.viewer import ViewerState, make_handler
from buas_pathtracer_tpu_torch.models import scenes as tscenes
from buas_pathtracer_tpu_torch.ops import traverse_wide
from buas_pathtracer_tpu_torch.utils.timing import FrameHistory as THistory

W, H = 48, 32


@pytest.fixture(scope="module")
def viewer(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("no_assets"))
    mp = pytest.MonkeyPatch()
    mp.setattr(tscenes, "DATA_DIR", data)
    state = ViewerState("Cornell Box", W, H, device="cpu")
    rt = threading.Thread(target=state.render_loop, daemon=True)
    rt.start()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    st = threading.Thread(target=server.serve_forever, daemon=True)
    st.start()
    yield state, f"http://127.0.0.1:{server.server_address[1]}"
    state.running = False
    rt.join(timeout=120)
    assert not rt.is_alive()
    server.shutdown()
    server.server_close()
    mp.undo()


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, r.read()


def post(base, msg):
    req = urllib.request.Request(base + "/control",
                                 data=json.dumps(msg).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status


def wait_for(pred, timeout=120.0, interval=0.1):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(interval)
    return False


class TestViewerEndpoints:
    def test_page_and_state(self, viewer):
        state, base = viewer
        code, body = get(base, "/")
        assert code == 200 and b"buas-pathtracer-tpu" in body
        assert f'width="{W}" height="{H}"'.encode() in body
        code, body = get(base, "/state")
        assert code == 200
        s = json.loads(body)
        assert s["scene"] == "Cornell Box"
        assert "Advanced Pathtracer" in s["integrators"]
        assert "Mitchell Netravali" in s["filters"]
        assert s["settings"]["max_bounce_count"] >= 1
        assert s["scenes"] == [d.name for d in tscenes.SCENES]
        for key in ("frame_ms", "encode_ms", "title", "mrays_per_s", "post"):
            assert key in s, key

    def test_progressive_frame_renders(self, viewer):
        state, base = viewer
        assert wait_for(lambda: json.loads(get(base, "/state")[1])["spp"]
                        >= 2), "render loop never produced a frame"
        code, body = get(base, "/frame.png")
        assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        assert len(body) > 200  # a rendered image, not the black start
        s = json.loads(get(base, "/state")[1])
        assert s["rays"] > 0 and s["frame_ms"] > 0
        assert s["title"].startswith(f"{s['spp']} spp, fps: ")

    def test_state_has_the_last_frame_record(self, viewer):
        state, base = viewer
        assert wait_for(lambda: json.loads(get(base, "/state")[1])["spp"]
                        >= 2), "render loop never produced a frame"
        s = json.loads(get(base, "/state")[1])
        live = s["live_lanes"]
        assert live and live[0] == W * H
        assert all(isinstance(n, int) and 0 < n <= W * H for n in live)
        assert live == sorted(live, reverse=True)
        # camera_on's 19 scalars, the sampler's table, a live count a
        # bounce, the stats, the dither tile and the image
        assert s["waits"] >= 19 + 1 + len(live) + 1 + 2
        assert s["wait_ms"] >= 0.0 and s["host_issue_ms"] > 0.0

    def test_controls_move_look_walk_focus(self, viewer):
        state, base = viewer
        cam = state.renderer.new_camera
        p0 = (float(cam.p.x), float(cam.p.z))
        assert post(base, {"type": "keys", "keys": ["w"], "fast": True}) \
            == 200
        moved = wait_for(lambda: (float(state.renderer.new_camera.p.x)
                                  - p0[0]) ** 2
                         + (float(state.renderer.new_camera.p.z) - p0[1]) ** 2
                         > 1e-8)
        post(base, {"type": "keys", "keys": [], "fast": False})
        assert moved, "WASD movement did not change the camera position"

        aim0 = float(state.renderer.new_camera.z.x)
        assert post(base, {"type": "look", "dx": 120, "dy": 0}) == 200
        assert abs(float(state.renderer.new_camera.z.x) - aim0) > 1e-6

        # walk mode: gravity and the one-ray floor query hold the eye
        # 1.7 above the floor below it
        assert post(base, {"type": "walk"}) == 200
        assert state.walk_mode
        assert wait_for(lambda: abs(float(state.renderer.new_camera.p.y)
                                    - 1.7) < 1e-3)
        assert post(base, {"type": "walk"}) == 200
        assert not state.walk_mode

        assert post(base, {"type": "focus", "x": W // 2, "y": H // 2}) == 200
        # the centre pixel hits the box's interior: a finite focus distance
        f = float(state.renderer.new_camera.focus_distance)
        assert 0.0 < f < 1e3

    def test_setting_and_filter_commit(self, viewer):
        state, base = viewer
        assert post(base, {"type": "setting", "field": "max_bounce_count",
                           "value": 3}) == 200
        assert state.renderer.new_settings.max_bounce_count == 3
        assert post(base, {"type": "filter", "name": "Box"}) == 200
        assert state.renderer.new_filter == "Box"
        assert wait_for(lambda: state.renderer.filter_name == "Box"
                        and state.renderer.settings.max_bounce_count == 3)
        assert post(base, {"type": "post", "field": "exposure",
                           "value": 0.5}) == 200
        assert state.renderer.scene.post_settings.exposure == 0.5

    def test_sampler_debug_images(self, viewer):
        state, base = viewer
        for kind, fn in (("scatter", jsd.scatter_plot),
                         ("hist", jsd.projection_histogram),
                         ("noise", jsd.noise_image)):
            code, body = get(base, f"/sampler.png?kind={kind}&strategy=2")
            assert code == 200 and body == jviewer.png_bytes(fn(2)), kind

    def test_take_picture(self, viewer, tmp_path):
        state, base = viewer
        out = str(tmp_path / "pic.png")
        assert post(base, {"type": "picture", "spp": 2, "path": out}) == 200
        assert wait_for(lambda: chip_smoke.png_complete(out), timeout=240), \
            "take_picture never wrote the whole PNG"


def test_focus_pick_is_the_walks_t(tmp_path, monkeypatch):
    """The focus distance a pick sets is the t of the walk's hit for that
    pixel's centre ray."""
    monkeypatch.setattr(tscenes, "DATA_DIR", str(tmp_path))
    state = ViewerState("Cornell Box", W, H, device="cpu")
    rays = state.pick_ray(10, 20)
    hit = traverse_wide.intersect_scene(state.renderer.ps, rays.o, rays.d)
    assert bool(hit.valid[0])
    state.focus_pick(10, 20)
    assert state.renderer.new_camera.focus_distance == float(hit.t[0])
    assert state._ray_down([0.0, 5.0, -2.0]) == pytest.approx(0.0, abs=1e-5)


@pytest.mark.parametrize("strategy", [0, 1, 2])
@pytest.mark.parametrize("kind", ["scatter_plot", "projection_histogram",
                                  "noise_image"])
def test_sampler_debug_byte_equal(kind, strategy):
    a = getattr(jsd, kind)(strategy)
    b = getattr(tsd, kind)(strategy, device="cpu")
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_png_bytes_equal():
    img = np.random.RandomState(4).randint(0, 256, (31, 45, 3)).astype(
        np.uint8)
    assert tviewer.png_bytes(img) == jviewer.png_bytes(img)


def test_frame_history_equal():
    seq = [0.5, 0.02, 0.031, 0.25, 0.0125] * 4 + [1.5, 0.001]
    j, t = JHistory(), THistory()
    assert t.title_line(0) == j.title_line(0)
    for k, s in enumerate(seq):
        j.push(s)
        t.push(s)
        assert (t.samples, t.at) == (j.samples, j.at)
        assert (t.min, t.max, t.avg) == (j.min, j.max, j.avg)
        assert t.title_line(k) == j.title_line(k)
    assert len(t.samples) == 15


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViewerState("Week 1", 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tviewer.main(["--scene", "Week 1", "--width", "8", "--height", "8",
                      "--port", "0"])
