"""Interactive progressive viewer: the counterpart of the reference's SDL
window and microui panel (raytracer.cpp:1560-2397).

Counterpart of ``buas_pathtracer_tpu/app/viewer.py`` (:1-432), with the same
endpoints and controls.  The card renders on a remote machine, so the
frontend is a zero-dependency HTTP app: a render thread drives
``ProgressiveRenderer`` (the settings-commit protocol), and a small HTML
page polls PNG frames and posts control events.  The walk-mode floor ray
and the focus pick are one-ray queries through
``ops/traverse_wide.intersect_scene``, on the card a one-ray walk.  The
render thread and the HTTP handler threads both launch kernels, on the
device's current stream.

Run:  python -m buas_pathtracer_tpu_torch.app.viewer [--scene "Cornell Box"]
      [--width 1024 --height 576 --port 8000] [--device cpu]

Controls (matching raytracer.cpp:1713-1890): WASD move, QE down/up, drag to
look, Shift = fast, F toggles fly/walk (walk applies gravity and snaps to the
floor via a downward scene ray, raytracer.cpp:1855-1890), Ctrl+click picks
the focus distance from the clicked pixel's hit (raytracer.cpp:1810-1826).
"""

from __future__ import annotations

import argparse
import json
import math
import threading
import time
from dataclasses import asdict, replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.vec import Vec3
from ..models import camera as cm
from ..models.scenes import SCENES, load_scene
from ..ops import traverse_wide
from ..ops.filters import FILTERS
from ..runtime.progressive import ProgressiveRenderer
from ..runtime.render import INTEGRATORS
from ..utils import trace
from ..utils.image import png_bytes
from ..utils.timing import FrameHistory
from . import sampler_debug as sd


class ViewerState:
    """Shared state between the render thread and HTTP handlers.
    ``device`` None means the CUDA card."""

    def __init__(self, scene_name: str, w: int, h: int, device=None):
        self.device = resolve_device(device)
        self.lock = threading.Lock()
        self.w, self.h = w, h
        self.scene_name = scene_name
        self.keys: set = set()
        self.fast = False
        self.walk_mode = False
        self.y_velocity = 0.0
        self.frame_png = png_bytes(np.zeros((h, w, 3), np.uint8))
        self.frame_ms = 0.0
        self.encode_ms = 0.0  # the PNG encode's part of frame_ms
        self.history = FrameHistory()  # 15-slot min/avg/max (raytracer.cpp:768-792)
        self.running = True
        self.picture_request = None  # (spp, path)
        self.picture_progress = None
        self._load(scene_name)

    def _load(self, name: str):
        self.scene = load_scene(name, self.w, self.h)
        self.renderer = ProgressiveRenderer(self.scene, self.w, self.h,
                                            device=self.device)
        self.scene_name = self.scene.name

    # -- camera helpers (raytracer.cpp:1837-1890) ---------------------------
    def _basis(self):
        c = self.renderer.new_camera
        ax = np.array([float(c.x.x), float(c.x.y), float(c.x.z)])
        ay = np.array([float(c.y.x), float(c.y.y), float(c.y.z)])
        az = np.array([float(c.z.x), float(c.z.y), float(c.z.z)])
        p = np.array([float(c.p.x), float(c.p.y), float(c.p.z)])
        return p, ax, ay, az

    def move(self, dt: float):
        if not self.keys and not self.walk_mode:
            return
        p, ax, ay, az = self._basis()
        speed = (10.0 if self.fast else 2.5) * dt
        delta = np.zeros(3)
        fwd = -az
        if self.walk_mode:  # movement stays in the horizontal plane
            fwd = fwd - np.array([0, 1, 0]) * fwd[1]
            n = np.linalg.norm(fwd)
            fwd = fwd / n if n > 1e-6 else fwd
        if "w" in self.keys:
            delta += fwd * speed
        if "s" in self.keys:
            delta -= fwd * speed
        if "d" in self.keys:
            delta += ax * speed
        if "a" in self.keys:
            delta -= ax * speed
        if "e" in self.keys:
            delta += np.array([0, 1, 0]) * speed
        if "q" in self.keys:
            delta -= np.array([0, 1, 0]) * speed
        p = p + delta

        if self.walk_mode:
            # gravity + downward collision ray (raytracer.cpp:1855-1884)
            self.y_velocity -= 9.81 * dt
            if " " in self.keys:  # jump
                self.y_velocity = 4.0
            p[1] += self.y_velocity * dt
            t = self._ray_down(p)
            eye = 1.7
            if t is not None and p[1] < t + eye:
                p[1] = t + eye
                self.y_velocity = 0.0
        cam = self.renderer.new_camera._replace(
            p=type(self.renderer.new_camera.p)(float(p[0]), float(p[1]), float(p[2])))
        self.renderer.new_camera = cm.recompute(cam)

    def _ray_down(self, p):
        """Floor height below p via a one-ray scene query."""
        def one(v):
            return torch.tensor([v], dtype=torch.float32, device=self.device)
        o = Vec3(one(p[0]), one(p[1]), one(p[2]))
        d = Vec3(one(0.0), one(-1.0), one(0.0))
        hit = traverse_wide.intersect_scene(self.renderer.ps, o, d)
        if bool(hit.valid[0]):
            return p[1] - float(hit.t[0])
        return None

    def look(self, dx: float, dy: float):
        p, ax, ay, az = self._basis()
        aim = -az
        yaw = math.atan2(aim[0], -aim[2])
        pitch = math.asin(np.clip(aim[1], -1, 1))
        yaw += dx * 0.003
        pitch = np.clip(pitch - dy * 0.003, -1.5, 1.5)
        aim = np.array([math.sin(yaw) * math.cos(pitch), math.sin(pitch),
                        -math.cos(yaw) * math.cos(pitch)])
        self.renderer.new_camera = cm.aim_camera(self.renderer.new_camera, -aim)

    def pick_ray(self, px: int, py: int):
        """The centre ray of pixel (px, py) through the lens centre."""
        dev = self.device
        u = torch.full((1,), 0.5, dtype=torch.float32, device=dev)
        return cm.generate_rays(
            cm.camera_on(self.renderer.new_camera, dev),
            torch.tensor([px], device=dev), torch.tensor([py], device=dev),
            self.w, self.h, u, u, u, u, 1.0, 0.0, 6.0, 0.5, 0.0)

    def focus_pick(self, px: int, py: int):
        """Ctrl+click: focus distance from the clicked pixel's hit t
        (raytracer.cpp:1810-1826)."""
        c = self.renderer.new_camera
        rays = self.pick_ray(px, py)
        hit = traverse_wide.intersect_scene(self.renderer.ps, rays.o, rays.d)
        if bool(hit.valid[0]):
            self.renderer.new_camera = cm.recompute(
                c._replace(focus_distance=float(hit.t[0])))

    # -- render loop ---------------------------------------------------------
    def render_loop(self):
        last = time.perf_counter()
        while self.running:
            now = time.perf_counter()
            with self.lock:
                self.move(min(now - last, 0.1))
                last = now
                req = self.picture_request
                self.picture_request = None
            if req is not None:
                spp, path = req
                self.renderer.take_picture(
                    spp, path,
                    progress=lambda done, total: setattr(
                        self, "picture_progress", (done, total)))
                self.picture_progress = None
            t0 = time.perf_counter()
            self.renderer.render_one_frame()
            img = self.renderer.display_rgba8()[..., :3]
            t1 = time.perf_counter()
            png = png_bytes(np.ascontiguousarray(img))
            t2 = time.perf_counter()
            with self.lock:
                self.frame_ms = (t2 - t0) * 1e3
                self.encode_ms = (t2 - t1) * 1e3
                self.history.push(self.frame_ms / 1e3)
                self.frame_png = png

    def stats(self) -> dict:
        r = self.renderer
        s = r.last_stats
        # the record of the last frame shown (utils/trace.py): its waits
        # on the card, the host's issue time, and each bounce's live lanes
        rec = trace.last_displayed()
        return {
            "scene": self.scene_name,
            "spp": r.frame_count,
            "frame_ms": round(self.frame_ms, 1),
            "encode_ms": round(self.encode_ms, 1),
            "title": self.history.title_line(r.frame_count),
            "mrays_per_s": round(float(s[0]) / max(self.frame_ms, 1e-3) / 1e3, 3),
            "rays": float(s[0]),
            "node_visits": float(s[1]),
            "tri_tests": float(s[2]),
            "waits": rec.waits if rec else 0,
            "wait_ms": round(rec.wait_ns / 1e6, 3) if rec else 0.0,
            "host_issue_ms": round(rec.host_issue_ns / 1e6, 3) if rec else 0.0,
            "live_lanes": [live for _, _, live in rec.bounces] if rec else [],
            "walk_mode": self.walk_mode,
            "scenes": [sc.name for sc in SCENES],
            "integrators": list(INTEGRATORS.keys()),
            "filters": [f.name for f in FILTERS],
            "filter": r.new_filter,
            "settings": asdict(r.new_settings),
            "post": asdict(self.renderer.scene.post_settings),
            "picture_progress": self.picture_progress,
        }

    def control(self, msg: dict):
        with self.lock:
            t = msg.get("type")
            if t == "keys":
                self.keys = set(msg.get("keys", []))
                self.fast = bool(msg.get("fast"))
            elif t == "look":
                self.look(float(msg.get("dx", 0)), float(msg.get("dy", 0)))
            elif t == "walk":
                self.walk_mode = not self.walk_mode
                self.y_velocity = 0.0
            elif t == "focus":
                self.focus_pick(int(msg["x"]), int(msg["y"]))
            elif t == "filter":
                self.renderer.new_filter = str(msg["name"])
            elif t == "setting":
                field, value = msg["field"], msg["value"]
                self.renderer.new_settings = replace(
                    self.renderer.new_settings, **{field: value})
            elif t == "post":
                field, value = msg["field"], msg["value"]
                self.renderer.scene.post_settings = replace(
                    self.renderer.scene.post_settings, **{field: value})
            elif t == "scene":
                self._load(msg["name"])
            elif t == "picture":
                self.picture_request = (int(msg.get("spp", 64)),
                                        str(msg.get("path", "picture.png")))


PAGE = """<!doctype html>
<html><head><title>buas-pathtracer-tpu</title><style>
body{margin:0;background:#111;color:#ccc;font:13px monospace;display:flex}
#img{image-rendering:pixelated;cursor:crosshair}
#panel{padding:10px;width:330px;overflow-y:auto;height:100vh}
label{display:block;margin:3px 0} input[type=range]{width:130px;vertical-align:middle}
select,button,input{background:#222;color:#ccc;border:1px solid #444}
#stats{white-space:pre;color:#8c8}
</style></head><body>
<div><img id="img" width="%W%" height="%H%"></div>
<div id="panel">
<div id="stats">...</div><hr>
<label>scene <select id="scene"></select></label>
<label>integrator <select id="integrator"></select></label>
<label>filter <select id="filter"></select></label>
<div id="settings"></div><hr>
<div id="post"></div><hr>
<label>take picture: spp <input id="spp" value="256" size="5">
<button onclick="takePicture()">go</button> <span id="pic"></span></label>
<p>WASD move &middot; QE down/up &middot; drag = look &middot; shift = fast
&middot; F = walk mode &middot; ctrl+click = focus</p>
<details><summary>sampler debug</summary>
<label>strategy <select id="sstrat"><option value="0">Uniform</option>
<option value="1">Blue Noise</option><option value="2" selected>Stratified</option></select></label>
<img id="sscatter" width="128" height="128"> <img id="snoise" width="128" height="128"><br>
<img id="shist" width="256" height="128">
<script>
function refreshSampler(){
  const st = document.getElementById('sstrat').value;
  document.getElementById('sscatter').src = '/sampler.png?kind=scatter&strategy='+st+'&t='+Date.now();
  document.getElementById('snoise').src = '/sampler.png?kind=noise&strategy='+st+'&t='+Date.now();
  document.getElementById('shist').src = '/sampler.png?kind=hist&strategy='+st+'&t='+Date.now();
}
document.getElementById('sstrat').onchange = refreshSampler; refreshSampler();
</script></details>
</div>
<script>
const img = document.getElementById('img');
let keys = new Set(), fast = false;
function post(m){fetch('/control',{method:'POST',body:JSON.stringify(m)});}
function refresh(){img.src = '/frame.png?' + Date.now();}
img.onload = () => setTimeout(refresh, 60); refresh();
setInterval(async () => {
  const s = await (await fetch('/state')).json();
  document.getElementById('stats').textContent =
    `${s.scene}  ${s.spp} spp\\n${s.frame_ms} ms/frame  ${s.mrays_per_s} Mrays/s\\n` +
    `node visits ${s.node_visits}  tri tests ${s.tri_tests}` +
    (s.walk_mode ? '\\n[walk mode]' : '') +
    (s.picture_progress ? `\\npicture ${s.picture_progress[0]}/${s.picture_progress[1]}` : '');
  fillSelect('scene', s.scenes, s.scene, n => post({type:'scene', name:n}));
  fillSelect('integrator', s.integrators, s.settings.integrator,
             n => post({type:'setting', field:'integrator', value:n}));
  fillSelect('filter', s.filters, s.filter,
             n => post({type:'filter', name:n}));
  fillSettings('settings', s.settings, 'setting');
  fillSettings('post', s.post, 'post');
}, 1000);
function fillSelect(id, opts, cur, cb){
  const el = document.getElementById(id);
  if (el.dataset.done !== '1'){
    el.innerHTML = opts.map(o => `<option>${o}</option>`).join('');
    el.onchange = () => cb(el.value); el.dataset.done = '1';
  }
  if (document.activeElement !== el) el.value = cur;
}
function fillSettings(id, obj, type){
  const el = document.getElementById(id);
  if (el.dataset.done === '1') return; el.dataset.done = '1';
  for (const [k, v] of Object.entries(obj)){
    if (k === 'integrator') continue;
    const row = document.createElement('label');
    if (typeof v === 'boolean'){
      row.innerHTML = `<input type="checkbox" ${v?'checked':''}> ${k}`;
      row.firstChild.onchange = e => post({type, field:k, value:e.target.checked});
    } else {
      row.innerHTML = `${k} <input size="6" value="${v}">`;
      row.querySelector('input').onchange =
        e => post({type, field:k, value:parseFloat(e.target.value)});
    }
    el.appendChild(row);
  }
}
onkeydown = e => {
  if (e.key === 'f' || e.key === 'F'){ post({type:'walk'}); return; }
  keys.add(e.key.toLowerCase()); fast = e.shiftKey; sendKeys();
};
onkeyup = e => { keys.delete(e.key.toLowerCase()); fast = e.shiftKey; sendKeys(); };
function sendKeys(){ post({type:'keys', keys:[...keys], fast}); }
let drag = null;
img.onmousedown = e => {
  if (e.ctrlKey){
    const r = img.getBoundingClientRect();
    post({type:'focus', x: Math.floor((e.clientX-r.left)*%W%/r.width),
                        y: Math.floor((e.clientY-r.top)*%H%/r.height)});
    return;
  }
  drag = [e.clientX, e.clientY];
};
onmouseup = () => drag = null;
onmousemove = e => {
  if (!drag) return;
  post({type:'look', dx: e.clientX-drag[0], dy: e.clientY-drag[1]});
  drag = [e.clientX, e.clientY];
};
function takePicture(){
  post({type:'picture', spp: parseInt(document.getElementById('spp').value),
        path: 'picture.png'});
}
</script></body></html>"""


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/sampler.png"):
                # sampler debug images (raytracer.cpp:2199-2290):
                # /sampler.png?kind=scatter|hist|noise&strategy=0|1|2
                q = parse_qs(urlparse(self.path).query)
                kind = q.get("kind", ["scatter"])[0]
                strat = int(q.get("strategy", ["2"])[0])
                fn = {"scatter": sd.scatter_plot, "hist": sd.projection_histogram,
                      "noise": sd.noise_image}.get(kind, sd.scatter_plot)
                self._send(200, "image/png",
                           png_bytes(fn(strat, device=state.device)))
            elif self.path.startswith("/frame.png"):
                with state.lock:
                    png = state.frame_png
                self._send(200, "image/png", png)
            elif self.path.startswith("/state"):
                self._send(200, "application/json",
                           json.dumps(state.stats()).encode())
            else:
                page = (PAGE.replace("%W%", str(state.w))
                        .replace("%H%", str(state.h)))
                self._send(200, "text/html", page.encode())

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            msg = json.loads(self.rfile.read(n) or b"{}")
            state.control(msg)
            self._send(200, "application/json", b"{}")

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="Nested Dielectrics")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=576)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address; the control API is unauthenticated, "
                         "pass 0.0.0.0 only to expose it deliberately")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    state = ViewerState(args.scene, args.width, args.height,
                        device=args.device)
    t = threading.Thread(target=state.render_loop, daemon=True)
    t.start()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(state))
    print(f"viewer: http://localhost:{args.port}  scene={state.scene_name}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.running = False
        t.join(timeout=60)
        server.server_close()


if __name__ == "__main__":
    main()
