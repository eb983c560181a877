"""The port's tracer (``buas_pathtracer_tpu_torch/utils/trace.py``): a
frame's record counts every wait by its site and the bounces' lanes as the
integrator saw them; spans exist only while a profiler records and nest as
the documented tree on the profiler's timeline; the ring, the launch
counters and the set-up phases.  A card test holds the waits counted in one
1080p bench frame to the synchronising operations PyTorch reports, and the
device work launched inside the spans of the same frame to its device
time."""

import json
import os
import tempfile
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from buas_pathtracer_tpu_torch import native
from buas_pathtracer_tpu_torch.core import vec
from buas_pathtracer_tpu_torch.integrators import advanced
from buas_pathtracer_tpu_torch.models import camera as cm
from buas_pathtracer_tpu_torch.models.scene import Scene, SceneSettings
from buas_pathtracer_tpu_torch.runtime.progressive import ProgressiveRenderer
from buas_pathtracer_tpu_torch.utils import trace

W, H = 32, 16
BOUNCES = 4
CAMERA_SCALARS = 19  # camera_on: p, x, y, z (3 each) and 7 scalars

# each span's nearest enclosing span, as utils/trace.py documents the tree
PARENTS = {
    "pt.frame": {None}, "pt.display": {None},
    "pt.camera": {"pt.frame", "pt.pass"}, "pt.pass": {"pt.frame"},
    "pt.wait.camera": {"pt.camera"}, "pt.wait.sampler_tables": {"pt.camera"},
    "pt.bounce": {"pt.pass"}, "pt.wait.live_count": {"pt.bounce"},
    "pt.intersect": {"pt.bounce"}, "pt.nee": {"pt.bounce"},
    "pt.film": {"pt.pass"}, "pt.wait.stats": {"pt.frame"},
    "pt.post": {"pt.display"}, "pt.wait.dither_tile": {"pt.display"},
    "pt.wait.readback": {"pt.display"},
}


def small_scene(w=W, h=H):
    sc = Scene(name="trace")
    grey = sc.add_diffuse_material((0.6, 0.6, 0.6), 1.2)
    red = sc.add_diffuse_material((0.8, 0.2, 0.2), 1.4)
    glass = sc.add_translucent_material((0.2, 0.1, 0.0), 1.5)
    light = sc.add_emissive_material((15, 14, 12))
    sc.add_plane(grey, (0, 1, 0), 0.0)
    sc.add_sphere(red, 1.0, vec.translate([-1.2, 1, 4]))
    sc.add_sphere(glass, 0.9, vec.translate([1.2, 0.9, 3]))
    sc.add_sphere(light, 0.6, vec.translate([0, 4, 2]))
    sc.camera = cm.aim_camera_at(
        cm.make_camera(p=(0, 1.8, -3), vfov=np.radians(55), aspect=w / h),
        (0, 1.0, 3.5))
    sc.settings = SceneSettings(max_bounce_count=BOUNCES,
                                samples_per_pixel=1)
    sc.filter_name = "Mitchell Netravali"
    return sc


@pytest.fixture(scope="module")
def renderer():
    r = ProgressiveRenderer(small_scene(), W, H, device="cpu")
    r.render_one_frame()
    r.display_rgba8()
    return r


def _frame(r):
    r.render_one_frame()
    r.display_rgba8()
    return trace.records()[-1]


def test_frame_record_counts_each_wait_by_site(renderer, monkeypatch):
    """Every wait site of a frame and its display, counted once a call;
    the bounces are those the integrator ran, with the lanes and live
    lanes its state held."""
    seen = []
    body = advanced._bounce

    def watched(ps, f, st, stats, bounce):
        seen.append((bounce, int(st.alive.shape[0]), int(st.alive.sum())))
        return body(ps, f, st, stats, bounce)

    monkeypatch.setattr(advanced, "_bounce", watched)
    rec = _frame(renderer)
    assert rec.bounces == seen and seen
    assert seen[0] == (0, W * H, W * H)
    # the loop reads the live count before each bounce, and once more when
    # every lane died before the last bounce
    counts = len(seen) + (len(seen) < BOUNCES)
    want = {"camera": CAMERA_SCALARS, "sampler_tables": 1,
            "live_count": counts, "stats": 1, "dither_tile": 1,
            "readback": 1}
    assert {k: n for k, (n, _) in rec.sites.items()} == want
    assert rec.waits == sum(want.values())
    assert rec.wait_ns == sum(ns for _, ns in rec.sites.values())
    assert 0 < rec.wait_ns < rec.host_ns
    assert rec.host_issue_ns == rec.host_ns - rec.wait_ns
    assert rec.launches == {}  # the plain versions on the CPU
    assert trace.last_displayed() is rec


def test_no_spans_without_a_profiler(renderer):
    rec = _frame(renderer)
    assert not rec.spans_on and rec.marks == []
    assert trace.span("pt.frame") is trace.NULL_SPAN
    assert trace.span("pt.bounce") is trace.NULL_SPAN


def _pt_parent(ev):
    p = ev.cpu_parent
    while p is not None and not p.name.startswith("pt."):
        p = p.cpu_parent
    return None if p is None else p.name


def test_profiler_holds_the_span_tree(renderer):
    """Under torch.profiler on the CPU, every ``pt.`` span is an event of
    the profiler's, nested as the tree says, once a call, and the record
    marks both ends of each, in order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = _frame(renderer)
    # off again once the display returned
    assert trace.span("pt.frame") is trace.NULL_SPAN
    assert rec.spans_on
    events = [e for e in prof.events() if e.name.startswith("pt.")]
    assert {e.name for e in events} == set(PARENTS)
    for e in events:
        assert _pt_parent(e) in PARENTS[e.name], (e.name, _pt_parent(e))
    count = {n: sum(e.name == n for e in events) for n in PARENTS}
    assert count["pt.bounce"] == rec.sites["live_count"][0]
    assert count["pt.intersect"] == count["pt.nee"] == len(rec.bounces)
    assert count["pt.wait.camera"] == CAMERA_SCALARS
    assert count["pt.camera"] == 3  # camera_on; the rays; the vignette
    assert count["pt.frame"] == count["pt.display"] == count["pt.pass"] == 1
    stack = []
    for name, entry in rec.marks:
        if entry:
            stack.append(name)
        else:
            assert stack.pop() == name
    assert stack == []
    assert sorted(n for n, entry in rec.marks if entry) == sorted(
        e.name for e in events)


def test_last_displayed_is_a_whole_frame_and_its_display():
    """A viewer reads the record of a frame whose display has returned,
    not one whose display has yet to begin or still runs."""
    t = trace.Tracer()
    assert t.last_displayed() is None
    with t.frame() as first:
        pass
    assert t.last_displayed() is None  # no display yet
    with t.display():
        assert t.last_displayed() is None  # still running
        t.wait("readback", int, torch.tensor(1))
    assert t.last_displayed() is first
    with t.frame() as second:
        assert t.last_displayed() is first
    assert t.last_displayed() is first  # its display has not begun
    with t.display():
        pass
    assert t.last_displayed() is second


def test_waits_outside_a_frame_are_not_counted():
    """A readback between frames (a picture's) still runs, and is counted
    in no record, so a record's issue time never goes negative."""
    t = trace.Tracer()
    with t.frame() as rec:
        t.wait("stats", int, torch.tensor(1))
        t.launch("closest")
        t.bounce(0, 8, 8)
    assert t.wait("readback", int, torch.tensor(7)) == 7
    t.launch("closest")
    t.bounce(1, 8, 4)
    assert rec.waits == 1 and set(rec.sites) == {"stats"}
    assert rec.launches == {"closest": 1} and rec.bounces == [(0, 8, 8)]
    assert rec.host_issue_ns >= 0
    assert t.launch_totals()["closest"] == 2  # the process's totals


def test_ring_keeps_the_last_records():
    t = trace.Tracer()
    for i in range(trace.RING + 5):
        with t.frame() as rec:
            assert t.wait("stats", int, torch.tensor(i)) == i
            t.launch("closest")
            t.bounce(0, 8, 3)
    recs = t.records()
    assert len(recs) == trace.RING
    assert [r.seq for r in recs] == list(range(6, trace.RING + 6))
    assert rec is recs[-1] and rec.waits == 1 and rec.bounces == [(0, 8, 3)]
    assert rec.launches == {"closest": 1}
    assert t.launch_totals() == dict(dict.fromkeys(trace.KERNELS, 0),
                                     closest=trace.RING + 5)


def test_display_adds_to_the_frame_record():
    t = trace.Tracer()
    with t.frame() as rec:
        t.wait("stats", int, torch.tensor(1))
    with t.display() as same:
        t.wait("readback", int, torch.tensor(2))
    assert same is rec and rec.waits == 2 and set(rec.sites) == {
        "stats", "readback"}
    assert rec.host_ns >= rec.wait_ns > 0
    with t.frame() as nxt:
        pass
    assert nxt is not rec and nxt.waits == 0
    assert rec.displays == 1 and nxt.displays == 0


def test_spans_while_profiling_nest_in_the_record():
    t = trace.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.frame() as rec:
            with t.span("pt.a"):
                with t.span("pt.b"):
                    t.wait("s", int, torch.tensor(3))
            with t.span("pt.c"):
                pass
        assert t.span("pt.d") is trace.NULL_SPAN  # off between frames
    assert rec.spans_on and rec.waits == 1
    assert rec.marks == [
        ("pt.frame", True), ("pt.a", True), ("pt.b", True),
        ("pt.wait.s", True), ("pt.wait.s", False), ("pt.b", False),
        ("pt.a", False), ("pt.c", True), ("pt.c", False),
        ("pt.frame", False)]
    events = [e for e in prof.events() if e.name.startswith("pt.")]
    assert sorted((e.name, _pt_parent(e)) for e in events) == [
        ("pt.a", "pt.frame"), ("pt.b", "pt.a"), ("pt.c", "pt.frame"),
        ("pt.frame", None), ("pt.wait.s", "pt.b")]


def test_setup_phases_are_timed():
    before = trace.phases()
    small_scene().pack(device="cpu")
    ph = trace.phases()
    grew = {k: ph[k] - before.get(k, 0.0) for k in ph}
    parts = ("scene_pack.build", "scene_pack.split", "scene_pack.upload")
    assert all(grew[k] > 0 for k in ("scene_pack",) + parts)
    assert sum(grew[k] for k in parts) <= grew["scene_pack"]
    if native.available():  # loaded (or built) once a process
        assert ph["kernel_load"] > 0
    with trace.phase("x.test"):
        pass
    assert trace.phases()["x.test"] >= 0.0


def _sync_warnings(fn):
    """The synchronising operations PyTorch reports while ``fn`` runs
    (``set_sync_debug_mode``), by the line of the port that made each."""
    sites = []

    def show(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()
        if any(f.name == fn.__name__ for f in stack):
            port = [f for f in stack
                    if "buas_pathtracer_tpu_torch" in f.filename]
            sites.append(f"{port[-1].filename}:{port[-1].lineno}"
                         if port else f"{filename}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites


def _device_ms_by_span(prof):
    """(device ms of the work launched inside each ``pt.`` span, the same
    less its child spans'), each kernel, copy and set tied to its launch
    call by the profiler's correlation id."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            xs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.remove(path)
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
             if e["name"].startswith("pt.")
             and e.get("cat") in ("cpu_op", "user_annotation")]
    launched = {e["args"]["correlation"]: e["ts"] for e in xs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    incl, own = {}, {}
    for e in xs:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        at = launched[e["args"]["correlation"]]
        inside = sorted((s for s in spans if s[0] <= at < s[1]),
                        key=lambda s: (s[0], -s[1]))
        for name in {s[2] for s in inside}:
            incl[name] = incl.get(name, 0.0) + e["dur"] * 1e-3
        if inside:
            name = inside[-1][2]
            own[name] = own.get(name, 0.0) + e["dur"] * 1e-3
    return incl, own


@pytest.mark.gpu
def test_card_waits_are_the_syncs_and_spans_cover_the_frame():
    """One bench frame at 1080p: the waits its record counts are the
    synchronising operations PyTorch reports, so no wait site is missed;
    with spans on, the work launched inside the frame's child spans is at
    least 95% of the frame's device work, and the layers add up to it
    within 10%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from buas_pathtracer_tpu_torch.models.scenes import build_bench_scene
    r = ProgressiveRenderer(build_bench_scene(1920, 1080), 1920, 1080,
                            device="cuda")
    r.render_one_frame()
    r.display_rgba8()
    torch.cuda.synchronize()

    def one_frame():
        r.render_one_frame()
        r.display_rgba8()

    sites = _sync_warnings(one_frame)
    rec = trace.records()[-1]
    assert len(sites) == rec.waits, (sites, rec.sites)
    assert rec.launches["closest"] == rec.launches["occlusion"] \
        == rec.launches["shade_hit"] == rec.launches["shade_next"] \
        == len(rec.bounces) and rec.launches["post_rgba8"] == 1

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r.render_one_frame()
        torch.cuda.synchronize()
    assert trace.records()[-1].spans_on
    ms, own = _device_ms_by_span(prof)
    assert own.get("pt.frame", 0.0) <= 0.05 * ms["pt.frame"], (ms, own)
    layers = (ms["pt.camera"] + ms["pt.intersect"] + ms["pt.nee"]
              + own["pt.bounce"] + ms["pt.film"])
    assert abs(layers - ms["pt.frame"]) <= 0.1 * ms["pt.frame"], (ms, own)
