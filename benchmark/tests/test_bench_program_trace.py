"""The readers of what the program records about itself
(``harness/program_trace.py``): canned frame records of the port's tracer
give each counter's number, from the window's untraced frames only; a
canned host-labelled stretch gives each span's device time, the work
launched inside it; a program without the tracer, or a window without such
frames or spans, gives None."""

import json
import os
import shutil
import tempfile

import pytest

from benchmark.harness import cells
from benchmark.harness import program_trace as pt
from buas_pathtracer_tpu_torch.utils import trace

NEW = ("host_syncs_per_frame.final", "host_syncs_per_frame.preview",
       "sync_wait_ms.final", "sync_wait_ms.preview", "host_issue_ms.final",
       "host_issue_ms.preview", "live_lane_pct.final",
       "intersect_device_ms.final", "nee_device_ms.final",
       "shade_device_ms.final", "film_device_ms.final", "kernel_load_s",
       "scene_pack_s", "dither_tile_s")


def reader(name):
    return cells._load_py(f"{cells.BENCH_DIR}/metrics/{name}.py",
                          "program_trace_" + name.replace(".", "_"))


def frame(seq, waits, wait_ms, host_ms, bounces, spans_on=False):
    r = trace.FrameRecord(seq)
    r.waits, r.wait_ns, r.host_ns = waits, int(wait_ms * 1e6), int(
        host_ms * 1e6)
    r.bounces = list(bounces)
    r.spans_on = spans_on
    return r


# one frame as the program runs it: span ends, launches (the kind of the
# device event and its us), the waits' blocks
FRAME = [("(", "pt.frame"), ("(", "pt.camera"), ("(", "pt.wait.camera"),
         ("C", 0.5), ("Y",), (")", "pt.wait.camera"), ("K", 1.0),
         (")", "pt.camera"), ("(", "pt.pass"), ("(", "pt.bounce"),
         ("(", "pt.wait.live_count"), ("C", 0.5), ("Y",),
         (")", "pt.wait.live_count"), ("K", 3.0), ("(", "pt.intersect"),
         ("K", 4.0), ("K", 6.0), (")", "pt.intersect"), ("(", "pt.nee"),
         ("K", 7.0), ("S", 1.0), (")", "pt.nee"), ("K", 5.0),
         (")", "pt.bounce"), ("(", "pt.film"), ("K", 8.0), (")", "pt.film"),
         (")", "pt.pass"), ("(", "pt.wait.stats"), ("C", 0.25), ("Y",),
         (")", "pt.wait.stats"), (")", "pt.frame")]
CALL = {"K": "cudaLaunchKernel", "C": "cudaMemcpyAsync",
        "S": "cudaMemsetAsync"}
CAT = {"K": "kernel", "C": "gpu_memcpy", "S": "gpu_memset"}


def traced_stretch(n=2, drop_head=0, drop_tail=0):
    """The records of ``n`` traced frames and a padding frame, and the
    stretch of the ``n`` frames as the profiler gives it: the host's calls,
    a marker launch before each frame (whose device event the stretch
    leaves out), the padding frame's first calls; the device's events on a
    clock 300 us behind.  ``drop_head`` / ``drop_tail`` calls fall outside
    the host list at its ends."""
    recs, host, device, t = [], [], [], 0.0
    for f in range(n + 1):
        r = frame(10 + f, 0, 0.0, 0.0, [], True)
        r.marks = [(name, kind == "(") for kind, name in
                   (x for x in FRAME if x[0] in "()")]
        recs.append(r)
        host.append(("cudaLaunchKernel", "cuda_runtime", t, 1.0))  # marker
        t += 2.0
        for x in (FRAME if f < n else FRAME[:8]):
            if x[0] in "()":
                host.append(("cudaEventRecord", "cuda_runtime", t, 0.5))
            elif x[0] == "Y":
                host.append(("cudaStreamSynchronize", "cuda_runtime", t, 1.0))
            else:
                host.append((CALL[x[0]], "cuda_runtime", t, 0.5))
                if f < n:
                    device.append(("k", CAT[x[0]], t - 300.0, x[1]))
            t += 2.0
    host = host[1 + drop_head:len(host) - drop_tail]
    return recs, {"frames": n, "span": (-300.0, t), "device": device,
                  "host": host, "walks": [], "markers": n + 1}


class Fake:
    def __init__(self, recs, phases):
        self.recs, self.ph = recs, phases

    def records(self):
        return list(self.recs)

    def phases(self):
        return dict(self.ph)


@pytest.fixture
def canned(monkeypatch):
    """A warm-up frame, then a window: two untraced frames, three traced
    ones (a stretch of two and its padding frame; their waits and bounces
    are far off, to show they are not read), one untraced."""
    traced, stretch = traced_stretch()
    for r in traced:
        r.waits, r.wait_ns, r.host_ns = 500, int(400e6), int(900e6)
        r.bounces = [(0, 100, 1)]
    recs = ([frame(1, 99, 900.0, 5000.0, [(0, 8, 8)]),  # set-up's warm-up
             frame(2, 30, 40.0, 160.0, [(0, 100, 100), (1, 100, 50)]),
             frame(3, 32, 50.0, 170.0, [(0, 100, 100), (1, 100, 30)])]
            + traced
            + [frame(7, 31, 45.0, 180.0, [(0, 100, 100), (1, 100, 20),
                                          (2, 100, 10)])])
    fake = Fake(recs, {"kernel_load": 0.5, "scene_pack": 1.25,
                       "scene_pack.build": 1.0, "dither_tile": 2.0})
    monkeypatch.setattr(pt, "tracer", lambda: fake)
    # these frames are 11 launches long: a shift by a frame must not fit
    monkeypatch.setattr(pt, "MAX_SHIFT", 4)
    return {"frames": 6, "trace": stretch}, fake


def test_counters_average_the_untraced_window_frames(canned):
    rec, _ = canned
    for kind in ("final", "preview"):
        assert reader(f"host_syncs_per_frame.{kind}").read(rec) == \
            pytest.approx(31.0)
        assert reader(f"sync_wait_ms.{kind}").read(rec) == pytest.approx(45.0)
        assert reader(f"host_issue_ms.{kind}").read(rec) == pytest.approx(
            ((160 - 40) + (170 - 50) + (180 - 45)) / 3)
    assert reader("live_lane_pct.final").read(rec) == pytest.approx(
        100.0 * (150 + 130 + 130) / (200 + 200 + 300))


def test_span_times_are_the_work_launched_inside(canned):
    """Each device event falls to the innermost span open at its launch
    call; the marker kernels and the padding frame are not the frames'."""
    rec, _ = canned
    assert reader("intersect_device_ms.final").read(rec) == \
        pytest.approx((4 + 6) * 1e-3)
    assert reader("nee_device_ms.final").read(rec) == \
        pytest.approx((7 + 1) * 1e-3)
    # the bounce's own work: the kernel after the live count, and the tail
    assert reader("shade_device_ms.final").read(rec) == \
        pytest.approx((3 + 5) * 1e-3)
    assert reader("film_device_ms.final").read(rec) == pytest.approx(8e-3)
    traced = [r for r in pt._window(rec) if r.spans_on]
    incl, own = pt.span_device_ms(rec["trace"], traced)
    assert incl["pt.bounce"] == pytest.approx(26.5e-3)
    assert incl["pt.camera"] == pytest.approx(1.5e-3)
    assert incl["pt.frame"] == pytest.approx(36.25e-3)
    assert own.get("pt.frame", 0.0) == 0.0  # children cover the frame
    assert sum(own.values()) == pytest.approx(36.25e-3)


def test_span_times_need_marks_and_events_to_align(canned):
    rec, _ = canned
    recs, st = traced_stretch()
    want = pt.span_device_ms(st, recs)
    assert want is not None
    # a launch call lost inside a frame: no shift aligns the kinds
    lost = dict(st, host=st["host"][:20] + st["host"][21:])
    assert st["host"][20][0] == "cudaLaunchKernel"
    assert pt.span_device_ms(lost, recs) is None
    # marks the records do not hold
    assert pt.span_device_ms(st, recs[:1]) is None
    # no marks (a program without them) or a lost stretch
    bare = dict(st, host=[h for h in st["host"]
                          if h[0] != "cudaEventRecord"])
    assert pt.span_device_ms(bare, recs) is None
    assert pt.span_device_ms(dict(st, span=None), recs) is None
    assert reader("nee_device_ms.final").read({"frames": 6}) is None
    assert pt.align("KCKKS", "KCKKS") == 0
    assert pt.align("KKCKKSK", "CKKS") == 2
    assert pt.align("CKKS", "KCKKSK") == -1
    assert pt.align("KKKK", "KK") is None  # several shifts fit


def test_span_times_when_the_host_list_lacks_its_ends(canned):
    """The host list can lack calls at either end of the stretch (the
    clocks differ); an event whose launch call is missing goes to the
    spans of the nearest paired call."""
    recs, st = traced_stretch()
    want, want_own = pt.span_device_ms(st, recs)
    # the last frame's calls from its stats readback on, and the padding
    # frame's, fell after the end
    tail = dict(st, host=st["host"][:-(5 + 1 + 8)])
    assert tail["host"][-1][0] == "cudaEventRecord"  # the pass's end
    incl, own = pt.span_device_ms(tail, recs)
    assert incl["pt.frame"] == pytest.approx(want["pt.frame"])
    assert incl["pt.film"] == pytest.approx(want["pt.film"] + 0.25e-3 / 2)
    # the first frame's camera copy fell before the start
    head = dict(st, host=st["host"][3:])
    incl, own = pt.span_device_ms(head, recs)
    assert incl == pytest.approx(want) and own == pytest.approx(want_own)


def test_phases(canned):
    rec, _ = canned
    assert reader("kernel_load_s").read(rec) == 0.5
    assert reader("scene_pack_s").read(rec) == 1.25
    assert reader("dither_tile_s").read(rec) == 2.0


def test_traced_and_untraced_frames_are_kept_apart(canned):
    rec, fake = canned
    assert [r.seq for r in pt.untraced(rec)] == [2, 3, 7]
    # only traced frames: no counter, span times unchanged
    fake.recs = [r for r in fake.recs if r.spans_on]
    rec = dict(rec, frames=3)
    assert reader("host_syncs_per_frame.final").read(rec) is None
    assert reader("sync_wait_ms.preview").read(rec) is None
    assert reader("live_lane_pct.final").read(rec) is None
    assert reader("nee_device_ms.final").read(rec) == pytest.approx(8e-3)


def test_none_without_records(monkeypatch):
    monkeypatch.setattr(pt, "tracer", lambda: Fake([], {}))
    for name in NEW:
        assert reader(name).read({"frames": 10}) is None, name


def test_none_from_a_program_without_the_tracer(monkeypatch):
    """An older checkout of the program has no tracer: no reader raises."""
    monkeypatch.setattr(pt, "tracer", lambda: None)
    for name in NEW:
        assert reader(name).read({"frames": 10}) is None, name


def test_the_program_has_the_tracer():
    assert pt.tracer() is trace
    assert set(NEW) <= {m["name"] for m in cells.spec()["per_layer"]}


def _by_correlation(xs, lo, hi):
    """(inclusive, own) device ms of each ``pt.`` span for the device
    events in [lo, hi) of the profiler's events ``xs``, each tied to its
    launch call by the profiler's correlation id: what the launch order has
    to give."""
    from benchmark.harness.trace import DEVICE_CATS, MARKER
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
             if e["name"].startswith("pt.")
             and e.get("cat") in ("cpu_op", "user_annotation")]
    launched = {e["args"]["correlation"]: e["ts"] for e in xs
                if e.get("cat") in pt.LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    incl, own = {}, {}
    for e in xs:
        if e.get("cat") not in DEVICE_CATS or MARKER in e["name"] \
                or not lo <= e["ts"] < hi:
            continue
        at = launched[e["args"]["correlation"]]
        inside = sorted((s for s in spans if s[0] <= at < s[1]),
                        key=lambda s: (s[0], -s[1]))
        for name in {s[2] for s in inside}:
            incl[name] = incl.get(name, 0.0) + e["dur"] * 1e-3
        if inside:
            own[inside[-1][2]] = own.get(inside[-1][2], 0.0) \
                + e["dur"] * 1e-3
    return incl, own


@pytest.mark.gpu
def test_launch_order_pairs_as_the_correlation_ids_do(card):
    """On the card: a stretch of one 1080p bench frame and its display,
    read by the order of its calls and marks, gives every span the device
    time that the profiler's correlation ids give it, to 1% of the
    frame's."""
    import torch

    from benchmark.harness import trace as htr
    from buas_pathtracer_tpu_torch.models.scenes import build_bench_scene
    from buas_pathtracer_tpu_torch.runtime.progressive import \
        ProgressiveRenderer
    r = ProgressiveRenderer(build_bench_scene(1920, 1080), 1920, 1080,
                            device="cuda")

    def frame():
        r.render_one_frame()
        r.display_rgba8()

    frame()
    torch.cuda.synchronize()
    prof, calls = htr.profiled(frame, 1, host=True)
    # the profile can be exported once: read() gets a copy of the file
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            xs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        prof.export_chrome_trace = lambda to: shutil.copy(path, to)
        stretch = htr.read(prof, calls, 1)
    finally:
        os.remove(path)
    assert stretch["span"] is not None
    got = pt.span_device_ms(stretch, [
        r for r in trace.records()[-2:] if r.spans_on])
    assert got is not None
    want = _by_correlation(xs, *stretch["span"])
    # exact but for the few events at the stretch's ends whose launch
    # calls fell outside its host list
    frame_ms = want[0]["pt.frame"]
    for mine, truth in zip(got, want):
        for name in set(mine) | set(truth):
            assert abs(mine.get(name, 0.0) - truth.get(name, 0.0)) \
                <= 0.01 * frame_ms, name
    assert got[0]["pt.frame"] > 0 and got[0]["pt.display"] > 0
