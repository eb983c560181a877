"""The port's tracer: what a frame waits on, what it launches, how its
bounces narrow, which part of the renderer each stretch of the timeline
belongs to, and set-up's phases.

**Counters are always on.**  They are host integers and
``time.perf_counter_ns`` pairs, and never launch device work (``walks``,
kept only while spans are on, is the one exception).  A frame
record covers one ``ProgressiveRenderer.render_one_frame`` and the
``display_rgba8`` calls after it, up to the next frame (``frame`` and
``display`` open them).  It counts what happens while a frame or display
call runs, and nothing in between:

* ``waits`` / ``wait_ns`` / ``sites``: each place the host blocks on the
  card goes through ``wait(site, fn, *args)``, one wait a call: a readback
  (``.cpu()``, ``int()`` / ``bool()`` of a device tensor) or a copy of host
  values to the card (which synchronises the stream from pageable memory).
  The sites: ``camera`` (``camera_on``'s scalars), ``sampler_tables``,
  ``live_count``, ``live_any`` (the other integrators' loops), ``stats``,
  ``dither_tile`` and ``readback``.  They are counted on the CPU too, where
  they do not block: the count says what the card waits on.
* ``host_ns``: the host time inside ``render_one_frame`` and
  ``display_rgba8``; less ``wait_ns`` it is the host's issue time (Python,
  dispatch, launches).
* ``bounces``: (bounce, lanes it ran at, live lanes) for each bounce of the
  Advanced Pathtracer; the live count is read for the loop's own test.
* ``launches``: the port's own kernel launches, by kernel (``KERNELS``);
  ``launch_totals`` counts them over the process.
* ``walks``, while spans are on (the one counter that fills device
  memory): for each split walk (``ops/packet.py`` ``split_traverse``,
  K4/K5) its kernel key, its rays and the ``packet.WalkCounts`` that the
  walk, launched then as its counted kernel, fills: its live rays (t0 >=
  0), its leaf-row fetches (a lane fetching a row counts once) and a bitmap
  of the leaf rows it fetched.  They are read only by ``walk_counts``,
  after the frames, which gives each walk's ``live``, ``leaf_fetches`` and
  ``leaf_rows`` (the distinct leaf rows it touched).  Untraced frames
  launch the uncounted walks and keep no ``walks``.

The last ``RING`` records are kept (``records``), each with ``spans_on``.

**Spans are on exactly while a torch.profiler records**, checked when a
frame and a display begin, and off again when they return.  Off,
``span(name)`` returns ``NULL_SPAN``, one shared context that allocates
nothing and reads no clock.  On, a span is a profiler range (as
``torch.profiler.record_function(name)`` makes), so it lands on the
profiler's timeline beside the device's events; and each of its ends is a
mark: the record's ``marks`` gets (name, True on entry / False on exit),
and one CUDA event is recorded on the current stream, so the mark is a
``cudaEventRecord`` call among the launch calls on the profiler's
timeline, even when the profiler records the device alone.  A reader of
the profile walks the launch calls and marks in order and gives each span
the device time of the kernels launched inside it
(``benchmark/harness/program_trace.py``).  The tree (``pt.`` names)::

    pt.frame > pt.camera > pt.wait.camera            (camera_on)
             , pt.pass > pt.camera > pt.wait.sampler_tables
                                                     (sampler, rays)
                       , pt.bounce > pt.wait.live_count,
                                     pt.intersect > pt.walk,
                                     pt.nee > pt.walk
                       , pt.camera                   (vignette, untile)
                       , pt.film
             , pt.wait.stats
    pt.display > pt.wait.dither_tile, pt.post, pt.wait.readback

A wait is a ``pt.wait.<site>`` span of its own.  ``pt.bounce`` less its
child spans is the shading (on the card the ``shade_hit`` and
``shade_next`` kernels, one launch each a bounce).  ``pt.intersect`` is
the closest-hit query: the plane pass, its walk and the hit record (on the
card the ``hit_record`` kernel, one launch a query).  ``pt.walk`` is one walk
of the row BVH (``wide_traverse`` or ``split_traverse``) with the buffers it
fills (a counted split walk's ``WalkCounts`` among them); the other
integrators' and the viewer's queries make it too.

**Set-up phases** (``phase``, seconds summed over the process, ``phases``):
``kernel_load`` (the kernel library and the native host library, loaded or
built), ``scene_pack`` (all of ``Scene.pack``) with ``scene_pack.build``,
``scene_pack.split`` and ``scene_pack.upload`` (which also creates the
CUDA context when it is the first use of the card), and ``dither_tile``
(the post pass's blue-noise tile, made once a process).
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional

import torch

RING = 1024  # frame records kept
# record_function's C++ form: the same RecordFunction range on the
# profiler's timeline, at a tenth of record_function's host cost under a
# recording profiler (2 us against 18 us an enter and exit, timed on a CPU)
_RANGE = torch._C._profiler._RecordFunctionFast
# the port's own kernels, by launch counter
KERNELS = ("closest", "occlusion", "split_closest", "split_occlusion",
           "post_rgba8", "tristream_closest", "shade_hit", "shade_next",
           "hit_record")


class _Null:
    """The span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _Null()


class FrameRecord:
    """One frame's counters, and its spans' marks while spans were on."""

    __slots__ = ("seq", "spans_on", "host_ns", "waits", "wait_ns", "sites",
                 "bounces", "launches", "displays", "calls", "marks",
                 "walks")

    def __init__(self, seq: int):
        self.seq = seq
        self.spans_on = False
        self.host_ns = 0
        self.waits = 0
        self.wait_ns = 0
        self.sites: Dict[str, List[int]] = {}  # site -> [waits, ns]
        self.bounces: List[tuple] = []  # (bounce, lanes, live lanes)
        self.launches: Dict[str, int] = {}
        self.displays = 0
        self.calls = 0  # frame and display calls still running
        self.marks: List[tuple] = []  # (span name, entry?) in order
        self.walks: List[tuple] = []  # (key, rays, packet.WalkCounts)

    @property
    def host_issue_ns(self) -> int:
        return self.host_ns - self.wait_ns

    def walk_counts(self) -> List[Dict]:
        """The counted split walks, one dict a walk in launch order: kernel
        key, rays, live rays, leaf-row fetches and the distinct leaf rows it
        touched.  Reads the counters back, so only once the frame is
        over."""
        out = []
        for key, rays, counts in self.walks:
            live, fetches, rows = counts.read()
            out.append(dict(kernel=key, rays=rays, live=live,
                            leaf_fetches=fetches, leaf_rows=rows))
        return out


class _Span:
    """A span while spans are on: a profiler range, marked at both ends."""

    __slots__ = ("tracer", "name", "rf")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        self.rf = _RANGE(self.name)
        self.rf.__enter__()
        self.tracer._mark(self.name, True)

    def __exit__(self, *exc):
        self.tracer._mark(self.name, False)
        self.rf.__exit__(*exc)
        return False


class Tracer:
    """The process's counters, spans and phases (the module's functions
    are those of one instance)."""

    def __init__(self):
        self.ring: collections.deque = collections.deque(maxlen=RING)
        self.seq = 0
        self.cur = FrameRecord(0)  # before the first frame: not kept
        self.open = 0  # frame and display calls running
        self.on = False
        self.event = None  # the CUDA event each mark records, once made
        self.totals = dict.fromkeys(KERNELS, 0)
        self.phase_s: Dict[str, float] = {}

    # -- frames ---------------------------------------------------------------
    @contextlib.contextmanager
    def _call(self, new: bool, name: str):
        outer = self.on
        self.on = torch.autograd._profiler_enabled()
        if new:
            self.seq += 1
            self.cur = FrameRecord(self.seq)
            self.ring.append(self.cur)
        rec = self.cur
        rec.spans_on |= self.on
        rec.calls += 1
        self.open += 1
        t0 = time.perf_counter_ns()
        try:
            with self.span(name):
                yield rec
        finally:
            rec.host_ns += time.perf_counter_ns() - t0
            rec.calls -= 1
            self.open -= 1
            self.on = outer

    def frame(self):
        """Open a new frame record around one frame (``pt.frame``)."""
        return self._call(True, "pt.frame")

    def display(self):
        """Add one display to the current record (``pt.display``)."""
        self.cur.displays += 1
        return self._call(False, "pt.display")

    # -- counters -------------------------------------------------------------
    def wait(self, site: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, counted and timed as one wait of
        ``site`` while a frame or display runs; a ``pt.wait.<site>`` span
        while spans are on."""
        with (self.span("pt.wait." + site) if self.on else NULL_SPAN):
            t0 = time.perf_counter_ns()
            out = fn(*args, **kwargs)
            ns = time.perf_counter_ns() - t0
        if self.open:
            rec = self.cur
            rec.waits += 1
            rec.wait_ns += ns
            s = rec.sites.setdefault(site, [0, 0])
            s[0] += 1
            s[1] += ns
        return out

    def launch(self, kernel: str) -> None:
        self.totals[kernel] += 1
        if self.open:
            lc = self.cur.launches
            lc[kernel] = lc.get(kernel, 0) + 1

    def bounce(self, index: int, lanes: int, live: int) -> None:
        if self.open:
            self.cur.bounces.append((index, lanes, live))

    def counting_walks(self) -> bool:
        """Should a split walk launched now be counted (spans on, inside a
        frame or display)?"""
        return self.on and bool(self.open)

    def walk(self, key: str, rays: int, counts) -> None:
        """Keep a counted split walk's counters in the current record."""
        if self.open:
            self.cur.walks.append((key, int(rays), counts))

    # -- spans ----------------------------------------------------------------
    def span(self, name: str):
        """A marked profiler range named ``name`` while spans are on."""
        return _Span(self, name) if self.on else NULL_SPAN

    def _mark(self, name: str, entry: bool) -> None:
        self.cur.marks.append((name, entry))
        if torch.cuda.is_initialized():  # no card work before: no mark
            if self.event is None:
                self.event = torch.cuda.Event()
            self.event.record()

    # -- set-up ---------------------------------------------------------------
    @contextlib.contextmanager
    def phase(self, name: str):
        """Add the block's seconds to the set-up phase ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase_s[name] = (self.phase_s.get(name, 0.0)
                                  + time.perf_counter() - t0)

    # -- reading --------------------------------------------------------------
    def records(self) -> List[FrameRecord]:
        """The kept frame records, oldest first."""
        return list(self.ring)

    def last_displayed(self) -> Optional[FrameRecord]:
        """The newest record with a display whose calls have all
        returned: a whole frame and its display, as a viewer shows it."""
        for rec in reversed(list(self.ring)):  # frames may go on meanwhile
            if rec.displays and not rec.calls:
                return rec
        return None

    def phases(self) -> Dict[str, float]:
        return dict(self.phase_s)

    def launch_totals(self) -> Dict[str, int]:
        return dict(self.totals)


_TRACER = Tracer()
span = _TRACER.span
wait = _TRACER.wait
launch = _TRACER.launch
bounce = _TRACER.bounce
counting_walks = _TRACER.counting_walks
walk = _TRACER.walk
frame = _TRACER.frame
display = _TRACER.display
phase = _TRACER.phase
records = _TRACER.records
last_displayed = _TRACER.last_displayed
phases = _TRACER.phases
launch_totals = _TRACER.launch_totals
