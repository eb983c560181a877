"""What the program records about itself, for the per-layer metrics that
read it: the frame records and set-up phases of the port's tracer
(``buas_pathtracer_tpu_torch/utils/trace.py``), in the run's own process,
and the tracer's ``pt.`` spans on the profiler's timeline.

A frame record covers one ``render_one_frame`` and the ``display_rgba8``
after it; the window's frames are the last ``rec["frames"]`` records the
tracer kept (it keeps 256), the set-up's warm-up frame before them.
Counters are read from the window's frames that ran with spans off (the
untraced ones).  A program without the tracer gives nothing to read: every
function here then returns None.

A span's device time is that of the kernels, copies and sets launched
inside it, in the traced stretch (``harness/trace.py``: the frames that
record the device).  The profiler records there each launch call and each
host wait (``cudaStreamSynchronize``) as well as the device's events, and
while spans are on the tracer marks both ends of each span with a
``cudaEventRecord`` call and keeps the marks, in order, in the frame's
record.  So the calls on the host's timeline hold the spans' ends in order:
the stretch's marks and waits are found, by their order, among those the
traced records expect (a wait span holds one wait), which names each mark;
and on the one stream the frame uses, the device runs its work in the
order the host launched it, so the launch calls and the device events are
one sequence, aligned by the kinds of their items (kernel, copy, set).  The
device's and the host's clocks differ (by up to ~0.7 ms, seen on an H100),
so the stretch's host list can lack a few calls at either end, or hold the
next frame's first ones: only order is read, an event whose launch call
fell outside the list goes to the spans of the nearest paired call, and
the stretch is read only when both alignments are unique.  Launch calls
outside every span are the harness's marker kernels, which the stretch's
device events leave out.  A span's time
is then the device's busy time for its work, whatever the host's pace.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

# host calls that put one event on the device's timeline each, and the
# kind of that event
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                "cuMemcpy", "cuMemset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
KINDS = {"kernel": "K", "gpu_memcpy": "C", "gpu_memset": "S"}
MARK_CALL = "cudaEventRecord"  # an end of a span
WAIT_CALL = "cudaStreamSynchronize"  # a wait's block
# the most launch calls the host list may lack or add at its ends
MAX_SHIFT = 512


def tracer():
    """The program's tracer module, or None when the program has none."""
    try:
        from buas_pathtracer_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def _window(rec) -> Optional[List]:
    tr = tracer()
    if tr is None:
        return None
    frames = int(rec.get("frames") or 0)
    return tr.records()[-frames:] if frames else []


def untraced(rec) -> Optional[List]:
    """The window's frame records that ran with spans off, or None."""
    recs = _window(rec)
    return None if recs is None else [r for r in recs if not r.spans_on]


def mean(values: Optional[Iterable[float]]) -> Optional[float]:
    """The mean, or None for no values."""
    vals = list(values) if values is not None else []
    return sum(vals) / len(vals) if vals else None


def align(calls: str, events: str) -> Optional[int]:
    """The one shift d for which event i is launch call i + d for every i
    that both hold, by their kinds, over most of the events; None if no
    shift or several do."""
    found = []
    for d in range(-MAX_SHIFT, MAX_SHIFT + 1):
        i0, i1 = max(0, -d), min(len(events), len(calls) - d)
        if i1 - i0 >= max(len(events) // 2 + 1, len(events) - MAX_SHIFT) \
                and calls[i0 + d:i1 + d] == events[i0:i1]:
            found.append(d)
    return found[0] if len(found) == 1 else None


def _expected(records) -> Tuple[str, List]:
    """The marks (``E``) and waits (``Y``) the records' spans make, in
    order, and each mark's (name, entry?) (None for a wait)."""
    syms, marks = [], []
    for r in records:
        for name, entry in getattr(r, "marks", ()):
            if not entry and name.startswith("pt.wait."):
                syms.append("Y")
                marks.append(None)
            syms.append("E")
            marks.append((name, entry))
    return "".join(syms), marks


def span_device_ms(stretch, records) -> Optional[
        Tuple[Dict[str, float], Dict[str, float]]]:
    """(device ms a frame of the work launched inside each ``pt.`` span,
    the same less its child spans' work) over a traced stretch's frames,
    given the frame records that ran with spans on; None when the stretch
    holds no marks or its calls do not align."""
    if not stretch or not stretch.get("span"):
        return None
    want, marks = _expected(records)
    calls: List[tuple] = []  # (start, end, symbol)
    for name, cat, ts, dur in sorted(stretch["host"], key=lambda e: e[2]):
        if cat not in LAUNCH_CATS:
            continue
        if name.startswith(LAUNCH_CALLS):
            # a driver call made inside a runtime call is the same launch
            if calls and ts < calls[-1][1]:
                continue
            sym = "C" if "Memcpy" in name else "S" if "Memset" in name \
                else "K"
        elif name.startswith(MARK_CALL):
            sym = "E"
        elif name.startswith(WAIT_CALL):
            sym = "Y"
        else:
            continue
        calls.append((ts, ts + dur, sym))
    seen = "".join(c[2] for c in calls if c[2] in "EY")
    at = [i for i in range(len(want) - len(seen) + 1)
          if seen and want.startswith(seen, i)]
    if not at:
        return None
    # frames alike fit at several places: each must name the marks alike
    named = {tuple(marks[i:i + len(seen)]) for i in at}
    if len(named) != 1:
        return None
    # the spans open at each launch call, outermost first
    stack: List[str] = []
    for m in marks[:at[0]]:
        _apply(stack, m)
    names = iter(marks[at[0]:at[0] + len(seen)])
    launches, chains = [], []
    for c in calls:
        if c[2] in "EY":
            _apply(stack, next(names))
        elif stack:  # outside every span: the harness's marker kernel
            launches.append(c[2])
            chains.append(list(stack))
    work = sorted((ts, dur, KINDS[cat]) for _, cat, ts, dur
                  in stretch["device"])
    d = align("".join(launches), "".join(w[2] for w in work))
    if d is None:
        return None
    n = int(stretch["frames"])
    first, last = max(0, d), min(len(launches), len(work) + d) - 1
    incl: Dict[str, float] = {}
    own: Dict[str, float] = {}
    for k, (_, dur, _) in enumerate(work):
        chain = chains[min(max(k + d, first), last)]
        ms = dur * 1e-3 / n
        for name in set(chain):
            incl[name] = incl.get(name, 0.0) + ms
        if chain:
            own[chain[-1]] = own.get(chain[-1], 0.0) + ms
    return incl, own


def _apply(stack: List[str], mark) -> None:
    if mark is None:  # a wait
        return
    name, entry = mark
    if entry:
        stack.append(name)
    elif stack and stack[-1] == name:
        stack.pop()


def span_ms(rec, name: str, own: bool = False) -> Optional[float]:
    """Device ms a frame of the work launched inside the span ``name``
    (summed over its calls in the frame), or with ``own`` outside its child
    spans, in the traced stretch; None without one."""
    recs = _window(rec)
    if not recs:
        return None
    got = span_device_ms(rec.get("trace"), [r for r in recs if r.spans_on])
    if got is None:
        return None
    return got[1 if own else 0].get(name, 0.0)


def phase_s(name: str) -> Optional[float]:
    """Seconds of the set-up phase ``name``, or None."""
    tr = tracer()
    return None if tr is None else tr.phases().get(name)
