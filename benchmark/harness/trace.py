"""The traced stretch of a ``--trace 1`` run: a few whole frames under
``torch.profiler``, read back from its timeline.

The metrics' stretch records the device alone: recording the host's
events too adds some microseconds to each of a frame's ~9,300 launches and
so inflates the idle share of a host-bound frame.  A marker kernel before
each frame delimits the frames on the device's timeline; one more frame
pads the stretch's end, since the profiler was seen to drop events there
(markers and whole frames).  A stretch whose markers or walk kernels do
not all show is recorded again.  While it runs, the harness records every
call of the port's walks (``ops/packet.wide_traverse`` and
``split_traverse``): its rays, its live rays (t0 >= 0, counted once the
stretch is over) and its table's bytes.  A second, short stretch records
the host too, and only labels the breakdown's idle gaps with what the
host was doing.  ``read`` turns the profiler's Chrome trace into the
record the per-layer readers take.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import tempfile
from typing import Dict, List

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
FRAME = "bench.frame"
# frames are delimited on the device's timeline by a tiny spin kernel
# (``torch.cuda._sleep``) before each
MARKER = "spin_kernel"
MARKER_CYCLES = 100
# the port's own CUDA kernels, by their names
OWN_KERNELS = ("wide_traverse", "split_traverse", "tristream", "post_rgba8")
WALK_KERNELS = ("wide_traverse", "split_traverse")


@contextlib.contextmanager
def walk_calls(calls: List[Dict]):
    """Record each walk call into ``calls`` while the block runs."""
    from buas_pathtracer_tpu_torch.ops import packet

    wide, split = packet.wide_traverse, packet.split_traverse

    def rec_wide(rows, depth, o, d, t0, ign, occlusion, *a, **k):
        calls.append(dict(kernel="wide_traverse", rays=int(t0.shape[0]),
                          t0=t0, table_bytes=rows.numel() * 4))
        return wide(rows, depth, o, d, t0, ign, occlusion, *a, **k)

    def rec_split(res, leaf, depth, o, d, t0, ign, occlusion, *a, **k):
        # the resident rows only: which leaf rows a walk reads depends on
        # the rays, so they are not counted (a lower bound on the bytes)
        calls.append(dict(kernel="split_traverse", rays=int(t0.shape[0]),
                          t0=t0, table_bytes=res.numel() * 4))
        return split(res, leaf, depth, o, d, t0, ign, occlusion, *a, **k)

    packet.wide_traverse, packet.split_traverse = rec_wide, rec_split
    try:
        yield calls
    finally:
        packet.wide_traverse, packet.split_traverse = wide, split


def own_kernel(name: str, kinds=OWN_KERNELS) -> bool:
    """Is the device event one of the port's own CUDA kernels (its name
    carries a namespace, so the match is by the kernel's own name)?"""
    return any(k in name for k in kinds)


def profiled(frame, n: int, host: bool):
    """Run ``frame()`` ``n + 1`` times under the profiler, a marker kernel
    before each; the last frame only pads the stretch's end, which the
    profiler was seen to drop.  ``host`` also records the host's events,
    which slows a host-bound frame.  Returns (profiler, the walk calls of
    the first ``n`` frames)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    calls: List[Dict] = []
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with walk_calls(calls):
            for i in range(n + 1):
                if i == n:
                    measured = len(calls)
                torch.cuda._sleep(MARKER_CYCLES)
                with record_function(FRAME):
                    frame()
        torch.cuda.synchronize()
    calls = calls[:measured]
    for c in calls:
        c["live"] = int((c.pop("t0") >= 0.0).sum())
    return prof, calls


def read(prof, calls: List[Dict], n: int) -> Dict:
    """The traced record of ``n`` frames: their span [lo, hi) in us on the
    profiler's timeline, from the marker before the first frame to the
    marker before the padding frame; the device's events (the markers left
    out) and the host's events [(name, cat, ts us, dur us)] inside it; the
    walk calls.  The span is None unless the markers were recorded and the
    span holds one walk kernel for each walk call."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    xs = [(e["name"], e.get("cat"), float(e["ts"]), float(e.get("dur", 0)))
          for e in events if e.get("ph") == "X"]
    marks = sorted(ts for name, cat, ts, _ in xs
                   if cat == "kernel" and MARKER in name)
    empty = dict(frames=n, span=None, device=[], host=[], walks=calls,
                 markers=len(marks))
    if len(marks) < n + 1:
        return empty
    lo, hi = marks[0], marks[n]
    device = sorted(x for x in xs if x[1] in DEVICE_CATS
                    and MARKER not in x[0] and lo <= x[2] < hi)
    walks = sum(1 for name, cat, _, _ in device
                if cat == "kernel" and own_kernel(name, WALK_KERNELS))
    if walks != len(calls):
        return empty
    return dict(frames=n, span=(lo, hi), device=device,
                host=sorted(x for x in xs if x[1] in HOST_CATS
                            and lo <= x[2] < hi),
                walks=calls, markers=len(marks))


def stretch(frame, n: int, host: bool, tries: int = 3) -> Dict:
    """A complete traced record of ``n`` frames, trying again when the
    profiler lost part of the stretch (the record's span is then None)."""
    for _ in range(tries):
        rec = read(*profiled(frame, n, host), n)
        if rec["span"] is not None:
            break
    return rec


def power_limit_w():
    """The card's power limit (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
