"""One run of a one-chip cell: set-up, the measured window, the check.

Set-up (``setup_s``, from the process's start): import the program, build
the configuration's scene and hand it to ``ProgressiveRenderer``, which
packs it (``pack_s``), then one warm-up frame and one readback at the
mix's size, which load the kernels and make the post pass's dither tile.
The accumulation then starts over at the sample index the seed sets.

The window drives the renderer as its users do, in a closed loop: frame
after frame of ``render_one_frame``, and every ``readback_every`` frames
``display_rgba8``, the RGBA8 image on the host.  A frame's time runs from
its start to its image on the host (or, without a readback, to the end of
``render_one_frame``, which waits for the frame's stats).  The window ends
with the first frame that ends ``seconds`` or more after it began; its
length is that frame's end.

With ``trace``, ``TRACE_FRAMES`` whole frames right after a readback run
under the profiler recording the device, then ``LABEL_FRAMES`` recording
the host too (``harness/trace.py``); the per-layer readers take their
numbers from the first record and from the window's own clocks.
"""

from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np
import torch

from . import check, port_scene
from . import trace as tr

# frames of the traced stretch, and of the second one, which also records
# the host (the profiler was seen to drop events of longer stretches: a
# host-recorded stretch of two Week 7 frames and its padding frame was lost
# three times running)
TRACE_FRAMES = 4
LABEL_FRAMES = 1


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=None) -> Dict:
    """The run's record: set-up, window and traced numbers, and the
    check's verdict."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    from buas_pathtracer_tpu_torch.runtime import film
    from buas_pathtracer_tpu_torch.runtime.progressive import \
        ProgressiveRenderer

    mix = cell.mix
    if int(mix["ranks"]) != 1:
        raise ValueError(f"{cell.mix_name}: {mix['ranks']} ranks; this "
                         "harness runs one")
    w, h = int(mix["width"]), int(mix["height"])
    every = int(mix["readback_every"])
    dev = torch.device(device)

    t0 = time.perf_counter()
    data = cell.config.describe(w, h)
    data.settings = dict(data.settings, samples_per_pixel=int(mix["spp"]))
    r = ProgressiveRenderer(port_scene.build(data), w, h, device=dev)
    _sync(dev)
    pack_s = time.perf_counter() - t0

    r.render_one_frame()
    r.display_rgba8()
    _sync(dev)
    first_index = seed & 0xFFFFFFFF
    r.accum = film.new_accumulation_buffer(h, w, dev)
    r.frame_count = first_index
    plan = check.draw(seed, w, h)
    power = tr.power_limit_w() if (trace and dev.type == "cuda") else None
    _sync(dev)

    frame_s, display_s, grabbed = [], [], []
    traced = labelled = None
    trace_frames = TRACE_FRAMES if trace else 0
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    frames = 0

    def frame():
        nonlocal frames
        f0 = time.perf_counter()
        r.render_one_frame()
        frames += 1
        if frames % every == 0:
            d0 = time.perf_counter()
            img = r.display_rgba8()
            display_s.append(time.perf_counter() - d0)
            frame_s.append(time.perf_counter() - f0)
            grabbed.append(check.grab(plan, img))
        else:
            frame_s.append(time.perf_counter() - f0)

    while True:
        if (trace_frames and traced is None and frames % every == 0
                and time.perf_counter() - w0 >= 0.3 * seconds):
            traced = tr.stretch(frame, trace_frames, host=False)
            labelled = tr.stretch(frame, LABEL_FRAMES, host=True)
            log(f"trace: {trace_frames} frames, markers {traced['markers']}, "
                f"complete {traced['span'] is not None}; host-labelled "
                f"{LABEL_FRAMES} frames complete "
                f"{labelled['span'] is not None}")
        else:
            frame()
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
    log(f"window: {frames} frames of {w}x{h} in {window_s:.3f} s "
        f"(median {1e3 * float(np.median(frame_s)):.2f} ms, p95 "
        f"{1e3 * float(np.percentile(frame_s, 95)):.2f} ms), "
        f"{len(grabbed)} readbacks; set-up {setup_s:.3f} s (pack "
        f"{pack_s:.3f} s)")

    del r
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    verdict = check.compare(data, w, h, plan, grabbed, first_index,
                            every * int(mix["spp"]), dev, cell.limits)
    log(f"check: readback {verdict.get('readback')} of {len(grabbed)} "
        f"({verdict.get('passes')} passes), {verdict.get('pixels')} pixels "
        f"in {verdict.get('tiles')} tiles, reference "
        f"{time.perf_counter() - c0:.3f} s")
    return dict(setup_s=setup_s, pack_s=pack_s, window_s=window_s,
                frames=frames, passes=frames * int(mix["spp"]),
                pixels_per_pass=w * h, image_hw=(h, w), frame_s=frame_s,
                display_s=display_s,
                trace=traced, labelled=labelled, power_limit_w=power,
                memory_peak_bytes=int(mem_peak), verdict=verdict)
