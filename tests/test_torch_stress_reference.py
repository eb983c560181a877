"""The stress scene's shape through the port's main path on the CPU, held
to the benchmark's plain reference (``benchmark/reference``).

The benchmark's ``stress`` configuration (``benchmark/configs/stress.py``)
with its icospheres subdivided twice (2 x 320 triangles) at 48 x 27: the
same materials, layout, camera, filter and 6-bounce Advanced Pathtracer.
The residence limit is lowered so that ``ProgressiveRenderer`` packs the
split tables by itself and every wave takes ``split_traverse`` (its plain
version here).  Two one-sample passes from a large first sample index,
read back as RGBA8, against the reference's tiles of the same passes,
compared as the benchmark's check compares them (``harness/check.numbers``)
and held to the ``stress.final-1080p`` cell's limits.  Readings when this
test was written: px_off 0.0, lsb_mean 0.0 (the port and the reference do
the same float32 arithmetic); the reference in bfloat16, the benchmark's
control, reads 0.56640625 / 13.33 on the same tiles."""

import json
import os

import numpy as np
import torch

from benchmark.configs import stress
from benchmark.harness import check, port_scene
from benchmark.reference.render import render_tiles
from buas_pathtracer_tpu_torch.ops import packet
from buas_pathtracer_tpu_torch.runtime import film
from buas_pathtracer_tpu_torch.runtime.progressive import ProgressiveRenderer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 48, 27
PASSES = 2
FIRST = 2147483701 & 0xFFFFFFFF
TILE = 16
# 16 x 16 tiles that cover the 48 x 27 frame
ORIGINS = [(y, x) for y in (0, H - TILE) for x in (0, 16, 32)]


def test_split_render_matches_the_reference(monkeypatch):
    data = stress.scene(W, H, subdivisions=2)
    monkeypatch.setattr(packet, "RESIDENT_TABLE_LIMIT_BYTES", 0)
    calls = {"split": 0, "wide": 0}
    split, wide = packet.split_traverse, packet.wide_traverse

    def count_split(*a, **k):
        calls["split"] += 1
        return split(*a, **k)

    def count_wide(*a, **k):
        calls["wide"] += 1
        return wide(*a, **k)

    monkeypatch.setattr(packet, "split_traverse", count_split)
    monkeypatch.setattr(packet, "wide_traverse", count_wide)
    r = ProgressiveRenderer(port_scene.build(data), W, H, device="cpu")
    assert r.ps.v4_res is not None and r.ps.v4_leaf is not None
    r.accum = film.new_accumulation_buffer(H, W, r.device)
    r.frame_count = FIRST
    for _ in range(PASSES):
        r.render_one_frame()
    img = r.display_rgba8()
    assert calls["split"] > 0 and calls["wide"] == 0

    ys = np.array([[[y0 + i] * TILE for i in range(TILE)]
                   for y0, _ in ORIGINS])
    xs = np.array([[list(range(x0, x0 + TILE))] * TILE for _, x0 in ORIGINS])
    ref = render_tiles(data, W, H, ORIGINS, TILE, FIRST, PASSES,
                       torch.device("cpu"))
    vals = check.numbers(img[ys, xs], ref)
    with open(os.path.join(ROOT, "benchmark", "limits",
                           "stress.final-1080p.json")) as f:
        limits = json.load(f)
    for k in check.NUMBERS:
        assert vals[k] <= limits[k]["limit"], (k, vals)
    # the tiles are a lit picture, not an empty one
    assert img[..., :3].max() > 0 and ref[..., :3].max() > 0
