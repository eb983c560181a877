"""What decides ``correct``: the images the window read back, held to the
plain reference.

Before the window the seed draws ``MAX_TILES`` square tiles of the frame
and a fraction ``u``.  At every readback the harness keeps those tiles'
pixels of the RGBA8 image on the host.  Once the window has closed, the
readback ``floor(u * readbacks)`` is judged: the drawn tiles are put in
order, first those that hold the scene (at least ``GEOMETRY_SHARE`` of
their pixels' primary rays hit it in the reference), then those that see
mostly sky, each group in the order drawn; the reference renders the first
of them from the configuration's data as that many passes from the same
first sample index leave them (``reference/render.py``), as many tiles as
``CHECK_RAYS`` samples allow (at least one), and the two RGBA8 tiles are
compared pixel by pixel.  The order matters because at late readbacks only
one to three tiles are judged, and on a tile of sky (the gradient or the
environment map) any program that gets the sky right reads 0 / 0, however
wrong its geometry.  The comparison covers every layer of the timed path:
the walks (hits), the integrator, the film splat with the cell's filter,
the accumulation and the post kernel.

Two numbers are compared, each with the limit in
``benchmark/limits/<cell>.json``:
  px_off   share of checked pixels with a channel more than 1 LSB off (the
           post kernel may round a channel differently by 1 LSB);
  lsb_mean mean absolute channel difference, in LSB.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import film as ref_film
from benchmark.reference import scene as ref_scene
from benchmark.reference.render import geometry_share, render_tiles

NUMBERS = ("px_off", "lsb_mean")
TILE = 16  # pixels a tile side
MAX_TILES = 64  # tiles drawn a run; the readback's first ones are judged
# samples the reference traces a check at most (at least one tile's):
# some seconds on the card, well inside the window
CHECK_RAYS = 1 << 18
# a tile holds the scene when this share of its primary rays hits it
GEOMETRY_SHARE = 0.5


@dataclass
class Plan:
    origins: List
    ys: np.ndarray  # (tiles, size, size) frame rows of every tile pixel
    xs: np.ndarray
    size: int
    u: float


def draw(seed: int, w: int, h: int) -> Plan:
    size, max_tiles = TILE, MAX_TILES
    g = np.random.default_rng([seed & 0xFFFFFFFFFFFF, 0xC4EC])
    oy = g.integers(0, h - size + 1, max_tiles)
    ox = g.integers(0, w - size + 1, max_tiles)
    u = float(g.random())
    ar = np.arange(size)
    ys = oy[:, None, None] + ar[None, :, None] + 0 * ar[None, None, :]
    xs = ox[:, None, None] + ar[None, None, :] + 0 * ar[None, :, None]
    return Plan([(int(a), int(b)) for a, b in zip(oy, ox)], ys, xs, size, u)


def geometry_first(rs, w: int, h: int, plan: Plan, device):
    """(plan, order): the plan's tiles that hold the scene first, then the
    rest, each group in the order drawn; ``order`` indexes the drawn
    tiles (and so the tiles ``grab`` kept).  ``rs`` is the reference's
    scene (``reference/scene.build``), built once a check."""
    share = geometry_share(rs, w, h, plan.origins, plan.size, device)
    order = np.argsort(share < GEOMETRY_SHARE, kind="stable")
    return Plan([plan.origins[i] for i in order], plan.ys[order],
                plan.xs[order], plan.size, plan.u), order


def grab(plan: Plan, img: np.ndarray) -> np.ndarray:
    """The plan's tiles of one (H, W, 4) uint8 image."""
    return img[plan.ys, plan.xs]


def numbers(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    d = np.abs(prog.astype(np.int32) - ref.astype(np.int32))
    return {"px_off": float((d.max(axis=-1) > 1).mean()),
            "lsb_mean": float(d.mean())}


def judged(plan: Plan, readbacks: int, every: int, radius: int):
    """(readback index, passes it holds, tiles the reference renders);
    ``every`` one-sample passes between readbacks."""
    j = min(int(plan.u * readbacks), readbacks - 1)
    passes = (j + 1) * every
    side = plan.size + 2 * radius
    tiles = int(np.clip(CHECK_RAYS // (passes * side * side), 1,
                        len(plan.origins)))
    return j, passes, tiles


def reference_tiles(rs, w: int, h: int, plan: Plan, first_index: int,
                    passes: int, tiles: int, device,
                    dtype=torch.float32) -> np.ndarray:
    return render_tiles(rs, w, h, plan.origins[:tiles], plan.size,
                        first_index, passes, device, dtype)


def compare(data, w: int, h: int, plan: Plan, grabbed: List[np.ndarray],
            first_index: int, every: int, device, limits: Dict) -> Dict:
    """The judged readback against the reference: {numbers, limits,
    correct, and what was judged}."""
    if not grabbed:
        return dict(correct=False, why="no image was read back",
                    values={}, limits={})
    _, radius = ref_film.find_filter(data.filter_name)
    j, passes, tiles = judged(plan, len(grabbed), every, radius)
    rs = ref_scene.build(data, device)
    plan, order = geometry_first(rs, w, h, plan, device)
    ref = reference_tiles(rs, w, h, plan, first_index, passes, tiles, device)
    vals = numbers(grabbed[j][order[:tiles]], ref)
    lim = {k: float(limits[k]["limit"]) for k in NUMBERS}
    return dict(correct=all(vals[k] <= lim[k] for k in NUMBERS),
                values=vals, limits=lim, readback=j, passes=passes,
                tiles=tiles, pixels=tiles * plan.size * plan.size)
