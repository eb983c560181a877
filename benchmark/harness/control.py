"""The control that the check has to fail: the reference in the program's
place, its ray-primitive arithmetic in bfloat16 (the precision below the
float32 the renderer states), judged against the float32 reference as a
run judges the program.

    python3 benchmark/harness/control.py --workload <cell> --readbacks <n> \
        --seeds <s> [<s> ...]

For each seed: the tiles and the judged readback as a run with ``n``
readbacks would draw them, and the compared numbers, one JSON line a seed.
The benchmark's own runs never run it; its readings set the upper end of
each limit (``benchmark/limits/<cell>.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def readings(cell, seed: int, readbacks: int, device,
             dtype=torch.bfloat16) -> dict:
    """The control's compared numbers for one seed."""
    from benchmark.harness import check
    from benchmark.reference import film, scene

    mix = cell.mix
    w, h = int(mix["width"]), int(mix["height"])
    data = cell.config.describe(w, h)
    plan = check.draw(seed, w, h)
    _, radius = film.find_filter(data.filter_name)
    every = int(mix["readback_every"]) * int(mix["spp"])
    _, passes, tiles = check.judged(plan, readbacks, every, radius)
    rs = scene.build(data, device)
    plan, _ = check.geometry_first(rs, w, h, plan, device)
    first = seed & 0xFFFFFFFF
    ref = check.reference_tiles(rs, w, h, plan, first, passes, tiles, device)
    low = check.reference_tiles(rs, w, h, plan, first, passes, tiles, device,
                                dtype)
    return dict(seed=seed, passes=passes, tiles=tiles,
                **check.numbers(low, ref))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--readbacks", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import cells

    if not torch.cuda.is_available():
        print("the control is read on a CUDA card", file=sys.stderr)
        return 2
    cell = cells.resolve(args.workload)
    for s in args.seeds:
        print(json.dumps(dict(workload=cell.name, **readings(
            cell, s, args.readbacks, "cuda:0"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
