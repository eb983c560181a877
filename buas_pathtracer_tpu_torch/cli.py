"""Command-line renderer of the port: the reference's "Take picture" path,
headless.

    python -m buas_pathtracer_tpu_torch.cli --list
    python -m buas_pathtracer_tpu_torch.cli --scene "Cornell Box" \
        --size 1024x576 --spp 16 --out out.png
    python -m buas_pathtracer_tpu_torch.cli --device cpu --size 64x36 --spp 1

Takes the options of the repository's ``render.py`` (:20-84): the scene,
integrator, filter and sampler pickers, spp and bounces.  It renders on the
CUDA card; ``--device cpu`` renders on the CPU instead.  Prints the
traversal stats of the last frame and the reference's completion line
("Took WxH spp image in N seconds", raytracer.cpp:2177-2179).  Rendering
over several devices is not ported: ``--devices`` above 1 is refused.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace

from .models.scenes import SCENES, load_scene
from .runtime.progressive import ProgressiveRenderer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="Nested Dielectrics")
    ap.add_argument("--size", default="1024x576")
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--bounces", type=int, default=None)
    ap.add_argument("--integrator", default=None,
                    help="Advanced Pathtracer | Whitted | Ground Truth "
                         "Iterative | Normals | Distances")
    ap.add_argument("--filter", dest="filter_name", default=None)
    ap.add_argument("--strategy", type=int, default=None,
                    help="0=uniform 1=blue-noise 2=stratified")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu for "
                         "tests)")
    ap.add_argument("--devices", type=int, default=0,
                    help="devices to render over (0 or 1: one)")
    args = ap.parse_args(argv)

    if args.list:
        for s in SCENES:
            print(s.name)
        return 0
    if args.devices > 1:
        print(f"--devices {args.devices}: rendering over several devices is "
              "not ported yet", file=sys.stderr)
        return 2

    w, h = (int(v) for v in args.size.split("x"))
    sc = load_scene(args.scene, w, h)
    if args.integrator:
        sc.settings = replace(sc.settings, integrator=args.integrator)
    if args.bounces is not None:
        sc.settings = replace(sc.settings, max_bounce_count=args.bounces)
    if args.strategy is not None:
        sc.settings = replace(sc.settings, sampling_strategy=args.strategy)
    if args.filter_name:
        sc.filter_name = args.filter_name

    def progress(done, total):
        print(f"\r{done}/{total} spp", end="", flush=True)

    pr = ProgressiveRenderer(sc, w, h, device=args.device)
    elapsed = pr.take_picture(args.spp, args.out, progress=progress)
    rays, nodes, tris = pr.last_stats
    print(f"\nlast frame: {rays:.0f} rays, {nodes:.0f} node visits, "
          f"{tris:.0f} tri tests")
    print(f"Took {w}x{h} {args.spp}spp image in {elapsed:.3f} seconds -> "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
