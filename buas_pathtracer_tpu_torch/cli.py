"""Command-line renderer of the port: the reference's "Take picture" path,
headless.

    python -m buas_pathtracer_tpu_torch.cli --list
    python -m buas_pathtracer_tpu_torch.cli --scene "Cornell Box" \
        --size 1024x576 --spp 16 --out out.png
    python -m buas_pathtracer_tpu_torch.cli --device cpu --size 64x36 --spp 1
    python -m buas_pathtracer_tpu_torch.cli --devices 2 --size 1920x1080

Takes the options of the repository's ``render.py`` (:20-84): the scene,
integrator, filter and sampler pickers, spp and bounces.  It renders on the
CUDA card; ``--device cpu`` renders on the CPU instead.  Prints the
traversal stats of the last frame and the reference's completion line
("Took WxH spp image in N seconds", raytracer.cpp:2177-2179).

``--devices N`` (N > 1) renders row-sharded over N ranks
(``parallel/mesh.py``), one process each: on the card rank i uses
``cuda:i`` over NCCL, and N above the number of cards is refused; with
``--device cpu`` the ranks run on the CPU over gloo.  The image is rank
0's gathered buffer.
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
                    help="ranks to render over, rows sharded, one card "
                         "each (0 or 1: one device)")
    args = ap.parse_args(argv)

    if args.list:
        for s in SCENES:
            print(s.name)
        return 0
    if args.devices > 1:
        import torch
        on_cpu = args.device is not None and \
            torch.device(args.device).type == "cpu"
        if not on_cpu and args.devices > torch.cuda.device_count():
            print(f"--devices {args.devices}: this machine has "
                  f"{torch.cuda.device_count()} CUDA card(s); one rank a "
                  "card", file=sys.stderr)
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

    if args.devices > 1:
        rays, nodes, tris, elapsed = _render_sharded(sc, w, h, args, on_cpu)
    else:
        pr = ProgressiveRenderer(sc, w, h, device=args.device)
        elapsed = pr.take_picture(args.spp, args.out, progress=progress)
        rays, nodes, tris = pr.last_stats
    print(f"\nlast frame: {rays:.0f} rays, {nodes:.0f} node visits, "
          f"{tris:.0f} tri tests")
    print(f"Took {w}x{h} {args.spp}spp image in {elapsed:.3f} seconds -> "
          f"{args.out}")
    return 0


def _render_sharded(sc, w, h, args, on_cpu):
    """``--devices N``: the kernels and the native builders are built here
    once, N ranks render (``parallel.mesh.render_frames``), and rank 0's
    gathered buffer is post-processed and written.  Returns rank 0's
    last-frame stats and render seconds."""
    from .native import available
    from .parallel import mesh
    from .runtime import post
    from .utils.image import write_bmp, write_png
    available()
    if on_cpu:
        devices, backend = ["cpu"] * args.devices, "gloo"
    else:
        from .ops import cuda_lib
        cuda_lib.load()
        devices = [f"cuda:{i}" for i in range(args.devices)]
        backend = "nccl"
    frames = -(-args.spp // int(sc.settings.samples_per_pixel))
    res = mesh.spawn_ranks(mesh.render_frames, devices, backend,
                           (sc, w, h, frames))[0]
    img = post.post_process(res["accum"].to(devices[0]), sc.post_settings,
                            device=devices[0])
    (write_png if args.out.endswith(".png") else write_bmp)(
        args.out, img.cpu().numpy())
    rays, nodes, tris = (float(x) for x in res["stats"])
    return rays, nodes, tris, sum(res["frame_s"])


if __name__ == "__main__":
    sys.exit(main())
