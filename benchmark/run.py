"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout on a machine with the cell's CUDA cards.
Prints what it does on standard error and, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit.  It exits with another
code than 0, and prints no result, without the cards the cell asks for, or
if JAX or the JAX package was loaded.  See ``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "buas_pathtracer_tpu")


def _environment():
    """Build and kernel caches of the program stay inside the checkout, at
    fixed paths (the port builds its own kernels into its package's
    ``csrc/_build`` and ``native/_build``); the host's math libraries keep
    to one thread, so the run is one process with few threads."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    cache = os.path.join(ROOT, "benchmark", "_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules():
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)

    import torch

    torch.set_num_threads(1)

    from benchmark.harness import cells, report, window

    cell = cells.resolve(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.chips != 1:
        print(f"{cell.name}: only one-chip cells are run by this harness",
              file=sys.stderr)
        return 2
    rec = window.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    out = report.result(cell, rec, bool(args.trace),
                        torch.cuda.get_device_name(0), 1)
    report.print_checks(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
