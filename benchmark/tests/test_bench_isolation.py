"""No module that a run loads may be JAX's or the JAX package's, compared
by whole top-level name (the port's name begins with the JAX package's);
and the reference loads nothing of the program either."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.harness import cells

REF_DIR = os.path.join(cells.BENCH_DIR, "reference")
ENV = dict(os.environ, JAX_PLATFORMS="cpu")

HARNESS_RUN = r'''
import json, sys, time
sys.path.insert(0, ROOT)
t0 = time.perf_counter()
from benchmark.harness import cells, window
cell = cells.resolve("bench.final-2160p")
cell.mix = dict(cell.mix, width=32, height=16, readback_every=1)
from benchmark.harness import check
check.CHECK_RAYS, check.MAX_TILES = 2000, 2
rec = window.run(cell, 7, 0.5, False, "cpu", t0, log=lambda *a: None)
print(json.dumps(dict(correct=rec["verdict"]["correct"],
                      top=sorted({m.split(".")[0] for m in sys.modules}))))
'''

REFERENCE_RUN = r'''
import json, sys
sys.path.insert(0, ROOT)
import benchmark.reference as ref
import pkgutil, importlib
for m in pkgutil.iter_modules(ref.__path__):
    importlib.import_module("benchmark.reference." + m.name)
from benchmark.configs import bench
from benchmark.reference.render import render_tiles
img = render_tiles(bench.describe(32, 16), 32, 16, [(0, 0)], 8, 5, 1, "cpu")
print(json.dumps(dict(shape=list(img.shape),
                      top=sorted({m.split(".")[0] for m in sys.modules}))))
'''


def _child(code):
    out = subprocess.run(
        [sys.executable, "-c", f"ROOT = {cells.ROOT!r}\n" + code],
        capture_output=True, text=True, env=ENV, timeout=600, cwd=cells.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("buas_pathtracer_tpu_torch", "buas_pathtracer_tpu_torch.ops",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    for name, top in (("jax.numpy", "jax"), ("jaxlib", "jaxlib"),
                      ("flax.linen", "flax"),
                      ("buas_pathtracer_tpu.ops", "buas_pathtracer_tpu")):
        monkeypatch.setitem(sys.modules, name, sys)
        assert top in run.forbidden_modules()


def test_a_harness_run_loads_no_jax_module():
    got = _child(HARNESS_RUN)
    assert got["correct"] is True
    assert "buas_pathtracer_tpu_torch" in got["top"]
    assert not set(got["top"]) & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    got = _child(REFERENCE_RUN)
    assert got["shape"] == [1, 8, 8, 4]
    assert not set(got["top"]) & (set(run.FORBIDDEN)
                                  | {"buas_pathtracer_tpu_torch"})


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REF_DIR,
                                                              "*.py"))),
                         ids=os.path.basename)
def test_reference_sources_import_only_torch_numpy_and_themselves(path):
    allowed = {"torch", "numpy", "math", "functools", "typing", "dataclasses",
               "__future__"}
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue
            tops = {node.module.split(".")[0]}
        else:
            continue
        assert tops <= allowed, (path, tops)
