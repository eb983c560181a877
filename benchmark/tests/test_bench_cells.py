"""Every cell resolves to its files by name; BENCHMARK.json keeps the
shape its readers expect; and a new configuration, mix and per-layer
metric are new files and entries that edit no file already there."""

import hashlib
import json
import os
import re
import shutil

import pytest

from benchmark.harness import cells, check

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves_to_its_files():
    spec = cells.spec()
    assert spec["workloads"]
    for w in spec["workloads"]:
        c = cells.resolve(w["name"])
        assert c.config_name == w["config"] and c.mix_name == w["traffic"]
        assert callable(c.config.describe)
        for key in ("width", "height", "spp", "readback_every", "ranks"):
            assert int(c.mix[key]) > 0
        for m in c.end_to_end + c.per_layer:
            assert callable(c.readers[m["name"]].read)
        for k in check.NUMBERS:
            assert float(c.limits[k]["limit"]) > 0


def test_benchmark_json_keeps_its_shape():
    spec = cells.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"][1].startswith(spec["paths"][0] + "/")
    assert 1 <= spec["run_seconds"] <= 51
    configs = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 0 < len(c["why"]) <= 200 and 0 < len(c["source"]) <= 200
        assert NAME.match(c["name"]) and os.path.isfile(
            os.path.join(cells.ROOT, c["file"]))
        assert c["file"].startswith(tuple(p + "/" for p in spec["paths"]))
    names = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
        names.add(w["name"])
    assert configs == {w["config"] for w in spec["workloads"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= names
    every = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(every) == len(set(every))
    for w in names:  # every cell: setup_s, another end-to-end, a layer
        e = [m for m in spec["end_to_end"] if cells.applies(m, w)]
        assert len(e) >= 2 and any(m["name"] == "setup_s" for m in e)
        assert any(cells.applies(m, w) for m in spec["per_layer"])


def _hashes(root):
    out = {}
    for d, _, files in os.walk(root):
        if "__pycache__" in d or "_cache" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


DUMMY_CONFIG = '''
from benchmark.harness import scene_data as sd

SOURCE = "a test scene"
REDUCED = []
ASSUMED = {}


def describe(w, h):
    sc = sd.SceneData(name="dummy")
    sc.add_sphere(sc.add_material(sd.diffuse((0.5, 0.5, 0.5), 1.0)), 1.0)
    sc.camera = sd.camera((0, 0, -5), vfov=0.8, aspect=w / h, at=(0, 0, 0))
    return sc
'''

DUMMY_METRIC = '''
def read(rec):
    return rec["passes"] * 2.0
'''


def test_adding_a_config_mix_and_metric_edits_no_existing_file(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(cells.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), root)
    before = _hashes(root / "benchmark")

    b = root / "benchmark"
    (b / "configs" / "dummy.py").write_text(DUMMY_CONFIG)
    mix = json.loads((b / "mixes" / "final-2160p.json").read_text())
    mix.update(width=64, height=32, why="a test mix")
    (b / "mixes" / "dummy-mix.json").write_text(json.dumps(mix))
    (b / "metrics" / "dummy_metric.py").write_text(DUMMY_METRIC)
    (b / "limits" / "dummy.dummy-mix.json").write_text(json.dumps(
        {k: {"limit": 0.5} for k in check.NUMBERS}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="dummy", source="a test scene",
                                file="benchmark/configs/dummy.py",
                                reduced=[], why="a test scene"))
    spec["workloads"].append(dict(name="dummy.dummy-mix", config="dummy",
                                  traffic="dummy-mix", chips=1, why="test"))
    spec["per_layer"].append(dict(
        name="dummy_metric", unit="x", better="lower", source="host_clock",
        layer="Session layer", moves="msamples_per_s",
        workloads=["dummy.dummy-mix"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    c = cells.resolve("dummy.dummy-mix", root=str(root))
    assert c.config.describe(64, 32).name == "dummy"
    assert c.mix["width"] == 64
    assert c.readers["dummy_metric"].read({"passes": 3}) == 6.0
    assert "dummy_metric" not in cells.resolve(
        "bench.final-2160p", root=str(root)).readers
    after = _hashes(root / "benchmark")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        "configs/dummy.py", "mixes/dummy-mix.json",
        "metrics/dummy_metric.py", "limits/dummy.dummy-mix.json"}


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.resolve("no.such-cell")
