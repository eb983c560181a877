"""Find a cell's pieces by the names in ``BENCHMARK.json``.

A cell names a configuration (``benchmark/configs/<config>.py``), a traffic
mix (``benchmark/mixes/<traffic>.json``) and its chips; every metric has a
reader ``benchmark/metrics/<metric>.py``; a cell's correctness limits are
``benchmark/limits/<cell>.json``.  Adding any of them adds a file and an
entry and edits nothing that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_py(path: str, name: str) -> ModuleType:
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    config: ModuleType
    mix_name: str
    mix: Dict
    chips: int
    end_to_end: List[Dict]  # BENCHMARK.json entries that apply to the cell
    per_layer: List[Dict]
    readers: Dict[str, ModuleType]  # metric name -> reader module
    limits: Dict


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def spec(root: str = ROOT) -> Dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def resolve(name: str, root: str = ROOT) -> Cell:
    b = spec(root)
    bench = os.path.join(root, "benchmark")
    w = next((c for c in b["workloads"] if c["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in b["end_to_end"] if applies(m, name)]
    layer = [m for m in b["per_layer"] if applies(m, name)]
    readers = {m["name"]: _load_py(
        os.path.join(bench, "metrics", m["name"] + ".py"),
        "benchmark_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        for m in e2e + layer}
    cfg = w["config"]
    return Cell(
        name=name, config_name=cfg,
        config=_load_py(os.path.join(bench, "configs", cfg + ".py"),
                        "benchmark_config_" + cfg.replace(".", "_")
                        .replace("-", "_")),
        mix_name=w["traffic"],
        mix=_load_json(os.path.join(bench, "mixes", w["traffic"] + ".json")),
        chips=int(w["chips"]), end_to_end=e2e, per_layer=layer,
        readers=readers,
        limits=_load_json(os.path.join(bench, "limits", name + ".json")))
