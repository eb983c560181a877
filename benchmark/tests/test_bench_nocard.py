"""The measurement path refuses to run without the card a cell asks for,
and without the program beside it, and prints no result then."""

import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import cells

ARGS = ["--workload", "bench.final-2160p", "--seed", "2147483711",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, extra_env=None):
    env = dict(os.environ, **(extra_env or {}))
    return subprocess.run([sys.executable, "benchmark/run.py"] + ARGS,
                          cwd=cwd, capture_output=True, text=True, env=env,
                          timeout=600)


def test_no_card_no_result():
    out = _run(cells.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


@pytest.mark.gpu
def test_benchmark_files_alone_give_no_result(tmp_path, card):
    shutil.copytree(os.path.join(cells.ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert "{" not in out.stdout
