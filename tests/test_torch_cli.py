"""The port's command-line renderer (``python -m
buas_pathtracer_tpu_torch.cli``) in a subprocess: ``--device cpu`` renders
and writes the PNG of the in-process render of the same scene, pixel for
pixel; ``--list`` names the twelve scenes; ``--devices`` above the card
count and a run without a card are refused (``--device cpu --devices 2``
renders: tests/test_torch_mesh.py)."""

import os
import re
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from buas_pathtracer_tpu.models import scenes as jscenes
from buas_pathtracer_tpu_torch.models import scenes as tscenes
from buas_pathtracer_tpu_torch.runtime.progressive import ProgressiveRenderer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, data_dir, hide_cards=False):
    env = dict(os.environ, BUAS_TPU_DATA=data_dir)
    if hide_cards:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "-m", "buas_pathtracer_tpu_torch.cli", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def decode_png(data: bytes) -> np.ndarray:
    """The 8-bit RGB(A), filter-0 PNGs that utils/image.write_png writes."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    at, idat, ihdr = 8, b"", None
    while at < len(data):
        n, = struct.unpack(">I", data[at:at + 4])
        tag, body = data[at + 4:at + 8], data[at + 8:at + 8 + n]
        assert struct.unpack(">I", data[at + 8 + n:at + 12 + n])[0] == \
            zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        at += 12 + n
    w, h, depth, ctype = ihdr[:4]
    c = {6: 4, 2: 3}[ctype]
    assert depth == 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h,
                                                                 w * c + 1)
    assert (raw[:, 0] == 0).all()  # filter type 0 on every row
    return raw[:, 1:].reshape(h, w, c)


@pytest.fixture
def empty_data(tmp_path, monkeypatch):
    d = str(tmp_path / "data")
    monkeypatch.setattr(tscenes, "DATA_DIR", d)
    return d


def test_render_cpu_matches_in_process(tmp_path, empty_data):
    out = str(tmp_path / "cli.png")
    res = run_cli(["--device", "cpu", "--size", "32x18", "--spp", "2",
                   "--out", out], empty_data)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert re.fullmatch(r"Took 32x18 2spp image in [0-9.]+ seconds -> "
                        + re.escape(out), lines[-1]), lines[-1]
    assert lines[-2].startswith("last frame: ") and "rays" in lines[-2]
    sc = tscenes.load_scene("Nested Dielectrics", 32, 18)
    r = ProgressiveRenderer(sc, 32, 18, device="cpu")
    r.take_picture(2, str(tmp_path / "in_process.png"))
    with open(out, "rb") as f:
        img = decode_png(f.read())
    assert img.shape == (18, 32, 4)
    np.testing.assert_array_equal(img, r.display_rgba8())
    rays = float(lines[-2].split()[2])
    assert rays == r.last_stats[0]


def test_options_reach_the_scene(tmp_path, empty_data):
    """--scene, --integrator, --bounces, --filter and a .bmp output."""
    out = str(tmp_path / "w.bmp")
    res = run_cli(["--device", "cpu", "--scene", "Week 6", "--size",
                   "16x9", "--spp", "1", "--integrator", "Normals",
                   "--bounces", "2", "--filter", "Box", "--strategy", "0",
                   "--out", out], empty_data)
    assert res.returncode == 0, res.stderr
    with open(out, "rb") as f:
        data = f.read()
    assert data[:2] == b"BM" and len(data) == 54 + 16 * 9 * 4


def test_list_names_the_scenes(empty_data):
    res = run_cli(["--list"], empty_data)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == [d.name for d in jscenes.SCENES]


def test_several_devices_refused(tmp_path, empty_data):
    """More ranks than cards (none visible here) are refused: one card is
    never shared silently."""
    out = str(tmp_path / "never.png")
    res = run_cli(["--devices", "2", "--out", out], empty_data,
                  hide_cards=True)
    assert res.returncode == 2
    assert "one rank a card" in res.stderr
    assert not os.path.exists(out)


def test_no_card_raises(tmp_path, empty_data):
    """Without --device the CLI renders on the card, and without one it
    fails instead of rendering on the CPU."""
    out = str(tmp_path / "never.png")
    res = run_cli(["--size", "8x8", "--spp", "1", "--out", out], empty_data,
                  hide_cards=True)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not os.path.exists(out)
