"""The reference's environment lighting against the program, on the CPU.

(a) The reference decodes a Radiance ``.hdr`` map and builds its alias
    table by itself; both equal the program's byte for byte
    (``utils/assets.load_environment_map``, ``Scene._env_tables``), on the
    committed ``gallery/hero_sky.hdr`` (flat scanlines) and on seeded
    random maps written flat and with adaptive RLE.  Its lookup, pdf and
    alias sample equal the program's ``ops/envmap`` bit for bit.
(b) A hero-shaped frame (``hero_scene.py`` with the icospheres subdivided
    (2, 1) times) at 48 x 27, two passes from a large first sample index,
    rendered by the program's ``ProgressiveRenderer`` on the CPU, against
    the reference's tiles, compared as the check compares them and held
    to ``bench.final-1080p``'s limits (0.18 / 1.3), with env NEE on and
    off.  Readings when this test was written: px_off 0.0, lsb_mean 0.0
    both ways (the program's plain version and the reference do the same
    float32 arithmetic); the reference in bfloat16, the control, reads
    0.673828125 / 13.96 (env NEE on) and 0.6640625 / 13.00 (off) on the
    same tiles.  The limits are the only tolerance: the test asks for
    nothing tighter, since the card's kernels may round a channel by an
    LSB where the plain version does not.
(c) The reference's tiles of the three configurations without a map are
    byte-equal to what the reference rendered before it learnt the map
    (digests of the reference without the map's code, PyTorch 2.13 on the
    CPU): nothing moved for the cells that are there.
"""

import hashlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.configs import bench, stress, week7_nicer
from benchmark.harness import cells, check, port_scene
from benchmark.reference import envmap as ref_env
from benchmark.reference import scene as ref_scene
from benchmark.reference.render import render_tiles
from benchmark.reference.vec import Vec3 as RVec3
from benchmark.tests import hero_scene
from buas_pathtracer_tpu_torch.core.vec import Vec3
from buas_pathtracer_tpu_torch.models.scene import Scene
from buas_pathtracer_tpu_torch.ops import envmap as prog_env
from buas_pathtracer_tpu_torch.runtime import film
from buas_pathtracer_tpu_torch.runtime.progressive import ProgressiveRenderer
from buas_pathtracer_tpu_torch.utils.assets import load_environment_map
from buas_pathtracer_tpu_torch.utils.image import write_hdr

ROOT = cells.ROOT
W, H = 48, 27
PASSES = 2
FIRST = 2147483701 & 0xFFFFFFFF
TILE = 16
ORIGINS = [(y, x) for y in (0, H - TILE) for x in (0, 16, 32)]


def _random_map(h=24, w=40, seed=5):
    g = np.random.default_rng(seed)
    env = g.random((h, w, 3), np.float32) * np.exp2(
        g.integers(-12, 8, (h, w, 1))).astype(np.float32)
    env[3, 7] = 0.0  # a black texel: exponent 0
    return env


def _write_rle(path, flat_path):
    """The map of the flat file ``flat_path`` again, with adaptive-RLE
    scanlines: each component a stream of runs of three or more equal
    bytes and of literals."""
    with open(flat_path, "rb") as f:
        data = f.read()
    res = data.index(b"\n\n") + 2
    head = data.index(b"\n", res) + 1
    _, h, _, w = data[res:head].split()
    h, w = int(h), int(w)
    rgbe = np.frombuffer(data, np.uint8, offset=head).reshape(h, w, 4)
    body = bytearray()
    for y in range(h):
        body += bytes([2, 2, w >> 8, w & 255])
        for comp in range(4):
            row = rgbe[y, :, comp]
            x = 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run >= 3:
                    body += bytes([128 + run, row[x]])
                    x += run
                    continue
                end = x + 1  # a literal, up to the next run of three
                while end < w and end - x < 128 and not (
                        end + 2 < w
                        and row[end] == row[end + 1] == row[end + 2]):
                    end += 1
                body += bytes([end - x]) + bytes(row[x:end])
                x = end
    with open(path, "wb") as f:
        f.write(data[:head] + bytes(body))


def _maps(tmp_path):
    flat = str(tmp_path / "flat.hdr")
    write_hdr(flat, _random_map())
    rgb = _random_map(16, 64, 6)
    rgb[:, 20:50] = rgb[:, 20:21]  # long runs in every component
    write_hdr(str(tmp_path / "flat2.hdr"), rgb)
    rle = str(tmp_path / "rle.hdr")
    _write_rle(rle, str(tmp_path / "flat2.hdr"))
    return [os.path.join(ROOT, hero_scene.ENV_PATH), flat, rle]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["hero_sky", "random_flat",
                                                  "random_rle"])
def test_decoder_and_tables_equal_the_programs(tmp_path, which):
    path = _maps(tmp_path)[which]
    ours = ref_env.load(path)
    theirs = load_environment_map(path)
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.shape == theirs.shape and ours.tobytes() == theirs.tobytes()
    assert ours.max() > 0.0
    sc = Scene()
    sc.env_map = theirs
    tables = sc._env_tables()
    prob, alias, pdf_num = ref_env.alias_table(ours)
    for mine, key in ((prob, "env_alias_prob"), (alias, "env_alias_idx"),
                      (pdf_num, "env_pdf_num")):
        prog = np.asarray(tables[key])
        assert mine.dtype == prog.dtype and mine.tobytes() == prog.tobytes()


def test_the_rle_file_is_read_as_rle(tmp_path):
    rle = _maps(tmp_path)[2]
    with open(rle, "rb") as f:
        data = f.read()
    assert len(data) < 16 * 64 * 4  # runs, not flat scanlines
    assert ref_env.load(rle).tobytes() == ref_env.load(
        str(tmp_path / "flat2.hdr")).tobytes()


def test_an_unreadable_map_raises(tmp_path):
    bad = tmp_path / "bad.hdr"
    bad.write_bytes(b"not a map")
    with pytest.raises(ValueError):
        ref_env.load(str(bad))
    with pytest.raises(FileNotFoundError):
        ref_env.load(str(tmp_path / "missing.hdr"))


def test_lookup_pdf_and_sample_equal_the_programs():
    env = ref_env.build(os.path.join(ROOT, hero_scene.ENV_PATH), "cpu")
    g = torch.Generator().manual_seed(11)
    n = 20000
    d = torch.randn((3, n), generator=g)
    d = d / d.norm(dim=0)
    u, v = torch.rand((2, n), generator=g)
    h, w, _ = env.pixels.shape
    mine = ref_env.lookup(env, RVec3(*d))
    theirs = prog_env.lookup_env(env.pixels, Vec3(*d))
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    assert torch.equal(ref_env.pdf(env, RVec3(*d)),
                       prog_env.env_pdf_table(env.pdf_num, h, w, Vec3(*d)))
    md, mp, mr = ref_env.sample(env, u, v)
    td, tp, tr = prog_env.sample_env_alias(env.prob, env.alias, env.pdf_num,
                                           env.pixels, u, v)
    assert all(torch.equal(a, b) for a, b in zip(md, td))
    assert all(torch.equal(a, b) for a, b in zip(mr, tr))
    assert torch.equal(mp, tp)


def _hero(env_nee=True):
    data = hero_scene.describe(W, H, (2, 1))
    data.settings = dict(data.settings, env_nee=env_nee)
    return data


def _program_tiles(data):
    r = ProgressiveRenderer(port_scene.build(data), W, H, device="cpu")
    r.accum = film.new_accumulation_buffer(H, W, r.device)
    r.frame_count = FIRST
    for _ in range(PASSES):
        r.render_one_frame()
    img = r.display_rgba8()
    ys = np.array([[[y0 + i] * TILE for i in range(TILE)]
                   for y0, _ in ORIGINS])
    xs = np.array([[list(range(x0, x0 + TILE))] * TILE for _, x0 in ORIGINS])
    return img[ys, xs]


def _limits():
    with open(os.path.join(ROOT, "benchmark", "limits",
                           "bench.final-1080p.json")) as f:
        return {k: v["limit"] for k, v in json.load(f).items()}


@pytest.mark.parametrize("env_nee", [True, False], ids=["env_nee",
                                                        "no_env_nee"])
def test_an_env_lit_frame_matches_the_reference(env_nee):
    data = _hero(env_nee)
    prog = _program_tiles(data)
    rs = ref_scene.build(data, "cpu")
    ref = render_tiles(rs, W, H, ORIGINS, TILE, FIRST, PASSES, "cpu")
    vals = check.numbers(prog, ref)
    lim = _limits()
    for k in check.NUMBERS:
        assert vals[k] <= lim[k], (k, vals)
    assert ref[..., :3].max() > 0 and prog[..., :3].max() > 0
    low = render_tiles(rs, W, H, ORIGINS, TILE, FIRST, PASSES, "cpu",
                       torch.bfloat16)
    ctl = check.numbers(low, ref)
    assert all(ctl[k] > 2 * lim[k] for k in check.NUMBERS), ctl


def test_env_nee_changes_the_reference():
    """The two ways differ: the reference's env NEE is no dead branch."""
    on = render_tiles(_hero(True), W, H, ORIGINS[:2], TILE, FIRST, 1, "cpu")
    off = render_tiles(_hero(False), W, H, ORIGINS[:2], TILE, FIRST, 1, "cpu")
    assert check.numbers(on, off)["px_off"] > 0.1


def test_the_judged_tiles_hold_the_scene():
    """Geometry first: on the hero frame, whose upper part is sky, every
    tile put before a sky tile holds the scene, the groups keep the
    seed's order, and the first tiles judged are geometry."""
    w, h = 96, 54
    data = hero_scene.describe(w, h, (1, 1))
    plan = check.draw(2147483717, w, h)
    plan = check.Plan(plan.origins[:12], plan.ys[:12], plan.xs[:12],
                      plan.size, plan.u)
    from benchmark.reference.render import geometry_share
    rs = ref_scene.build(data, "cpu")
    share = geometry_share(rs, w, h, plan.origins, plan.size, "cpu")
    assert (share < check.GEOMETRY_SHARE).any()  # some drawn tiles are sky
    ordered, order = check.geometry_first(rs, w, h, plan, "cpu")
    holds = share[order] >= check.GEOMETRY_SHARE
    n_geo = int(holds.sum())
    assert n_geo > 0 and holds[:n_geo].all() and not holds[n_geo:].any()
    assert list(order[:n_geo]) == sorted(order[:n_geo])
    assert list(order[n_geo:]) == sorted(order[n_geo:])
    assert ordered.origins == [plan.origins[i] for i in order]
    img = np.random.default_rng(0).integers(0, 255, (h, w, 4), np.uint8)
    assert np.array_equal(check.grab(ordered, img),
                          check.grab(plan, img)[order])


DIGESTS = {
    "bench":
        "cd51d398270042557bbe8bc9c5dc28082b2bf824292246f29584bdcdd76b40f8",
    "week7_nicer":
        "769ce9bebc986afc8fcb27799394653ad5fab7c0a741f9af33c3036c2e86d288",
    "stress":
        "594b7d486632d5b1dedd7e86806254aae34f29e8910b45f672c4e657bf0b5f5e",
}
CASES = {
    "bench": SimpleNamespace(data=lambda: bench.describe(40, 24),
                             origins=[(0, 0), (12, 24)]),
    "week7_nicer": SimpleNamespace(data=lambda: week7_nicer.describe(40, 24),
                                   origins=[(4, 8), (14, 30)]),
    "stress": SimpleNamespace(data=lambda: stress.scene(40, 24, 2),
                              origins=[(0, 16), (10, 2)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_reference_is_unchanged_without_a_map(name):
    c = CASES[name]
    img = render_tiles(c.data(), 40, 24, c.origins, 8, FIRST, 2, "cpu")
    assert img[..., :3].max() > 0
    assert hashlib.sha256(img.tobytes()).hexdigest() == DIGESTS[name]
