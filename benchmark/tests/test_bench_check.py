"""The check that decides ``correct``, at a size a test run holds, on the
CPU: a sound run passes; the control (the reference in the program's
place, its ray arithmetic in bfloat16) fails every cell's limits; and a
run with the timed path broken underneath comes out not correct, for each
fault a one-chip cell can have.  The same holds of an env-lit frame (the
hero frame, which no cell renders yet, held to the limits bench held
at 1080p), and there also of a program that drops env NEE or renders the
gradient sky where the map belongs."""

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import cells, check, control, window
from benchmark.tests import hero_scene

W, H = 48, 32


@pytest.fixture(autouse=True)
def small_check(monkeypatch):
    monkeypatch.setattr(check, "CHECK_RAYS", 6000)
    monkeypatch.setattr(check, "MAX_TILES", 4)


def small(name):
    c = cells.resolve(name)
    # a readback every frame: a run's first frame already gives one
    c.mix = dict(c.mix, width=W, height=H, readback_every=1)
    return c


def hero():
    """An env-lit cell: the hero frame with its icospheres subdivided
    (2, 1) times, the final-2160p mix at the tests' size, and the limits
    that bench held at 1080p (``limits/bench.final-1080p.json``)."""
    c = small("bench.final-2160p")
    c.name, c.config_name = "hero.final-2160p", "hero"
    with open(os.path.join(cells.BENCH_DIR, "limits",
                           "bench.final-1080p.json")) as f:
        c.limits = json.load(f)
    c.config = SimpleNamespace(
        describe=lambda w, h: hero_scene.describe(w, h, (2, 1)))
    return c


def run(cell, seed=2147483717):
    return window.run(cell, seed, 1.0, False, "cpu", time.perf_counter(),
                      log=lambda *a: None)["verdict"]


def test_numbers_count_channels_more_than_one_lsb_off():
    a = np.full((1, 2, 2, 4), 100, np.uint8)
    b = a.copy()
    b[0, 0, 0, 0] = 101  # within the post kernel's 1 LSB
    b[0, 1, 1, 2] = 110
    got = check.numbers(a, b)
    assert got["px_off"] == 0.25
    assert got["lsb_mean"] == pytest.approx(11 / 16)


def test_the_judged_readback_and_tiles_follow_the_seed():
    p = check.draw(2147483717, 1920, 1080)
    q = check.draw(2147483717, 1920, 1080)
    assert p.origins == q.origins and p.u == q.u
    assert all(0 <= y <= 1080 - 16 and 0 <= x <= 1920 - 16
               for y, x in p.origins)
    j, passes, tiles = check.judged(p, 10, 16, 2)
    assert 0 <= j < 10 and passes == 16 * (j + 1)
    assert 1 <= tiles <= check.MAX_TILES
    assert tiles * passes * 20 * 20 <= max(check.CHECK_RAYS, passes * 400)
    img = np.arange(1080 * 1920 * 4, dtype=np.uint32).reshape(1080, 1920, 4)
    y, x = p.origins[3]
    assert np.array_equal(check.grab(p, img)[3], img[y:y + 16, x:x + 16])


def test_a_sound_run_is_correct():
    v = run(small("bench.final-2160p"))
    assert v["correct"] and v["values"] == {"px_off": 0.0, "lsb_mean": 0.0}


def test_a_sound_env_lit_run_is_correct():
    v = run(hero())
    assert v["correct"] and v["values"] == {"px_off": 0.0, "lsb_mean": 0.0}


@pytest.mark.parametrize("name", ["bench.final-2160p",
                                  "week7_nicer.final-2160p",
                                  "bench.preview-576p"])
def test_the_control_fails_the_cells_limits(name):
    c = small(name)
    got = control.readings(c, 2147483719, readbacks=2, device="cpu")
    assert any(got[k] > float(c.limits[k]["limit"]) for k in check.NUMBERS)


def test_the_control_fails_an_env_lit_frame():
    c = hero()
    got = control.readings(c, 2147483719, readbacks=2, device="cpu")
    assert any(got[k] > float(c.limits[k]["limit"]) for k in check.NUMBERS)


def _unchanged(mp):
    """A pass that returns its state unchanged."""
    from buas_pathtracer_tpu_torch.runtime import progressive
    mp.setattr(progressive, "render_frame",
               lambda ps, settings, cam, accum, *a, **k: (
                   accum, torch.zeros(3)))


def _half_left_out(mp):
    """Half of each pass's samples left out with their filter weights
    (every other row of samples), so the image is the mean over the
    rest."""
    from buas_pathtracer_tpu_torch.runtime import film
    splat = film.splat_pass_prepadded

    def half(sample_ext, jx_ext, jy_ext, filt):
        keep = (torch.arange(sample_ext.shape[0]) % 2 == 0).to(
            sample_ext.dtype)[:, None, None]
        return splat(sample_ext * keep, jx_ext, jy_ext, filt)

    mp.setattr(film, "splat_pass_prepadded", half)


def _answer_altered(mp):
    """The RGBA8 image altered where the post pass produces it."""
    from buas_pathtracer_tpu_torch.runtime import post
    real = post.post_rgba8

    def altered(accum, tile, settings):
        out = real(accum, tile, settings).clone()
        out[..., 0] = torch.clamp(out[..., 0].to(torch.int16) + 3, 0,
                                  255).to(torch.uint8)
        return out

    mp.setattr(post, "post_rgba8", altered)


def _env_nee_dropped(mp):
    """Env NEE left out of the program's integrator (misses then weigh
    1, as with env NEE off)."""
    from buas_pathtracer_tpu_torch.integrators import advanced
    flags = advanced._flags
    mp.setattr(advanced, "_flags",
               lambda *a: flags(*a)._replace(env_nee=False))


def _gradient_sky(mp):
    """The gradient sky where the environment map belongs, on every
    miss."""
    from buas_pathtracer_tpu_torch.integrators import advanced
    from buas_pathtracer_tpu_torch.ops.shading import sample_sky_gradient
    mp.setattr(advanced, "sample_sky", lambda ps, d: sample_sky_gradient(
        d, ps.sky_bot, ps.sky_top))


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _answer_altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    v = run(small("bench.final-2160p"))
    assert v["correct"] is False, v["values"]


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _answer_altered, _env_nee_dropped,
                                   _gradient_sky],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered", "env_nee_dropped",
                              "gradient_sky"])
def test_a_broken_env_lit_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    v = run(hero())
    assert v["correct"] is False, v["values"]
