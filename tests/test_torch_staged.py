"""Staged wavefront compaction of the PyTorch port (integrators/advanced.py,
the JAX package's BUAS_TWO_PHASE / BUAS_PHASE_BLOCKS), mirroring
tests/test_two_phase.py: the staged loop must be BIT-IDENTICAL to the
single full-width loop.

Each stage packs the survivors into a narrower prefix with one gather of
the packed state, sorted by their compact keys, re-runs the same bounce
body there and restores (not adds) the totals through the entry's
permutation.  A lost bit of the uint32 RNG state, a wrong mask at the
boundary or a reordered accumulation shows up as non-equality here, on
the unified table and on the split tables of big scenes.  The
port's staged image is also held to the JAX package's staged image within
the goldens' rtol = atol = 2e-3 (one JAX compile, module-scoped)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buas_pathtracer_tpu.core import sampler as jsmp
from buas_pathtracer_tpu.core import vec as jvec
from buas_pathtracer_tpu.integrators import advanced as jadv
from buas_pathtracer_tpu.models import camera as jcm
from buas_pathtracer_tpu.models.scene import Scene as JScene
from buas_pathtracer_tpu.models.scene import SceneSettings as JSettings
from buas_pathtracer_tpu_torch.core import sampler as tsmp
from buas_pathtracer_tpu_torch.core import vec as tvec
from buas_pathtracer_tpu_torch.integrators import advanced as tadv
from buas_pathtracer_tpu_torch.models import camera as tcm
from buas_pathtracer_tpu_torch.models.scene import Scene as TScene
from buas_pathtracer_tpu_torch.models.scene import SceneSettings as TSettings
from buas_pathtracer_tpu_torch.ops import traverse_wide
from buas_pathtracer_tpu_torch.utils import trace

W, H = 96, 48
N = W * H


def _scene(Scene, vec, cm, env=False, plane=False):
    """tests/test_two_phase.py's open scene (sky misses, so liveness
    decays fast enough to break into a stage at these widths)."""
    sc = Scene(name="two-phase")
    grey = sc.add_diffuse_material((0.6, 0.6, 0.6), 1.2)
    blue = sc.add_diffuse_material((0.2, 0.3, 0.8), 1.4)
    glass = sc.add_translucent_material((0.2, 0.05, 0.05), 1.5)
    light = sc.add_emissive_material((25.0, 25.0, 22.0))
    sc.add_box(grey, (8, 1, 8), vec.translate([0, -1.0, 0]))
    sc.add_sphere(blue, 1.0, vec.translate([-1.2, 1.0, 0]))
    sc.add_sphere(glass, 0.8, vec.translate([1.4, 0.9, -0.5]))
    sc.add_sphere(light, 0.7, vec.translate([0, 5.0, 2.0]))
    if plane:  # a ceiling: rays leaving the box top upwards hit it
        sc.add_plane(blue, (0, -1, 0), -10.0)
    cam = cm.make_camera(p=(0, 2.0, -6.0), vfov=np.radians(45), aspect=W / H)
    sc.camera = cm.aim_camera_at(cam, (0, 1.0, 0))
    if env:
        rng_ = np.random.RandomState(7)
        sc.env_map = (rng_.rand(8, 16, 3) ** 2).astype(np.float32) * 3.0
    return sc


def _set_stages(monkeypatch, two_phase, stages):
    monkeypatch.setenv("BUAS_TWO_PHASE", "1" if two_phase else "0")
    monkeypatch.setenv("BUAS_PHASE_BLOCKS", stages)


def _render(monkeypatch, two_phase, stages, env=False, plane=False,
            split=False):
    """One pass of the port's advanced at W x H, 6 bounces; ``split``:
    through the split tables."""
    _set_stages(monkeypatch, two_phase, stages)
    sc = _scene(TScene, tvec, tcm, env, plane)
    ps = sc.pack(device="cpu", split=split)
    assert (ps.v4_res is not None) == split
    settings = TSettings(max_bounce_count=6, samples_per_pixel=1)
    st = int(settings.sampling_strategy)
    px = torch.arange(N) % W
    py = torch.arange(N) // W
    s = tsmp.make_sampler(px, py, 3, strategy=st)
    s, au, av = tsmp.sample_2d(s, st, tsmp.SampleDimension.AA, 0)
    s, du, dv = tsmp.sample_2d(s, st, tsmp.SampleDimension.DOF, 0)
    rays = tcm.generate_rays(tcm.camera_on(sc.camera, torch.device("cpu")),
                             px.float(), py.float(), W, H, au, av, du, dv,
                             0.0, 1.0, 6, 0.0, 0.0)
    color, _, stats = tadv.advanced(ps, settings, s, rays.o, rays.d,
                                    n_lights=sc.n_lights)
    img = np.stack([color.x.numpy(), color.y.numpy(), color.z.numpy()])
    assert np.isfinite(img).all()
    return img, stats.numpy()


@pytest.fixture(scope="module")
def single_loop_image():
    mp = pytest.MonkeyPatch()
    try:
        return _render(mp, False, "1")
    finally:
        mp.undo()


@pytest.mark.parametrize("stages", ["1", "3", "3,1"])
def test_staged_bit_identical(single_loop_image, monkeypatch, stages):
    """1024 lanes breaks late, 3072 at bounce 1, "3,1" chains two stages."""
    ref_img, ref_stats = single_loop_image
    with trace.frame() as rec:
        img, stats = _render(monkeypatch, True, stages)
    log = rec.bounces  # (bounce, lanes it ran at, live lanes)
    np.testing.assert_array_equal(img, ref_img)
    assert stats[0] == ref_stats[0]
    # node visits shrink: prefiltered lanes skip the walk
    assert 0 < stats[1] <= ref_stats[1]
    widths = [1024 * int(s) for s in stages.split(",")]
    assert set(widths) <= {w for _, w, _ in log}, log


@pytest.fixture(scope="module")
def env_single_loop_image():
    mp = pytest.MonkeyPatch()
    try:
        return _render(mp, False, "1", env=True)
    finally:
        mp.undo()


@pytest.mark.parametrize("stages", ["1", "3,1"])
def test_staged_env_nee_bit_identical(env_single_loop_image, monkeypatch,
                                      stages):
    """env NEE doubles the shadow wave (light + env queries in one 2N
    wave) inside the stages too."""
    ref_img, ref_stats = env_single_loop_image
    img, stats = _render(monkeypatch, True, stages, env=True)
    np.testing.assert_array_equal(img, ref_img)
    assert stats[0] == ref_stats[0]


def test_staged_plane_bit_identical(monkeypatch):
    """A plane lies outside the BVH: a lane that misses the root box but
    hits the plane must keep its walk inside a stage (the port's stage
    prefilter counts plane hits as live)."""
    ref_img, _ = _render(monkeypatch, False, "1", plane=True)
    img, _ = _render(monkeypatch, True, "3,1", plane=True)
    np.testing.assert_array_equal(img, ref_img)


@pytest.fixture(scope="module")
def split_single_loop_images():
    """The single loop through the split tables, without and with env."""
    mp = pytest.MonkeyPatch()
    try:
        return {env: _render(mp, False, "1", env=env, split=True)
                for env in (False, True)}
    finally:
        mp.undo()


@pytest.mark.parametrize("env", [False, True])
@pytest.mark.parametrize("stages", ["1", "3,1"])
def test_staged_split_tables_bit_identical(single_loop_image,
                                           env_single_loop_image,
                                           split_single_loop_images,
                                           monkeypatch, stages, env):
    """The staged loop on the split tables (the big scenes' walk): equal to
    the single loop on the same tables, and that to the unified table's."""
    ref_img, ref_stats = split_single_loop_images[env]
    with trace.frame() as rec:
        img, stats = _render(monkeypatch, True, stages, env=env, split=True)
    log = rec.bounces
    np.testing.assert_array_equal(img, ref_img)
    assert stats[0] == ref_stats[0]
    assert 0 < stats[1] <= ref_stats[1]
    assert 1024 * int(stages[-1]) in {w for _, w, _ in log}, log
    unified = env_single_loop_image if env else single_loop_image
    np.testing.assert_array_equal(ref_img, unified[0])


def test_shadow_queries_one_wave(monkeypatch):
    """The light and env shadow queries in one 2N wave answer as one wave
    each would."""
    sc = _scene(TScene, tvec, tcm, env=True)
    ps = sc.pack(device="cpu")
    r = np.random.RandomState(11)
    n = 3000
    queries = []
    for k in range(2):
        o = r.uniform(-3.0, 3.0, (3, n)).astype(np.float32)
        o[1] = np.abs(o[1])
        d = r.randn(3, n).astype(np.float32)
        d /= np.linalg.norm(d, axis=0)
        max_t = np.where(r.rand(n) < 0.2, -1.0,
                         r.uniform(0.5, 20.0, n)).astype(np.float32)
        ign = r.randint(-1, 4, n) if k == 0 else np.full(n, -1)
        queries.append((tvec.Vec3(*map(torch.from_numpy, o)),
                        tvec.Vec3(*map(torch.from_numpy, d)),
                        torch.from_numpy(max_t), torch.from_numpy(ign)))
    occ = tadv._shadow(ps, queries)
    each = [traverse_wide.intersect_shadow_ray(ps, *q) for q in queries]
    assert len(occ) == 2
    for a, b in zip(occ, each):
        assert torch.equal(a, b)
    assert 0 < int(occ[0].sum()) < n and 0 < int(occ[1].sum()) < n


def test_stage_widths_and_gate(monkeypatch):
    monkeypatch.setenv("BUAS_PHASE_BLOCKS", "512, 128,,256,64")
    assert tadv.stage_widths(2073600) == [524288, 131072, 65536]
    assert tadv.stage_widths(300000) == [131072, 65536]
    monkeypatch.setenv("BUAS_TWO_PHASE", "1")
    s_int = tsmp.make_sampler(torch.arange(8), torch.arange(8), 0,
                              strategy=tsmp.Strategy.STRATIFIED)
    s_ray = tsmp.make_sampler(torch.arange(8), torch.arange(8),
                              torch.arange(8), strategy=tsmp.Strategy.UNIFORM)
    st = TSettings(max_bounce_count=6)
    assert tadv.two_phase(st, s_int, 2073600)
    assert not tadv.two_phase(st, s_ray, 2073600)  # per-ray sample index
    assert not tadv.two_phase(TSettings(max_bounce_count=2), s_int, 2073600)
    assert not tadv.two_phase(st, s_int, 65536)  # no stage narrower
    monkeypatch.setenv("BUAS_TWO_PHASE", "0")
    assert not tadv.two_phase(st, s_int, 2073600)
    # unset: the measured default (PERF.md), the single loop
    monkeypatch.delenv("BUAS_TWO_PHASE")
    assert tadv.two_phase(st, s_int, 2073600) == (
        tadv.DEFAULT_TWO_PHASE == "1")
    monkeypatch.delenv("BUAS_PHASE_BLOCKS")
    assert tadv.stage_widths(2073600) == [
        1024 * int(w) for w in tadv.DEFAULT_PHASE_BLOCKS.split(",")]


def test_permute_state_round_trip():
    """A permutation and its inverse give back every bit: NaN payloads,
    -0.0, uint32 RNG states at and above 2^31, stack material ids."""
    n = 1000
    r = np.random.RandomState(5)
    f = r.randn(15, n).astype(np.float32)
    f[0, :3] = [np.float32(-0.0), np.inf, np.nan]
    f.view(np.uint32)[1, :2] = [0x7FC00123, 0xFFFFFFFF]  # NaN payloads
    state = r.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.int64)
    state[:2] = [2 ** 31, 2 ** 32 - 1]
    t = [torch.from_numpy(f[k].copy()) for k in range(15)]
    v = [tvec.Vec3(*t[3 * k:3 * k + 3]) for k in range(5)]
    smp = tsmp.make_sampler(torch.arange(n), torch.arange(n), 0,
                            strategy=tsmp.Strategy.UNIFORM)
    st = tadv._State(
        alive=torch.from_numpy(r.rand(n) < 0.5), o=v[0], d=v[1], tp=v[2],
        total=v[3], s=smp._replace(state=torch.from_numpy(state)),
        stack=torch.from_numpy(r.randint(0, 9, (tadv.STACK_DEPTH, n))),
        stack_at=torch.from_numpy(r.randint(0, 8, n)),
        is_spec=torch.from_numpy(r.rand(n) < 0.5), prev_n=v[4],
        live_r=torch.from_numpy(r.rand(n) < 0.5))
    perm = torch.from_numpy(r.permutation(n))
    back = tadv._permute_state(torch.argsort(perm),
                               tadv._permute_state(perm, st))
    for a, b in zip(st, back):
        if isinstance(a, tsmp.Sampler):
            a, b = a.state, b.state
        for x, y in (zip(a, b) if isinstance(a, tvec.Vec3) else [(a, b)]):
            assert x.dtype == y.dtype
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y)
    pre = tadv._permute_state(perm[:100], st)  # a prefix
    assert torch.equal(pre.s.state, st.s.state[perm[:100]])
    assert torch.equal(pre.stack, st.stack[:, perm[:100]])


@pytest.fixture(scope="module")
def jax_staged_image():
    """The JAX package's staged advanced on the same rays (its CPU/XLA
    path, stages "3,1")."""
    mp = pytest.MonkeyPatch()
    try:
        _set_stages(mp, True, "3,1")
        sc = _scene(JScene, jvec, jcm)
        ps = sc.pack()
        settings = JSettings(max_bounce_count=6, samples_per_pixel=1)
        st = int(settings.sampling_strategy)
        px = (jnp.arange(N, dtype=jnp.int32) % W).astype(jnp.float32)
        py = (jnp.arange(N, dtype=jnp.int32) // W).astype(jnp.float32)
        s = jsmp.make_sampler(px.astype(jnp.uint32), py.astype(jnp.uint32),
                              jnp.uint32(3), strategy=st)
        s, au, av = jsmp.sample_2d(s, st, jsmp.SampleDimension.AA, 0)
        s, du, dv = jsmp.sample_2d(s, st, jsmp.SampleDimension.DOF, 0)
        rays = jcm.generate_rays(sc.camera, px, py, W, H, au, av, du, dv,
                                 0.0, 1.0, 6, 0.0, 0.0)
        color, _, stats = jadv.advanced(ps, settings, s, rays.o, rays.d,
                                        n_lights=sc.n_lights)
        return (np.stack([np.asarray(color.x), np.asarray(color.y),
                          np.asarray(color.z)]), np.asarray(stats))
    finally:
        mp.undo()


def test_staged_matches_jax_staged(jax_staged_image, monkeypatch):
    ref, jstats = jax_staged_image
    img, stats = _render(monkeypatch, True, "3,1")
    diff = np.abs(img - ref)
    outside = (diff > 2e-3 + 2e-3 * np.abs(ref)).any(axis=0)
    assert outside.mean() <= 0.01, outside.mean()
    assert (diff / np.maximum(np.abs(ref), 1e-3)).mean() <= 1e-3
    assert stats[0] == jstats[0]  # the same rays traced
