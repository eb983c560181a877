"""The Advanced Pathtracer's bounce loop in the PyTorch port
(integrators/advanced.py) and the route of its waves to the walk kernels
(ops/traverse_wide.py).

On tests/test_two_phase.py's open scene (sky misses, a glass sphere, a
light sphere; an environment map and a plane outside the BVH on request):
the port's frame against the JAX package's single loop (no stage of the
JAX package's is narrower than these 4,608 lanes, and its staged loop is
bit-identical to it, tests/test_two_phase.py) within the goldens' rtol =
atol = 2e-3 with the same rays traced, on the unified table and on the split tables; the split tables'
frame bit for bit the unified table's; every wave of ``intersect_scene``
and ``intersect_shadow_ray`` reaching ``packet.wide_traverse`` /
``packet.split_traverse`` looked up as module attributes, which is where
the benchmark's harness patches them to count the walks, and none under
``BUAS_TRAVERSAL=threaded``; and the light and env shadow queries in one 2N
wave answering as one wave each.  Env-lit JAX frames run op by op
(``jax.disable_jit``).  The other ``SceneSettings`` against the JAX package
are in test_torch_loop_settings.py, so that two test workers share the JAX
frames."""

import functools

import jax
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
from buas_pathtracer_tpu_torch.ops import packet, traverse_wide
from buas_pathtracer_tpu_torch.utils import trace

W, H = 96, 48
N = W * H
BOUNCES = 6


def _scene(Scene, vec, cm, env=False, plane=False, lamp=False):
    """tests/test_two_phase.py's open scene.  ``lamp``: a second, smaller
    light, so that picking a light has a choice."""
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
    if lamp:
        warm = sc.add_emissive_material((9.0, 6.0, 3.0))
        sc.add_sphere(warm, 0.3, vec.translate([-2.5, 2.5, -1.5]))
    cam = cm.make_camera(p=(0, 2.0, -6.0), vfov=np.radians(45), aspect=W / H)
    sc.camera = cm.aim_camera_at(cam, (0, 1.0, 0))
    if env:
        rng_ = np.random.RandomState(7)
        sc.env_map = (rng_.rand(8, 16, 3) ** 2).astype(np.float32) * 3.0
    return sc


def _render(env=False, plane=False, split=False, lamp=False, **settings):
    """One pass of the port's advanced at W x H, BOUNCES bounces unless
    ``settings`` say otherwise; ``split``: through the split tables.
    Returns (image (3, N), stats)."""
    sc = _scene(TScene, tvec, tcm, env, plane, lamp)
    ps = sc.pack(device="cpu", split=split)
    assert (ps.v4_res is not None) == split
    settings = TSettings(**{"max_bounce_count": BOUNCES,
                            "samples_per_pixel": 1, **settings})
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


def jax_render(env=False, plane=False, lamp=False, **settings):
    """``_render``'s pass through the JAX package's single loop (its
    CPU/XLA path; op by op when env-lit).  Returns (image (3, N), stats)."""
    with jax.disable_jit(env):
        sc = _scene(JScene, jvec, jcm, env, plane, lamp)
        ps = sc.pack()
        settings = JSettings(**{"max_bounce_count": BOUNCES,
                                "samples_per_pixel": 1, **settings})
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


def assert_matches_jax(port, ref):
    """The goldens' tolerance, with the port's rule for live renders
    (test_torch_render.py): at most 1% of pixels outside rtol = atol =
    2e-3, mean relative error at most 1e-3; the same rays traced."""
    (img, stats), (jimg, jstats) = port, ref
    diff = np.abs(img - jimg)
    outside = (diff > 2e-3 + 2e-3 * np.abs(jimg)).any(axis=0)
    assert outside.mean() <= 0.01, outside.mean()
    assert (diff / np.maximum(np.abs(jimg), 1e-3)).mean() <= 1e-3
    assert stats[0] == jstats[0]


@functools.lru_cache(maxsize=None)
def port_frame(env, plane, split):
    return _render(env=env, plane=plane, split=split)


@functools.lru_cache(maxsize=None)
def jax_frame(env, plane):
    return jax_render(env=env, plane=plane)


@pytest.mark.parametrize("split", [False, True], ids=["unified", "split"])
@pytest.mark.parametrize("plane", [False, True], ids=["", "plane"])
@pytest.mark.parametrize("env", [False, True], ids=["", "env"])
def test_single_loop_matches_jax(env, plane, split):
    """Env NEE puts the light and env shadow queries in one 2N wave; a
    plane lies outside the BVH; the split tables are the big scenes'
    walk."""
    assert_matches_jax(port_frame(env, plane, split), jax_frame(env, plane))


@pytest.mark.parametrize("plane", [False, True], ids=["", "plane"])
@pytest.mark.parametrize("env", [False, True], ids=["", "env"])
def test_split_tables_render_bit_identical(env, plane):
    img, stats = port_frame(env, plane, True)
    ref_img, ref_stats = port_frame(env, plane, False)
    np.testing.assert_array_equal(img, ref_img)
    np.testing.assert_array_equal(stats, ref_stats)


def _rays(n=3000):
    """Random rays around the open scene: (o, d, max_t, ignored prim)."""
    r = np.random.RandomState(11)
    o = r.uniform(-3.0, 3.0, (3, n)).astype(np.float32)
    o[1] = np.abs(o[1])
    d = r.randn(3, n).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    max_t = np.where(r.rand(n) < 0.2, -1.0,
                     r.uniform(0.5, 20.0, n)).astype(np.float32)
    return (tvec.Vec3(*map(torch.from_numpy, o)),
            tvec.Vec3(*map(torch.from_numpy, d)), torch.from_numpy(max_t),
            torch.from_numpy(r.randint(-1, 4, n)))


def _query(ps, occlusion, rays):
    o, d, max_t, ign = rays
    if occlusion:
        return traverse_wide.intersect_shadow_ray(ps, o, d, max_t, ign)
    return traverse_wide.intersect_scene(ps, o, d, max_t=max_t,
                                         ignored_prim=ign)


def _record_walks(monkeypatch):
    """Patch both walk kernels on ``packet``, as the benchmark's harness
    does (benchmark/harness/trace.py ``walk_calls``): each call is recorded
    as (kernel, rays, occlusion) and passed on."""
    calls = []
    for name in ("wide_traverse", "split_traverse"):
        real = getattr(packet, name)

        def rec(*args, _name=name, _real=real):
            t0, occlusion = args[-3], args[-1]
            calls.append((_name, int(t0.shape[0]), occlusion))
            return _real(*args)
        monkeypatch.setattr(packet, name, rec)
    return calls


@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
@pytest.mark.parametrize("split", [False, True], ids=["unified", "split"])
def test_every_wave_reaches_the_patched_walk(split, occlusion, monkeypatch):
    """A query is one walk call of the scene's kernel; a frame's
    closest-hit and shadow waves are one call each a bounce (NEE without
    an env map), all through the patched attribute."""
    ps = _scene(TScene, tvec, tcm).pack(device="cpu", split=split)
    kernel = "split_traverse" if split else "wide_traverse"
    rays = _rays()
    ref = _query(ps, occlusion, rays)
    calls = _record_walks(monkeypatch)
    out = _query(ps, occlusion, rays)
    assert calls == [(kernel, 3000, occlusion)]
    if occlusion:
        assert torch.equal(out, ref) and 0 < int(out.sum()) < 3000
    else:
        assert torch.equal(out.hit_id, ref.hit_id)
        assert torch.equal(out.t, ref.t)

    del calls[:]
    with trace.frame() as rec:
        port = _render(split=split)
    runs = len(rec.bounces)
    assert runs >= 2
    assert {c[0] for c in calls} == {kernel}
    assert sum(c[2] == occlusion for c in calls) == runs
    assert all(c[1] == N for c in calls)
    np.testing.assert_array_equal(port[0], port_frame(False, False,
                                                      split)[0])


@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
def test_threaded_route_skips_the_walk(occlusion, monkeypatch):
    """``BUAS_TRAVERSAL=threaded`` answers the query through the threaded
    oracle walk: no walk kernel is called, and the answer is the walk's."""
    ps = _scene(TScene, tvec, tcm).pack(device="cpu", threaded=True)
    rays = _rays()
    ref = _query(ps, occlusion, rays)
    calls = _record_walks(monkeypatch)
    monkeypatch.setenv("BUAS_TRAVERSAL", "threaded")
    out = _query(ps, occlusion, rays)
    assert calls == []
    if occlusion:
        assert torch.equal(out, ref)
    else:
        assert torch.equal(out.hit_id, ref.hit_id)
        torch.testing.assert_close(out.t, ref.t, rtol=1e-6, atol=1e-6)


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
