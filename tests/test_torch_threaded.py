"""The threaded skip-link BVH of the PyTorch port (``ops/bvh.py``
``flatten_world_bvh``, ``Scene.pack(threaded=True)``) and its oracle walk
(``ops/traverse.py``) against the JAX package: the ``node_*`` tables and
the triangle soup byte-equal with the native and with the numpy flattener,
the walk's hits equal to the JAX ``intersect_*_threaded`` (its ops run one
by one, ``jax.disable_jit``: jitted, XLA fuses ``a * b + c`` into an FMA,
which moves a near-tangent sphere hit's t past rtol 1e-5) under the tie
rule of tests/test_pallas_packet.py:71-86 and to the port's wide walk, and
a 32x32 frame under ``BUAS_TRAVERSAL=threaded`` within the goldens'
tolerance of the JAX one."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import buas_pathtracer_tpu.native as jnative
import buas_pathtracer_tpu_torch.native as tnative
from buas_pathtracer_tpu.core import vec as jvec
from buas_pathtracer_tpu.ops import traverse as jtr
from buas_pathtracer_tpu.runtime.render import render as jrender
from buas_pathtracer_tpu_torch.core import vec as tvec
from buas_pathtracer_tpu_torch.ops import bvh as tbvh
from buas_pathtracer_tpu_torch.ops import traverse as ttr
from buas_pathtracer_tpu_torch.ops import traverse_wide as ttw
from buas_pathtracer_tpu_torch.runtime.render import render as trender
from test_torch_render import assert_image_close
from test_torch_scene import J, T, scene_mesh, scene_packet, scene_spheres

NODE_VEC3 = ("node_lo", "node_hi", "tri_a", "tri_b", "tri_c", "tri_na",
             "tri_nb", "tri_nc")
NODE_INT = ("node_miss", "node_kind", "node_first", "node_count",
            "node_inst", "tri_has_n")


def scene_flat(Scene, vec, cm, icosphere):
    """Axis-aligned flat quads (zero-extent boxes: the emitter's PAD) as
    mesh instances, a box and a sphere."""
    sc = Scene(name="flat")
    grey = sc.add_diffuse_material((0.6, 0.6, 0.6), 1.2)
    quad = np.array([[[-1, 0, -1], [1, 0, -1], [1, 0, 1]],
                     [[-1, 0, -1], [1, 0, 1], [-1, 0, 1]]], np.float32)
    from buas_pathtracer_tpu_torch.models.mesh import Mesh as TMesh
    from buas_pathtracer_tpu.models.mesh import Mesh as JMesh
    Mesh = TMesh if Scene.__module__.startswith(
        "buas_pathtracer_tpu_torch") else JMesh
    sc.add_mesh(grey, Mesh(triangles=quad.copy()), vec.translate([0, 0, 3]))
    sc.add_mesh(grey, Mesh(triangles=quad.copy()),
                vec.translate([0, 1, 4]) * vec.rotate_x(np.pi / 2))
    sc.add_box(grey, (0.5, 0.0, 0.5), vec.translate([1.5, 0.5, 3]))
    sc.add_sphere(grey, 0.4, vec.translate([-1.5, 0.6, 3]))
    sc.camera = cm.aim_camera_at(
        cm.make_camera(p=(0, 2.0, -2.0), vfov=np.radians(60), aspect=1.0),
        (0, 0.5, 3.0))
    return sc


SCENES = {"spheres": scene_spheres, "mesh": scene_mesh,
          "packet": scene_packet, "flat": scene_flat}


def assert_threaded_equal(jps, tps):
    for name in NODE_VEC3:
        for cj, ct in zip(getattr(jps, name), getattr(tps, name)):
            assert np.asarray(cj).tobytes() == ct.numpy().tobytes(), name
    for name in NODE_INT:
        a, b = np.asarray(getattr(jps, name)), getattr(tps, name).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("flattener", ["native", "numpy"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_threaded_tables_byte_equal(name, flattener, monkeypatch):
    """Both packages' threaded tables, with the native subtree flattener or
    (both made to report no library) the numpy one."""
    if flattener == "numpy":
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "flatten_subtree_native",
                                lambda *a, **k: False)
    else:
        assert tnative.available()
    build = SCENES[name]
    jps, tps = build(*J).pack(), build(*T).pack(device="cpu", threaded=True)
    assert_threaded_equal(jps, tps)
    assert int(tps.node_miss.max()) <= tps.node_miss.shape[0]


def test_native_and_numpy_flatteners_agree(monkeypatch):
    th_native = scene_packet(*T).pack(device="cpu", threaded=True)
    monkeypatch.setattr(tnative, "flatten_subtree_native",
                        lambda *a, **k: False)
    th_numpy = scene_packet(*T).pack(device="cpu", threaded=True)
    for name in NODE_INT + ("node_lo", "node_hi"):
        a, b = getattr(th_native, name), getattr(th_numpy, name)
        for x, y in (zip(a, b) if isinstance(a, tvec.Vec3) else [(a, b)]):
            assert torch.equal(x, y), name


def test_threaded_tables_on_request(monkeypatch):
    """Packed only on request: pack(threaded=True) or BUAS_TRAVERSAL."""
    monkeypatch.delenv("BUAS_TRAVERSAL", raising=False)
    assert scene_spheres(*T).pack(device="cpu").node_miss is None
    monkeypatch.setenv("BUAS_TRAVERSAL", "threaded")
    ps = scene_spheres(*T).pack(device="cpu")
    assert ps.node_miss is not None and ps.node_miss.dtype == torch.int32
    assert scene_spheres(*T).pack(device="cpu",
                                  threaded=False).node_miss is None


def test_empty_scene_threaded():
    em = tbvh._Emitter().finish()
    assert em.lo.shape == (0, 3) and em.miss.shape == (0,)


def _rays(n, seed):
    """Rays from around (0, 1.5, -3) towards the scenes' middle."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.5, (3, n)) + np.array([[0.0], [1.5], [-3.0]])
    d = rng.normal(0, 1.2, (3, n)) + np.array([[0.0], [0.8], [3.0]]) - o
    d /= np.linalg.norm(d, axis=0)
    return o.astype(np.float32), d.astype(np.float32)


def _pair(a):
    return (jvec.Vec3(*(jnp.asarray(c) for c in a)),
            tvec.Vec3(*(torch.from_numpy(c.copy()) for c in a)))


def assert_hits_tied(t_o, p_o, tri_o, t_r, p_r, tri_r):
    """Prim equal, t to rtol 1e-5, and a winning-triangle difference only
    at a shared-edge tie: rare, both triangles real, t equal to rtol."""
    np.testing.assert_array_equal(p_o, p_r)
    np.testing.assert_allclose(t_o, t_r, rtol=1e-5)
    diff = tri_o != tri_r
    if diff.any():
        assert diff.sum() <= max(2, tri_o.size // 1000), diff.sum()
        assert (tri_o[diff] >= 0).all() and (tri_r[diff] >= 0).all()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_threaded_walk_matches_jax(name):
    jps = SCENES[name](*J).pack()
    tps = SCENES[name](*T).pack(device="cpu", threaded=True)
    n = 1500
    (jo, to), (jd, td) = map(_pair, _rays(n, 7))
    with jax.disable_jit():  # XLA would fuse a * b + c into an FMA
        jh = jtr.intersect_scene_threaded(jps, jo, jd)
    th = ttr.intersect_scene_threaded(tps, to, td)
    assert_hits_tied(th.t.numpy(), th.hit_id.numpy(), th.tri.numpy(),
                     np.asarray(jh.t), np.asarray(jh.hit_id),
                     np.asarray(jh.tri))
    assert int(th.node_visits) == int(jh.node_visits)
    assert int(th.tri_tests) == int(jh.tri_tests)
    assert (th.hit_id >= 0).float().mean() > 0.2
    hit = th.hit_id.numpy() >= 0
    np.testing.assert_array_equal(th.mat_id.numpy(), np.asarray(jh.mat_id))
    np.testing.assert_allclose(th.n.stack(0).numpy()[:, hit],
                               np.asarray(jh.n.stack(0))[:, hit], atol=1e-4)
    max_t = torch.full((n,), 4.0)
    ign = torch.full((n,), -1, dtype=torch.int64)
    ign[::3] = 0  # skip primitive 0 on a third of the rays
    jocc = jax.jit(lambda o, d, m, i: jtr.intersect_shadow_ray_threaded(
        jps, o, d, m, i))(jo, jd, jnp.asarray(max_t.numpy()),
                         jnp.asarray(ign.numpy().astype(np.int32)))
    tocc = ttr.intersect_shadow_ray_threaded(tps, to, td, max_t, ign)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(jocc))
    assert 0.0 < tocc.float().mean() < 1.0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_threaded_walk_matches_wide_walk(name, monkeypatch):
    """The oracle against the port's wide walk; BUAS_TRAVERSAL=threaded
    routes ``traverse_wide``'s queries to it."""
    tps = SCENES[name](*T).pack(device="cpu", threaded=True)
    n = 1500
    _, to = _pair(_rays(n, 8)[0])
    _, td = _pair(_rays(n, 8)[1])
    wide = ttw.intersect_scene(tps, to, td)
    monkeypatch.setenv("BUAS_TRAVERSAL", "threaded")
    th = ttw.intersect_scene(tps, to, td)  # through the switch
    np.testing.assert_array_equal(th.hit_id.numpy(), wide.hit_id.numpy())
    np.testing.assert_allclose(th.t.numpy(), wide.t.numpy(), rtol=1e-5)
    hit = (th.hit_id >= 0).numpy()
    np.testing.assert_allclose(th.n.stack(0).numpy()[:, hit],
                               wide.n.stack(0).numpy()[:, hit], atol=1e-4)
    max_t = torch.full((n,), 4.0)
    ign = torch.full((n,), -1, dtype=torch.int64)
    occ = ttw.intersect_shadow_ray(tps, to, td, max_t, ign)
    monkeypatch.delenv("BUAS_TRAVERSAL")
    np.testing.assert_array_equal(
        occ.numpy(), ttw.intersect_shadow_ray(tps, to, td, max_t, ign).numpy())


def test_switch_needs_tables(monkeypatch):
    """No quiet fallback: the switch on a scene without its tables raises."""
    ps = scene_spheres(*T).pack(device="cpu", threaded=False)
    _, o = _pair(_rays(4, 9)[0])
    _, d = _pair(_rays(4, 9)[1])
    monkeypatch.setenv("BUAS_TRAVERSAL", "threaded")
    with pytest.raises(ValueError, match="threaded tables"):
        ttw.intersect_scene(ps, o, d)


def test_frame_threaded_matches_jax(monkeypatch):
    """A 32x32, 4-bounce frame of the mesh golden scene with both packages
    under BUAS_TRAVERSAL=threaded, within the goldens' tolerance and with
    the same rays; the port's frame also against its own wide-walk frame.
    The JAX compile caches are cleared around it, since the variable is
    read at trace time."""
    def build(pkg):
        sc = scene_mesh(*pkg)
        sc.settings = replace(sc.settings, samples_per_pixel=1,
                              max_bounce_count=4)
        return sc
    wide_img, _, wide_st = trender(build(T), 32, 32, frames=1, device="cpu")
    monkeypatch.setenv("BUAS_TRAVERSAL", "threaded")
    jax.clear_caches()
    try:
        ref, _, jst = jrender(build(J), 32, 32, frames=1)
        ref = np.asarray(ref)
    finally:
        jax.clear_caches()
    img, _, tst = trender(build(T), 32, 32, frames=1, device="cpu")
    assert_image_close(img, ref)
    assert float(tst[0]) == float(np.asarray(jst)[0])
    assert_image_close(img, wide_img)
    assert float(tst[0]) == float(wide_st[0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCENES))
def test_threaded_walk_on_card(name):
    """On the card the oracle stays plain PyTorch: its hits equal the wide
    walk kernel's (prim exact, t to rtol 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tps = SCENES[name](*T).pack(device="cuda", threaded=True)
    o, d = (tvec.Vec3(*(torch.from_numpy(c.copy()).cuda() for c in a))
            for a in _rays(4096, 10))
    th = ttr.intersect_scene_threaded(tps, o, d)
    wide = ttw.intersect_scene(tps, o, d)
    assert torch.equal(th.hit_id, wide.hit_id)
    np.testing.assert_allclose(th.t.cpu().numpy(), wide.t.cpu().numpy(),
                               rtol=1e-5)
