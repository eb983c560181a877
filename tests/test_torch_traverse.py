"""Traversal of the PyTorch port against the JAX package's XLA path on the
CPU: ``wide_traverse_plain`` against ``traverse_wide._traverse``, and the
scene queries ``intersect_scene`` / ``intersect_shadow_ray`` against theirs,
on identical tables (``from_jax_arrays``) and identical rays (numpy, seeded).

Hits must agree in prim exactly and in t to rtol 1e-5: XLA's CPU code
reassociates and fuses the slab / Moller-Trumbore arithmetic, so t may
differ in its last bits (the JAX package's own kernel-vs-XLA test,
tests/test_pallas_packet.py:117, uses the same tolerance).  The triangle
index may differ only on exact-t ties, under ``assert_tri_match``'s rule.
On the card the kernel is held to its plain version exactly (gpu tests
below, and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buas_pathtracer_tpu.core import vec as jvec
from buas_pathtracer_tpu.models import camera as jcm
from buas_pathtracer_tpu.models.scene import Scene as JScene
from buas_pathtracer_tpu.ops import traverse_wide as jtw
from buas_pathtracer_tpu.utils.procgen import icosphere as jico
from buas_pathtracer_tpu_torch.core.vec import Vec3 as TV
from buas_pathtracer_tpu_torch.models.scene import from_jax_arrays
from buas_pathtracer_tpu_torch.ops import packet
from buas_pathtracer_tpu_torch.ops import traverse_wide as ttw
from buas_pathtracer_tpu_torch.utils import trace
from test_torch_walk import CARD_EDGES, check_edge_on_card


def assert_tri_match(out, ref, t_rtol=0.0):
    """Copied from tests/test_pallas_packet.py:71-86.  Winning-triangle
    parity, tolerant of exact t-TIES only: a ray that hits a shared mesh
    edge at bit-identical t may record either adjacent triangle depending on
    visit order.  Any tri mismatch must agree on t and on the winning prim,
    and be rare.  ``t_rtol`` (added here) widens "agree on t" for the
    comparison with XLA, whose t differs in its last bits: there a shared-
    edge tie in one implementation is a 1-ulp near-tie in the other."""
    t_o, t_r = np.asarray(out[0]), np.asarray(ref[0])
    tri_o, tri_r = np.asarray(out[2]), np.asarray(ref[2])
    np.testing.assert_array_equal(np.asarray(out[1]), np.asarray(ref[1]))
    diff = tri_o != tri_r
    if diff.any():
        assert diff.sum() <= max(2, tri_o.size // 1000), (
            f"{diff.sum()} tri mismatches of {tri_o.size}")
        np.testing.assert_allclose(t_o[diff], t_r[diff], rtol=t_rtol, atol=0)
        assert (tri_o[diff] >= 0).all() and (tri_r[diff] >= 0).all()


@pytest.fixture(scope="module")
def scenes():
    """The packet-parity scene (tests/test_pallas_packet.py:23-43): two mesh
    instances, an analytic sphere and box, plus a ground plane for the
    plane pass of the scene queries."""
    sc = JScene(name="packet-parity")
    grey = sc.add_diffuse_material((0.6, 0.6, 0.6), 1.2)
    red = sc.add_diffuse_material((0.8, 0.2, 0.2), 1.4)
    glass = sc.add_translucent_material((0.1, 0.05, 0.02), 1.5)
    li = sc.add_emissive_material((10, 10, 10))
    mesh = jico(subdivisions=2)
    sc.add_mesh(grey, mesh, jvec.translate([0, 1.2, 2.5]))
    sc.add_mesh(red, mesh, jvec.translate([-2.2, 1.0, 4.0]) * jvec.scale(0.8))
    sc.add_sphere(glass, 0.9, jvec.translate([2.0, 1.0, 3.0]))
    sc.add_box(grey, (8, 0.5, 8), jvec.translate([0, -0.5, 3.0]))
    sc.add_sphere(li, 0.4, jvec.translate([1.0, 3.5, 1.0]))
    sc.add_plane(red, (0, 1, 0), -0.25)
    sc.camera = jcm.aim_camera_at(
        jcm.make_camera(p=(0, 2.0, -3.0), vfov=np.radians(55), aspect=1.0),
        (0, 1.0, 2.5))
    jps = sc.pack()
    arrays = {k: np.asarray(v) for k, v in jps._asdict().items()
              if v is not None}
    return sc, jps, from_jax_arrays(arrays, "cpu")


def _rays(sc, n, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "coherent":
        side = int(np.sqrt(n))
        ys, xs = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
        z = jnp.zeros(side * side)
        pr = jcm.generate_rays(sc.camera, jnp.asarray(xs.reshape(-1)),
                               jnp.asarray(ys.reshape(-1)), side, side,
                               z + 0.5, z + 0.5, z, z, 0.0, 1.0, 6, 0.0, 0.0)
        o = np.stack([np.asarray(c) for c in pr.o]).astype(np.float32)
        d = np.stack([np.asarray(c) for c in pr.d]).astype(np.float32)
        n = o.shape[1]
    else:
        o = np.stack([rng.uniform(-2, 2, n), rng.uniform(0, 3, n),
                      rng.uniform(0, 4, n)]).astype(np.float32)
        d = rng.normal(size=(3, n)).astype(np.float32)
        d /= np.linalg.norm(d, axis=0)
    t0 = np.full(n, 3.0e38, np.float32)
    if kind == "dead60":
        t0[rng.uniform(size=n) < 0.6] = -1.0
    return o, d, t0


KINDS = [("coherent", 4096), ("incoherent", 2048), ("dead60", 2048)]


def _jv(a):
    return jvec.Vec3(*(jnp.asarray(c) for c in a))


def _tv(a):
    return TV(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
@pytest.mark.parametrize("kind,n", KINDS)
def test_plain_walk_matches_jax(scenes, kind, n, occlusion):
    sc, jps, tps = scenes
    o, d, t0 = _rays(sc, n, kind)
    ign = np.full(t0.shape, -1, np.int32)
    ign[::7] = 2  # some rays ignore the glass sphere
    ref = jtw._traverse(jps, _jv(o), _jv(d), jnp.asarray(t0),
                        jnp.asarray(ign), occlusion=occlusion)
    out = packet.wide_traverse(tps.wide_rows, tps.wide_depth, _tv(o), _tv(d),
                               torch.from_numpy(t0), torch.from_numpy(ign),
                               occlusion)
    assert out[0].dtype == torch.float32 and out[1].dtype == torch.int32
    out = [x.numpy() for x in out[:5]]
    ref = [np.asarray(x) for x in ref[:5]]
    if occlusion:  # any-hit: which hit is found first is walk-order specific
        np.testing.assert_array_equal(out[1] >= 0, ref[1] >= 0)
        return
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-5, atol=1e-5)
    assert_tri_match(out, ref, t_rtol=1e-5)
    # barycentrics of the same mesh triangle (tie rays hold another one's)
    mesh = (ref[2] >= 0) & (out[2] == ref[2])
    np.testing.assert_allclose(out[3][mesh], ref[3][mesh], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out[4][mesh], ref[4][mesh], rtol=1e-4,
                               atol=1e-5)
    dead = t0 < 0
    np.testing.assert_array_equal(out[0][dead], t0[dead])
    assert (out[1][dead] == -1).all() and (out[2][dead] == -1).all()


@pytest.mark.parametrize("kind,n", KINDS)
def test_intersect_scene_matches_jax(scenes, kind, n):
    sc, jps, tps = scenes
    o, d, t0 = _rays(sc, n, kind, seed=1)
    jh = jtw.intersect_scene(jps, _jv(o), _jv(d), max_t=jnp.asarray(t0))
    th = ttw.intersect_scene(tps, _tv(o), _tv(d), max_t=torch.from_numpy(t0))
    np.testing.assert_array_equal(th.hit_id.numpy(), np.asarray(jh.hit_id))
    np.testing.assert_array_equal(th.mat_id.numpy(), np.asarray(jh.mat_id))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-5,
                               atol=1e-5)
    assert_tri_match((th.t.numpy(), th.hit_id.numpy(), th.tri.numpy()),
                     (np.asarray(jh.t), np.asarray(jh.hit_id),
                      np.asarray(jh.tri)), t_rtol=1e-5)
    hit = np.asarray(jh.hit_id) >= 0
    for a, b in zip(th.p, jh.p):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind,n", KINDS)
def test_deferred_normals_match_jax(scenes, kind, n, monkeypatch):
    """The normal and material-id block alone: fed the JAX traversal's own
    (t, prim, tri, bv, bw), normals agree to 1e-5 and material ids exactly.
    (End to end, an analytic sphere's normal inherits the t difference
    above, up to ~5e-5 on grazing hits.)"""
    sc, jps, tps = scenes
    o, d, t0 = _rays(sc, n, kind, seed=1)
    jt = jtw._traverse

    def same_walk(ps, ro, rd, t_in, ign, occlusion):
        out = jt(jps, _jv([x.numpy() for x in ro]),
                 _jv([x.numpy() for x in rd]), jnp.asarray(t_in.numpy()),
                 jnp.asarray(ign.numpy(), jnp.int32), occlusion=occlusion)
        t, prim, tri, bv, bw = (torch.from_numpy(np.array(x)) for x in out[:5])
        return (t, prim.to(torch.int64), tri.to(torch.int64), bv, bw,
                torch.zeros(2, dtype=torch.int64))

    monkeypatch.setattr(ttw, "_traverse", same_walk)
    jh = jtw.intersect_scene(jps, _jv(o), _jv(d), max_t=jnp.asarray(t0))
    th = ttw.intersect_scene(tps, _tv(o), _tv(d), max_t=torch.from_numpy(t0))
    np.testing.assert_array_equal(th.hit_id.numpy(), np.asarray(jh.hit_id))
    np.testing.assert_array_equal(th.mat_id.numpy(), np.asarray(jh.mat_id))
    np.testing.assert_array_equal(th.tri.numpy(), np.asarray(jh.tri))
    hit = np.asarray(jh.hit_id) >= 0
    assert hit.sum() > n // 10
    for a, b in zip(th.n, jh.n):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind,n", KINDS)
def test_shadow_ray_matches_jax(scenes, kind, n):
    sc, jps, tps = scenes
    o, d, t0 = _rays(sc, n, kind, seed=2)
    max_t = np.where(t0 > 0, 6.0, -1.0).astype(np.float32)
    ign = np.full(t0.shape, 4, np.int32)  # the light sphere
    jb = jtw.intersect_shadow_ray(jps, _jv(o), _jv(d), jnp.asarray(max_t),
                                  jnp.asarray(ign))
    tb = ttw.intersect_shadow_ray(tps, _tv(o), _tv(d),
                                  torch.from_numpy(max_t),
                                  torch.from_numpy(ign.astype(np.int64)))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert 0 < tb.numpy().mean() < 1


@pytest.mark.parametrize("kind", ["coherent", "incoherent"])
def test_v1_kernel_matches_plain_walk(scenes, kind, monkeypatch):
    """K7, the JAX package's v1 lockstep kernel (``BUAS_PACKET_V1=1``, run
    in interpret mode on 256 rays), computes ``wide_traverse``'s function:
    the port's plain walk finds its hits under the XLA rule above."""
    from buas_pathtracer_tpu.ops import pallas_packet as jpp
    monkeypatch.setenv("BUAS_PACKET_V1", "1")
    sc, jps, tps = scenes
    o, d, t0 = _rays(sc, 256, kind, seed=4)
    ign = np.full(t0.shape, -1, np.int32)
    ref = jpp.packet_traverse(jps.wide_rows, _jv(o), _jv(d), jnp.asarray(t0),
                              jnp.asarray(ign), occlusion=False,
                              interpret=True)
    out = packet.wide_traverse(tps.wide_rows, tps.wide_depth, _tv(o), _tv(d),
                               torch.from_numpy(t0), torch.from_numpy(ign),
                               False)
    out = [x.numpy() for x in out[:5]]
    ref = [np.asarray(x) for x in ref[:5]]
    assert (ref[1] >= 0).mean() > 0.3
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-5, atol=1e-5)
    assert_tri_match(out, ref, t_rtol=1e-5)


def test_stack_bound_enforced(scenes):
    _, _, tps = scenes
    o, d, t0 = _rays(None, 16, "incoherent")
    assert packet.stack_fits(tps.wide_depth)
    with pytest.raises(ValueError, match="stack"):
        packet.wide_traverse(tps.wide_rows, 40, _tv(o), _tv(d),
                             torch.from_numpy(t0),
                             torch.full((16,), -1, dtype=torch.int32), False)


def test_wrapper_checks_inputs(scenes):
    _, _, tps = scenes
    o, d, t0 = _rays(None, 16, "incoherent")
    ign = torch.full((16,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="ign"):
        packet.wide_traverse(tps.wide_rows, tps.wide_depth, _tv(o), _tv(d),
                             torch.from_numpy(t0), ign.to(torch.int64), False)
    with pytest.raises(ValueError, match="contiguous"):
        packet.wide_traverse(tps.wide_rows, tps.wide_depth, _tv(o),
                             TV(*(torch.from_numpy(np.repeat(c, 2))[::2]
                                  for c in d)),
                             torch.from_numpy(t0), ign, False)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
@pytest.mark.parametrize("kind,n", KINDS)
def test_kernel_matches_plain_on_card(scenes, card, kind, n, occlusion):
    sc, _, tps = scenes
    o, d, t0 = _rays(sc, n, kind, seed=3)
    rows = tps.wide_rows.to(card)
    args = (TV(*(c.to(card) for c in _tv(o))), TV(*(c.to(card) for c in _tv(d))),
            torch.from_numpy(t0).to(card),
            torch.full((t0.size,), -1, dtype=torch.int32, device=card))
    key = "occlusion" if occlusion else "closest"
    before = trace.launch_totals()[key]
    out = packet.wide_traverse(rows, tps.wide_depth, *args, occlusion)
    ref = packet.wide_traverse_plain(rows, tps.wide_depth, *args, occlusion)
    assert trace.launch_totals()[key] == before + 1
    for a, b in zip(out[:5], ref[:5]):
        assert torch.equal(a.cpu(), b.cpu().to(a.dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
@pytest.mark.parametrize("edge", CARD_EDGES)
def test_kernel_fetch_edges_on_card(card, edge, occlusion):
    """The persistent fetch loop's edges (tests/test_torch_walk.py):
    kernel and plain version equal, stats included."""
    check_edge_on_card(edge, False, occlusion, card)
