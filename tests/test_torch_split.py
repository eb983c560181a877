"""The big-scene path of the PyTorch port against the JAX package on the CPU:
the split tables (``split_for_dma``) byte-equal to the JAX ``Scene.pack()``'s
with ``BUAS_V4=1``, ``split_traverse_plain`` against the JAX XLA walk and
against the port's unified walk, ``from_jax_arrays`` with the split fields,
a render through the split walk against the golden image, and the stress
scene against ``bench.py``'s.  Small scenes are forced to split: the JAX side
through ``BUAS_V4=1``, the port through ``pack(split=True)``.

Tolerances: against the JAX XLA walk, prim exactly and t to rtol 1e-5 (XLA
fuses the slab and Moller-Trumbore arithmetic; tests/test_pallas_packet.py
asks the same of its split-table kernel), tri under ``assert_tri_match``.
Against the port's unified walk, which does the same arithmetic, prim and t
exactly; tri may differ on exact-t ties only, because merged leaves test
their triangles in another order.  Occlusion is any-hit: only hit / no hit
is compared."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buas_pathtracer_tpu.core import vec as jvec
from buas_pathtracer_tpu.models import camera as jcm
from buas_pathtracer_tpu.models.scene import Scene as JScene
from buas_pathtracer_tpu.ops import traverse_wide as jtw
from buas_pathtracer_tpu.utils.procgen import icosphere as jico
from buas_pathtracer_tpu_torch.core import vec as tvec
from buas_pathtracer_tpu_torch.core.vec import Vec3 as TV
from buas_pathtracer_tpu_torch.models import camera as tcm
from buas_pathtracer_tpu_torch.models.scene import Scene as TScene
from buas_pathtracer_tpu_torch.models.scene import SceneSettings as TSettings
from buas_pathtracer_tpu_torch.models.scene import from_jax_arrays
from buas_pathtracer_tpu_torch.models.scenes import build_stress_scene
from buas_pathtracer_tpu_torch.ops import packet, wide_bvh
from buas_pathtracer_tpu_torch.runtime.render import render as trender
from buas_pathtracer_tpu_torch.utils import trace
from buas_pathtracer_tpu_torch.utils.procgen import icosphere as tico
from test_torch_render import GOLDEN_DIR, assert_image_close
from test_torch_scene import scene_mesh
from test_torch_traverse import assert_tri_match
from test_torch_walk import CARD_EDGES, check_edge_on_card

J = (JScene, jvec, jcm, jico)
T = (TScene, tvec, tcm, tico)


def scene_packet(Scene, vec, cm, icosphere):
    """tests/test_pallas_packet.py:23-43: two mesh instances, an analytic
    sphere and box."""
    sc = Scene(name="packet-parity")
    grey = sc.add_diffuse_material((0.6, 0.6, 0.6), 1.2)
    red = sc.add_diffuse_material((0.8, 0.2, 0.2), 1.4)
    glass = sc.add_translucent_material((0.1, 0.05, 0.02), 1.5)
    mesh = icosphere(subdivisions=2)
    sc.add_mesh(grey, mesh, vec.translate([0, 1.2, 2.5]))
    sc.add_mesh(red, mesh, vec.translate([-2.2, 1.0, 4.0]) * vec.scale(0.8))
    sc.add_sphere(glass, 0.9, vec.translate([2.0, 1.0, 3.0]))
    sc.add_box(grey, (8, 0.5, 8), vec.translate([0, -0.5, 3.0]))
    sc.camera = cm.aim_camera_at(
        cm.make_camera(p=(0, 2.0, -3.0), vfov=np.radians(55), aspect=1.0),
        (0, 1.0, 2.5))
    return sc


SCENES = {"packet": scene_packet, "mesh": scene_mesh}


@pytest.fixture(scope="module")
def packed():
    """Per scene: the JAX scene, its split pack, the port's split pack."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BUAS_V4", "1")
        for name, build in SCENES.items():
            jsc = build(*J)
            jps = jsc.pack()
            tps = build(*T).pack(device="cpu", split=True)
            out[name] = (jsc, jps, tps)
    return out


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_split_tables_byte_equal(packed, name):
    _, jps, tps = packed[name]
    assert jps.v4_res is not None and tps.v4_res is not None
    for field in ("wide_rows", "v4_res", "v4_leaf"):
        a, b = _as_np(getattr(tps, field)), _as_np(getattr(jps, field))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), field
    # the merge really ran: fewer leaf rows than unified leaves
    rows = _as_np(tps.wide_rows)
    assert tps.v4_leaf.shape[0] < int((rows[:, 0] == wide_bvh.KIND_TRIS).sum())


def test_split_chosen_by_limit(monkeypatch):
    sc = scene_packet(*T)
    assert sc.pack(device="cpu").v4_res is None  # 100 kB < the 50 MB limit
    monkeypatch.setattr(packet, "RESIDENT_TABLE_LIMIT_BYTES", 1000)
    ps = sc.pack(device="cpu")
    assert ps.v4_res is not None and ps.v4_leaf.shape[1] == 128
    assert scene_packet(*T).pack(device="cpu", split=False).v4_res is None


def test_from_jax_arrays_round_trips_split(packed):
    _, jps, _ = packed["packet"]
    arrays = {k: np.asarray(v) for k, v in jps._asdict().items()
              if v is not None}
    ps = from_jax_arrays(arrays, "cpu")
    for field in ("v4_res", "v4_leaf"):
        assert np.array_equal(getattr(ps, field).numpy().view(np.uint32),
                              arrays[field].view(np.uint32))
    del arrays["v4_res"], arrays["v4_leaf"]
    ps = from_jax_arrays(arrays, "cpu")
    assert ps.v4_res is None and ps.v4_leaf is None


def _rays(sc, n, kind, seed):
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
    ign = np.full(n, -1, np.int32)
    ign[::7] = 2  # some rays ignore the glass sphere
    return o, d, t0, ign


KINDS = [("coherent", 1024), ("incoherent", 1024), ("dead60", 1024)]


def _tv(a):
    return TV(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _walks(packed, kind, n, occlusion, seed=21):
    sc, jps, tps = packed["packet"]
    o, d, t0, ign = _rays(sc, n, kind, seed)
    if occlusion:
        t0 = np.where(t0 > 0, 6.0, t0).astype(np.float32)
    args = (_tv(o), _tv(d), torch.from_numpy(t0), torch.from_numpy(ign),
            occlusion)
    split = packet.split_traverse(tps.v4_res, tps.v4_leaf, tps.wide_depth,
                                  *args)
    return (o, d, t0, ign), [x.numpy() for x in split], tps, args


@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
@pytest.mark.parametrize("kind,n", KINDS)
def test_split_walk_matches_jax(packed, kind, n, occlusion):
    (o, d, t0, ign), out, _, _ = _walks(packed, kind, n, occlusion)
    _, jps, _ = packed["packet"]
    ref = jtw._traverse(jps, jvec.Vec3(*map(jnp.asarray, o)),
                        jvec.Vec3(*map(jnp.asarray, d)), jnp.asarray(t0),
                        jnp.asarray(ign), occlusion=occlusion)
    ref = [np.asarray(x) for x in ref[:5]]
    assert out[0].dtype == np.float32 and out[1].dtype == np.int32
    if occlusion:
        np.testing.assert_array_equal(out[1] >= 0, ref[1] >= 0)
        assert 0 < (ref[1] >= 0).mean() < 1
        return
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-5, atol=1e-5)
    assert_tri_match(out, ref, t_rtol=1e-5)
    mesh = (ref[2] >= 0) & (out[2] == ref[2])
    assert mesh.sum() > n // 20
    np.testing.assert_allclose(out[3][mesh], ref[3][mesh], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out[4][mesh], ref[4][mesh], rtol=1e-4,
                               atol=1e-5)
    dead = t0 < 0
    np.testing.assert_array_equal(out[0][dead], t0[dead])
    assert (out[1][dead] == -1).all() and (out[2][dead] == -1).all()


@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
@pytest.mark.parametrize("kind,n", KINDS)
def test_split_walk_matches_unified_walk(packed, kind, n, occlusion):
    _, out, tps, args = _walks(packed, kind, n, occlusion, seed=22)
    ref = [x.numpy() for x in packet.wide_traverse_plain(
        tps.wide_rows, tps.wide_depth, *args)]
    if occlusion:
        np.testing.assert_array_equal(out[1] >= 0, ref[1] >= 0)
        return
    np.testing.assert_array_equal(out[0], ref[0])
    assert_tri_match(out, ref)


def test_split_walk_counts_leaf_reads(packed):
    _, _, tps = packed["packet"]
    o, d, t0, ign = _rays(None, 512, "incoherent", 3)
    reads = torch.zeros(tps.v4_leaf.shape[0], dtype=torch.int64)
    out = packet.split_traverse_plain(
        tps.v4_res, tps.v4_leaf, tps.wide_depth, _tv(o), _tv(d),
        torch.from_numpy(t0), torch.from_numpy(ign), False, leaf_reads=reads)
    hit_leaf = set()
    tri = out[2].numpy()
    leaf = tps.v4_leaf.numpy()
    for tr in tri[tri >= 0]:  # the leaf row holding each winning triangle
        base, cnt = leaf[:, 2], leaf[:, 1]
        hit_leaf |= set(np.nonzero((base <= tr) & (tr < base + cnt))[0])
    assert hit_leaf and hit_leaf <= set(np.nonzero(reads.numpy())[0])
    # every read is a row visit; the resident rows make up the rest
    assert 0 < int(reads.sum()) < int(out[5][0])


@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
def test_split_walk_leaf_counts_match_its_pops(packed, monkeypatch,
                                               occlusion):
    """The plain split walk's leaf-row fetches (the sum of its reads) and
    distinct leaf rows (the rows read at all) equal a brute count of the
    leaf links its own walk popped; ``WalkCounts`` keeps them as the
    counted kernel does."""
    popped = []
    pop = packet._Walk.pop

    def spy(self):
        got = pop(self)
        if got is not None:
            popped.extend(got[1].tolist())
        return got

    monkeypatch.setattr(packet._Walk, "pop", spy)
    _, _, tps = packed["packet"]
    o, d, t0, ign = _rays(None, 512, "dead60", 7)
    if occlusion:
        t0 = np.where(t0 > 0, 6.0, t0).astype(np.float32)
    rows = tps.v4_leaf.shape[0]
    reads = torch.zeros(rows, dtype=torch.int64)
    packet.split_traverse_plain(
        tps.v4_res, tps.v4_leaf, tps.wide_depth, _tv(o), _tv(d),
        torch.from_numpy(t0), torch.from_numpy(ign), occlusion,
        leaf_reads=reads)
    leaf = [-link - 1 for link in popped if link < 0]
    assert int(reads.sum()) == len(leaf) > 0
    assert int((reads > 0).sum()) == len(set(leaf)) < rows
    assert np.array_equal(reads.numpy(), np.bincount(leaf, minlength=rows))
    counts = packet.WalkCounts(rows, "cpu")
    counts.mark(int((t0 >= 0).sum()), reads)
    assert counts.read() == (int((t0 >= 0).sum()), len(leaf), len(set(leaf)))
    bits = np.unpackbits(counts.leaf_bits.numpy().view(np.uint8),
                         bitorder="little")
    assert sorted(np.nonzero(bits)[0].tolist()) == sorted(set(leaf))


def test_split_wrapper_checks_inputs(packed):
    _, _, tps = packed["packet"]
    o, d, t0, ign = _rays(None, 16, "incoherent", 4)
    args = (_tv(o), _tv(d), torch.from_numpy(t0), torch.from_numpy(ign),
            False)
    with pytest.raises(ValueError, match="leaf"):
        packet.split_traverse(tps.v4_res, tps.wide_rows, tps.wide_depth,
                              *args)
    with pytest.raises(ValueError, match="stack"):
        packet.split_traverse(tps.v4_res, tps.v4_leaf, 40, *args)


def test_forced_split_render_matches_golden(monkeypatch):
    """The port's render of the golden mesh scene through the split walk
    (every table split: limit 0) against tests/goldens/mesh_advanced.npz,
    under test_torch_render.py's tolerance."""
    monkeypatch.setattr(packet, "RESIDENT_TABLE_LIMIT_BYTES", 0)
    calls = {"split": 0, "wide": 0}
    real_split, real_wide = packet.split_traverse, packet.wide_traverse

    def split(*a):
        calls["split"] += 1
        return real_split(*a)

    def wide(*a):
        calls["wide"] += 1
        return real_wide(*a)

    monkeypatch.setattr(packet, "split_traverse", split)
    monkeypatch.setattr(packet, "wide_traverse", wide)
    sc = scene_mesh(*T)
    sc.settings = TSettings(samples_per_pixel=1, max_bounce_count=4)
    img, _, _ = trender(sc, 32, 32, frames=8, device="cpu")
    golden = np.load(os.path.join(GOLDEN_DIR, "mesh_advanced.npz"))["hdr"]
    assert_image_close(img, golden)
    assert calls["split"] > 0 and calls["wide"] == 0


def test_stress_scene_matches_bench():
    """build_stress_scene is bench.py's stress scene: the same prims,
    transforms, materials, mesh, camera and settings (not packed here)."""
    import bench
    ref = bench.build_stress_scene(1920, 1080)
    sc = build_stress_scene(1920, 1080)
    assert len(sc.prims) == len(ref.prims) == 4
    for p, q in zip(sc.prims, ref.prims):
        assert p["type"] == q["type"] and p["mat"] == q["mat"]
        np.testing.assert_array_equal(p["fwd"], q["fwd"])
        np.testing.assert_array_equal(p["inv"], q["inv"])
        for k in ("r", "box_r", "mesh_id"):
            assert (k in p) == (k in q)
            if k in p:
                np.testing.assert_array_equal(p[k], q[k])
    assert sc.lights == ref.lights
    for m, r in zip(sc.materials, ref.materials):
        for k in ("albedo", "emission_color", "ior", "flags", "absorb"):
            np.testing.assert_array_equal(getattr(m, k), getattr(r, k))
    assert len(sc.meshes) == len(ref.meshes) == 2
    assert sc.meshes[0].triangles.shape == (327680, 3, 3)
    np.testing.assert_array_equal(np.asarray(sc.meshes[0].triangles),
                                  np.asarray(ref.meshes[0].triangles))
    for k in sc.camera._fields:
        a, r = getattr(sc.camera, k), getattr(ref.camera, k)
        np.testing.assert_allclose(np.asarray(a, np.float64).reshape(-1),
                                   np.asarray(r, np.float64).reshape(-1),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert sc.settings.max_bounce_count == ref.settings.max_bounce_count == 6
    assert sc.settings.integrator == ref.settings.integrator


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
@pytest.mark.parametrize("kind,n", KINDS)
def test_split_kernel_matches_plain_on_card(packed, card, kind, n,
                                            occlusion):
    _, _, tps = packed["packet"]
    o, d, t0, ign = _rays(packed["packet"][0], n, kind, 5)
    res, leaf = tps.v4_res.to(card), tps.v4_leaf.to(card)
    args = (TV(*(c.to(card) for c in _tv(o))),
            TV(*(c.to(card) for c in _tv(d))),
            torch.from_numpy(t0).to(card), torch.from_numpy(ign).to(card),
            occlusion)
    key = "split_occlusion" if occlusion else "split_closest"
    before = trace.launch_totals()[key]
    out = packet.split_traverse(res, leaf, tps.wide_depth, *args)
    ref = packet.split_traverse_plain(res, leaf, tps.wide_depth, *args)
    assert trace.launch_totals()[key] == before + 1
    for a, b in zip(out, ref):
        assert torch.equal(a.cpu(), b.cpu().to(a.dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
@pytest.mark.parametrize("kind,n", KINDS)
def test_split_kernel_counts_match_plain_on_card(packed, card, kind, n,
                                                 occlusion):
    """The counted split walk on the card: the plain version's outputs and
    stats, and in its ``WalkCounts`` its live rays, its leaf-row fetches
    and the bitmap of the leaf rows the plain walk read on the same rays,
    bit for bit."""
    _, _, tps = packed["packet"]
    o, d, t0, ign = _rays(packed["packet"][0], n, kind, 6)
    res, leaf = tps.v4_res.to(card), tps.v4_leaf.to(card)
    args = (TV(*(c.to(card) for c in _tv(o))),
            TV(*(c.to(card) for c in _tv(d))),
            torch.from_numpy(t0).to(card), torch.from_numpy(ign).to(card),
            occlusion)
    counts = packet.WalkCounts(leaf.shape[0], card)
    key = "split_occlusion" if occlusion else "split_closest"
    out = packet._launch("split_traverse", key, [res, leaf], *args,
                         counted=counts)
    reads = torch.zeros(leaf.shape[0], dtype=torch.int64, device=card)
    ref = packet.split_traverse_plain(res, leaf, tps.wide_depth, *args,
                                      leaf_reads=reads)
    for a, b in zip(out, ref):
        assert torch.equal(a.cpu(), b.cpu().to(a.dtype))
    host = packet.WalkCounts(leaf.shape[0], "cpu")
    host.mark(int((t0 >= 0).sum()), reads.cpu())
    assert counts.read() == host.read()
    assert torch.equal(counts.leaf_bits.cpu(), host.leaf_bits)
    assert int(reads.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
@pytest.mark.parametrize("edge", CARD_EDGES)
def test_split_kernel_fetch_edges_on_card(card, edge, occlusion):
    """The persistent fetch loop's edges (tests/test_torch_walk.py):
    kernel and plain version equal, stats included."""
    check_edge_on_card(edge, True, occlusion, card)
