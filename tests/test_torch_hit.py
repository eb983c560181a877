"""The closest-hit query's hit record (``csrc/hit.cu``,
``ops/hit_kernel.py``) against its plain version (``hit_record_plain``).

On the card the kernel must equal the plain version bit for bit on every
field of every lane (hit id, material id, triangle, t, barycentrics, point,
stats), and on the normal of every lane that hit something; a lane that hit
nothing gets the normal (0, 0, 0).  That holds on full-size waves of the
bench, Week 7 Nicer and stress frames (bounces 0 and 1), and a whole bench
frame is identical through the kernel and through the plain version.  The
caller's rays and limits are left as they were.

Here on the CPU: CPU tensors take the plain path; the wrapper's checks;
the row offsets and the argument struct that ``csrc/hit.cuh`` hard-codes;
and the lane logic itself, compiled with g++ (``tests/hit_host/``) and held
to the plain version bit for bit on a smooth and a flat mesh, a scaled
sphere and a scaled box instance, planes that win, misses, dead lanes, an
ignored primitive, and the unified and the split tables.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from buas_pathtracer_tpu_torch.core import vec
from buas_pathtracer_tpu_torch.core.vec import Vec3
from buas_pathtracer_tpu_torch.models import scene as scene_mod
from buas_pathtracer_tpu_torch.models.mesh import Mesh
from buas_pathtracer_tpu_torch.models.scene import Scene
from buas_pathtracer_tpu_torch.ops import cuda_lib, hit_kernel, traverse
from buas_pathtracer_tpu_torch.ops import traverse_wide
from buas_pathtracer_tpu_torch.utils import trace
from buas_pathtracer_tpu_torch.utils.procgen import icosphere

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "buas_pathtracer_tpu_torch",
                    "csrc")
N = 2048  # rays a case
EYE = (0.0, 2.5, -3.0)
# the objects of hit_scene: centre and radius to aim at
TARGETS = {"smooth_mesh": ((-2.5, 1.2, 3.0), 1.0),
           "flat_mesh": ((0.0, 1.0, 4.5), 0.8),
           "sphere": ((2.5, 1.0, 3.0), 0.6),
           "box": ((0.0, 0.8, 1.5), 0.4)}


def hit_scene(split: bool = False):
    """A smooth-normal mesh, the same mesh without vertex normals (flat),
    a sphere and a box rotated under non-uniform scales, a ground plane
    and a wall on the left.  Returns (packed scene on the CPU, {object:
    prim id})."""
    sc = Scene(name="hit")
    grey = sc.add_diffuse_material((0.6, 0.6, 0.6), 1.2)
    red = sc.add_diffuse_material((0.8, 0.2, 0.2), 1.4)
    blue = sc.add_diffuse_material((0.2, 0.3, 0.8), 1.3)
    green = sc.add_diffuse_material((0.2, 0.7, 0.3), 1.1)
    ico = icosphere(subdivisions=2)
    ids = {}
    ids["smooth_mesh"] = sc.add_mesh(
        grey, ico, vec.translate([-2.5, 1.2, 3.0]) * vec.scale(1.1))
    flat = Mesh(triangles=icosphere(subdivisions=2).triangles.copy())
    ids["flat_mesh"] = sc.add_mesh(
        red, flat, vec.translate([0.0, 1.0, 4.5]) * vec.rotate_y(0.4)
        * vec.scale(0.9))
    ids["sphere"] = sc.add_sphere(
        blue, 0.8, vec.translate([2.5, 1.0, 3.0]) * vec.rotate_z(0.5)
        * vec.rotate_x(0.3) * vec.scale([1.5, 0.7, 1.0]))
    ids["box"] = sc.add_box(
        green, (0.5, 0.6, 0.4), vec.translate([0.0, 0.8, 1.5])
        * vec.rotate_y(0.3) * vec.rotate_x(0.25) * vec.scale([1.4, 0.8, 1.1]))
    sc.add_plane(grey, (0, 1, 0), 0.0)
    sc.add_plane(blue, (1, 0, 0), -7.0)
    ps = sc.pack(device="cpu", split=split)
    assert (ps.v4_res is not None) == split
    return ps, ids


def _v(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(c, np.float32))
                  for c in a))


def case_rays(case, seed=0):
    """(o, d, max_t, ignored prim) of ``N`` rays for one case."""
    rng = np.random.default_rng(seed)
    o = np.array(EYE, np.float32)[:, None] + rng.uniform(
        -0.3, 0.3, (3, N)).astype(np.float32)
    max_t = np.full(N, traverse.BIG_T, np.float32)
    ign = np.full(N, -1, np.int64)
    if case in TARGETS or case == "ignored":
        c, r = TARGETS["sphere" if case == "ignored" else case]
        aim = np.array(c, np.float32)[:, None] + rng.uniform(
            -r, r, (3, N)).astype(np.float32)
    elif case == "plane":  # the ground in front of everything, the wall
        ground = np.stack([rng.uniform(-6, 6, N), np.zeros(N),
                           rng.uniform(-1.5, 0.5, N)])
        wall = np.stack([np.full(N, -7.0), rng.uniform(0.5, 4, N),
                         rng.uniform(0, 8, N)])
        aim = np.where(np.arange(N) % 3 == 0, wall, ground)
    elif case == "miss":  # up into the sky, a few hits beside
        aim = o + np.stack([rng.uniform(-1, 1, N), rng.uniform(0.5, 2, N),
                            rng.uniform(-1, -0.2, N)])
        aim[:, ::8] = np.array(TARGETS["sphere"][0])[:, None]
    else:  # the whole view: dead, wide, split
        aim = np.stack([rng.uniform(-5, 5, N), rng.uniform(-0.5, 3, N),
                        rng.uniform(1, 9, N)])
    d = aim - o
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    if case == "dead":
        max_t[rng.uniform(size=N) < 0.6] = -1.0
    return _v(o), _v(d), torch.from_numpy(max_t), torch.from_numpy(ign)


def walked(ps, o, d, max_t, ign):
    """The record's inputs, as ``intersect_scene`` makes them: the plane
    pass's winner and the walk's outputs (prim, tri int32)."""
    t_pl, plane_idx = traverse._intersect_planes(ps, o, d, max_t)
    return plane_idx, traverse_wide._walk(ps, o, d, t_pl, ign,
                                          occlusion=False)


def plain_record(ps, o, d, plane_idx, t, prim, tri, bv, bw, stats):
    return hit_kernel.hit_record_plain(ps, o, d, plane_idx, t,
                                       prim.to(torch.int64),
                                       tri.to(torch.int64), bv, bw, stats)


def _bits(x):
    return x.contiguous().view(torch.int32)


def assert_records_equal(plain, kern, what):
    """Every field bit for bit; the normal where the plain record hit
    something, and (0, 0, 0) elsewhere in the kernel's."""
    for name in ("hit_id", "mat_id", "tri"):
        a, b = getattr(plain, name), getattr(kern, name)
        assert a.dtype == b.dtype == torch.int64, f"{what}: {name} dtype"
        if not torch.equal(a, b):
            pytest.fail(f"{what}: {name} differs in {int((a != b).sum())} "
                        f"lanes")
    for name in ("t", "bary_v", "bary_w"):  # the walk's own tensors
        assert getattr(kern, name) is getattr(plain, name), name
    for name in ("node_visits", "tri_tests"):
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    hit = plain.hit_id >= 0
    for c, a, b in zip("xyz", plain.p, kern.p):
        if not torch.equal(_bits(a), _bits(b)):
            pytest.fail(f"{what}: p.{c} differs in "
                        f"{int((_bits(a) != _bits(b)).sum())} lanes")
    for c, a, b in zip("xyz", plain.n, kern.n):
        ba, bb = _bits(a)[hit], _bits(b)[hit]
        if not torch.equal(ba, bb):
            pytest.fail(f"{what}: n.{c} differs in {int((ba != bb).sum())} "
                        f"of {int(hit.sum())} hit lanes")
        assert bool((_bits(b)[~hit] == 0).all()), f"{what}: n.{c} of misses"


# ---------------------------------------------------------------------------
# CPU: the plain path, the wrapper's checks, the source's layout
# ---------------------------------------------------------------------------

def _no_library(monkeypatch):
    def load():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(cuda_lib, "load", load)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """``intersect_scene`` on CPU tensors builds the plain record: no
    kernel launch is counted and the kernel library is never asked for."""
    _no_library(monkeypatch)
    ps, _ = hit_scene()
    o, d, max_t, ign = case_rays("wide")
    before = trace.launch_totals()["hit_record"]
    h = traverse_wide.intersect_scene(ps, o, d, max_t=max_t)
    assert trace.launch_totals()["hit_record"] == before
    plane_idx, w = walked(ps, o, d, max_t, ign)
    ref = plain_record(ps, o, d, plane_idx, *w)
    for name in ("hit_id", "mat_id", "tri", "t"):
        assert torch.equal(getattr(h, name), getattr(ref, name))
    for a, b in zip((*h.p, *h.n), (*ref.p, *ref.n)):
        assert torch.equal(a, b)


def _bad(edit):
    ps, _ = hit_scene()
    o, d, max_t, ign = case_rays("wide")
    plane_idx, (t, prim, tri, bv, bw, stats) = walked(ps, o, d, max_t, ign)
    if edit == "dtype":
        t = t.double()
    elif edit == "prim":
        prim = prim.to(torch.int64)
    elif edit == "shape":
        o = Vec3(o.x[:-1], o.y, o.z)
    elif edit == "stride":
        bv = torch.zeros(2 * N)[::2]
    elif edit == "plane_idx":
        plane_idx = plane_idx.to(torch.int32)
    elif edit == "table":
        ps = ps._replace(prim_nrm16=ps.prim_nrm16[:, :12])
    return ps, o, d, plane_idx, t, prim, tri, bv, bw, stats


@pytest.mark.parametrize("edit,match", [
    ("dtype", "t must be"), ("prim", "prim must be"), ("shape", "o.x must be"),
    ("stride", "bv must be"), ("plane_idx", "plane_idx must be"),
    ("table", "prim_nrm16 must be"), ("device", "no hit_record for device")])
def test_wrapper_rejects_bad_inputs(edit, match, monkeypatch):
    """Wrong dtypes, shapes, strides and tables raise before the kernel
    library is asked for; valid CPU tensors reach the device check."""
    _no_library(monkeypatch)
    with pytest.raises(ValueError, match=match):
        hit_kernel.hit_record(*_bad(edit))


def _struct_fields(src):
    body = re.search(r"struct Args \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        names = decl.split(",")
        names[0] = names[0].split()[-1]
        for name in names:
            m = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", name.strip().lstrip("*"))
            out.append((m.group(1), int(m.group(2) or 1)))
    return out


def test_csrc_layout_matches_the_tables():
    """The row offsets csrc/hit.cuh hard-codes follow models/scene.py's
    prim_nrm16 and wtri_nrm16 rows and PRIM_SPHERE; its ``hit::Args`` is
    ``HitArgs`` field for field."""
    src = open(os.path.join(CSRC, "hit.cuh")).read()
    k = {name: int(v) for name, v in re.findall(
        r"constexpr (?:int|int64_t) (\w+) = (-?\d+);", src)}
    sc = Scene(name="layout")
    m = sc.add_diffuse_material((0.5, 0.5, 0.5), 1.0)
    sc.add_box(m, (0.25, 0.5, 2.0), vec.scale(2.0))
    sc.add_sphere(m, 1.0, vec.translate([5.0, 0.0, 0.0]))
    tri = np.array([[[0, 0, 9], [1, 0, 9], [0, 1, 9]]], np.float32)
    nrm = np.array([[[0.1, 0.2, 0.3], [0.4, 0.5, 0.6], [0.7, 0.8, 0.9]]],
                   np.float32)
    sc.add_mesh(m, Mesh(triangles=tri, normals=nrm))
    ps = sc.pack(device="cpu")
    box, sph = ps.prim_nrm16[0].tolist(), ps.prim_nrm16[1].tolist()
    assert k["ROW"] == ps.prim_nrm16.shape[1] == ps.wtri_nrm16.shape[1] == 16
    assert box[k["PRIM_BOX_R"]:k["PRIM_BOX_R"] + 3] == [0.25, 0.5, 2.0]
    assert box[0] == 0.5 and sph[3] == -5.0  # the inverse, row-major
    assert (box[k["PRIM_TYPE"]], sph[k["PRIM_TYPE"]]) == (
        scene_mod.PRIM_BOX, scene_mod.PRIM_SPHERE)
    assert k["PRIM_SPHERE"] == scene_mod.PRIM_SPHERE
    rows = ps.wtri_nrm16[ps.wtri_nrm16[:, k["TRI_HAS_N"]] > 0.5]
    assert rows.shape[0] == 1
    r = rows[0].numpy()
    unit = nrm[0] / np.linalg.norm(nrm[0], axis=1, keepdims=True)
    for key, want in (("TRI_NA", unit[0]), ("TRI_NB", unit[1]),
                      ("TRI_NC", unit[2]), ("TRI_NG", (0.0, 0.0, 1.0))):
        np.testing.assert_allclose(r[k[key]:k[key] + 3], want, atol=1e-6,
                                   err_msg=key)
    want = [(name, ctypes.sizeof(t) // 8)
            for name, t in hit_kernel.HitArgs._fields_]
    assert _struct_fields(src) == want


def test_trace_counts_hit_record():
    """``hit_record`` is one of the tracer's kernels, and a frame record
    counts its launches (on the card: one a closest-hit query)."""
    assert "hit_record" in trace.KERNELS
    with trace.frame() as rec:
        trace.launch("hit_record")
    assert rec.launches == {"hit_record": 1}


# ---------------------------------------------------------------------------
# CPU: the lane logic, compiled with g++, against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the lane logic on the host")
    so = str(tmp_path_factory.mktemp("hit_host") / "hit_host.so")
    build = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-o", so, os.path.join(HERE, "hit_host", "hit_host.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    assert build.returncode == 0, build.stdout.decode(errors="replace")
    lib = ctypes.CDLL(so)
    assert lib.hit_args_size() == ctypes.sizeof(hit_kernel.HitArgs)
    return lib


@pytest.fixture(scope="module")
def scenes():
    return {False: hit_scene(), True: hit_scene(split=True)}


def _class_counts(ps, ids, rec, max_t):
    """Lanes by what they hit, from the plain record."""
    tri = rec.tri.clamp(min=0)
    mesh = rec.tri >= 0
    smooth = mesh & (ps.wtri_nrm16[tri, 12] > 0.5)
    K = int(ps.prim_type.shape[0])
    return {"smooth_mesh": int(smooth.sum()),
            "flat_mesh": int((mesh & ~smooth).sum()),
            "sphere": int((rec.hit_id == ids["sphere"]).sum()),
            "box": int((rec.hit_id == ids["box"]).sum()),
            "plane": int((rec.hit_id >= K).sum()),
            "miss": int((rec.hit_id < 0).sum()),
            "dead": int((max_t < 0).sum())}


HOST_CASES = ["smooth_mesh", "flat_mesh", "sphere", "box", "plane", "miss",
              "dead", "ignored", "wide", "split"]


@pytest.mark.parametrize("case", HOST_CASES)
def test_lane_logic_matches_plain_on_host(host_lib, scenes, case):
    """csrc/hit.cuh's lanes, run on the host, against the plain version on
    CPU tensors: bit for bit on every field, on rays aimed so that most
    lanes are of the case's kind."""
    ps, ids = scenes[case == "split"]
    o, d, max_t, ign = case_rays(case, seed=HOST_CASES.index(case))
    if case == "ignored":
        ign[:] = ids["sphere"]
    plane_idx, w = walked(ps, o, d, max_t, ign)
    t, prim, tri, bv, bw, stats = w
    assert prim.dtype == tri.dtype == torch.int32
    plain = plain_record(ps, o, d, plane_idx, *w)
    args, outs = hit_kernel.record_args(ps, o, d, plane_idx, t, prim, tri,
                                        bv, bw)
    host_lib.hit_record_host(ctypes.c_void_p(ctypes.addressof(args)))
    assert_records_equal(plain, hit_kernel.as_hit(t, bv, bw, stats, outs),
                         case)
    counts = _class_counts(ps, ids, plain, max_t)
    if case == "ignored":
        assert counts["sphere"] == 0 and counts["plane"] > N // 4, counts
    elif case in counts:
        assert counts[case] > N // 4, counts
    else:  # the whole view: every kind of hit
        assert all(counts[c] > 10 for c in TARGETS), counts
        assert counts["plane"] > 10 and counts["miss"] > 10, counts
    if case == "dead":
        assert bool((plain.hit_id[max_t < 0] == -1).all())


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def record_queries(monkeypatch, frame, count=2):
    """Run ``frame()`` with ``hit_kernel.hit_record`` wrapped, keeping
    copies of the inputs of its first ``count`` calls (the closest-hit
    queries of bounces 0, 1, ...)."""
    kept = []
    real = hit_kernel.hit_record

    def rec(ps, o, d, plane_idx, t, prim, tri, bv, bw, stats):
        if len(kept) < count:
            c = lambda x: x.clone()  # noqa: E731
            kept.append((Vec3(*map(c, o)), Vec3(*map(c, d)), c(plane_idx),
                         c(t), c(prim), c(tri), c(bv), c(bw), c(stats)))
        return real(ps, o, d, plane_idx, t, prim, tri, bv, bw, stats)

    monkeypatch.setattr(hit_kernel, "hit_record", rec)
    frame()
    torch.cuda.synchronize()
    monkeypatch.setattr(hit_kernel, "hit_record", real)
    return kept


def _card_scene(name, dev):
    from buas_pathtracer_tpu_torch.models import scenes
    if name == "bench":
        sc = scenes.build_bench_scene(1920, 1080)
    elif name == "stress":
        sc = scenes.build_stress_scene(1920, 1080)
    else:
        sc = scenes.load_scene("Week 7, Nicer", 1920, 1080)
    return sc, sc.pack(device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bench", "week7_nicer", "stress"])
def test_kernel_bit_equal_plain_on_card(name, monkeypatch):
    """The bounce-0 and bounce-1 closest-hit queries of a 1920x1080 frame:
    the kernel's record equals the plain version's, one launch each."""
    from buas_pathtracer_tpu_torch.runtime import film
    from buas_pathtracer_tpu_torch.runtime.render import render_frame
    dev = _card()
    sc, ps = _card_scene(name, dev)
    assert (ps.v4_res is not None) == (name == "stress")

    def frame():
        render_frame(ps, sc.settings, sc.camera,
                     film.new_accumulation_buffer(1080, 1920, dev), 3,
                     h=1080, w=1920, n_lights=sc.n_lights, device=dev)

    waves = record_queries(monkeypatch, frame)
    assert len(waves) == 2
    for b, (o, d, plane_idx, t, prim, tri, bv, bw, stats) in enumerate(waves):
        before = trace.launch_totals()["hit_record"]
        kern = hit_kernel.hit_record(ps, o, d, plane_idx, t, prim, tri, bv,
                                     bw, stats)
        assert trace.launch_totals()["hit_record"] == before + 1
        plain = plain_record(ps, o, d, plane_idx, t, prim, tri, bv, bw, stats)
        torch.cuda.synchronize()
        assert_records_equal(plain, kern, f"{name} bounce {b}")
        assert int((plain.hit_id >= 0).sum()) > 1000


def _frame(dev, monkeypatch, plain):
    from buas_pathtracer_tpu_torch.models.scenes import build_bench_scene
    from buas_pathtracer_tpu_torch.runtime import film
    from buas_pathtracer_tpu_torch.runtime.render import render_frame
    if plain:
        monkeypatch.setattr(hit_kernel, "hit_record", plain_record)
    w, h = 480, 270
    sc = build_bench_scene(w, h)
    ps = sc.pack(device=dev)
    with trace.frame() as rec:
        accum, stats = render_frame(
            ps, sc.settings, sc.camera,
            film.new_accumulation_buffer(h, w, dev), 5, h=h, w=w,
            n_lights=sc.n_lights, device=dev)
        torch.cuda.synchronize()
    monkeypatch.undo()
    return accum, stats, rec


@pytest.mark.gpu
def test_frame_bit_equal_plain_on_card(monkeypatch):
    """A 480x270 bench frame (8 bounces) through the kernel equals the
    frame through the plain record; the record shows one hit_record launch
    a closest-hit query (a bounce run)."""
    dev = _card()
    ak, sk, rec = _frame(dev, monkeypatch, plain=False)
    ap, sp, rec_p = _frame(dev, monkeypatch, plain=True)
    assert torch.equal(ak, ap) and torch.equal(sk, sp)
    runs = len(rec.bounces)
    assert runs >= 3 and rec.bounces == rec_p.bounces
    assert rec.launches.get("hit_record") == runs
    assert "hit_record" not in rec_p.launches


@pytest.mark.gpu
def test_caller_tensors_unchanged_on_card():
    """``intersect_scene`` reads the caller's rays and limits and writes
    none of them (rays given as strided views too)."""
    dev = _card()
    ps, _ = hit_scene()
    ps = scene_mod.PackedScene(**{
        k: (v.to(dev) if isinstance(v, torch.Tensor) else
            Vec3(*(x.to(dev) for x in v)) if isinstance(v, Vec3) else v)
        for k, v in ps._asdict().items()})
    o, d, max_t, _ = case_rays("dead")
    o3 = torch.stack(list(o)).T.contiguous().to(dev)  # (N, 3): strided views
    o = Vec3(o3[:, 0], o3[:, 1], o3[:, 2])
    d = Vec3(*(x.to(dev) for x in d))
    max_t = max_t.to(dev)
    keep = [x.clone() for x in (*o, *d, max_t)]
    h = traverse_wide.intersect_scene(ps, o, d, max_t=max_t)
    torch.cuda.synchronize()
    for a, b in zip(keep, (*o, *d, max_t)):
        assert torch.equal(a, b)
    assert int((h.hit_id >= 0).sum()) > 100
