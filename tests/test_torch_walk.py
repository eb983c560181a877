"""The traversal walk core (``csrc/walk.cuh``) on the CPU.

There is no CUDA compiler here, so the walk core is compiled with g++ against
``tests/walk_host/cuda_host.h``, which emulates a warp as 32 threads meeting
at a barrier in every warp-collective call, and run over small scenes with
all blocks of the grid at once: its persistent fetch loop and grouped steps
must give the plain walks' outputs and stats bit for bit
(``ops/packet.py``), on the fetch loop's edges (n = 0, 1, 31, 33, more rays
than the grid's lanes, all-dead and all-NaN waves, occlusion's early exit),
with several blocks taking rays from one counter, and on a deep tree whose
stacks grow past 16 entries.  A collective that some lanes skip hangs the
emulation, as it would the card.

Also here: the constants of ``csrc/*.cu{,h}`` against ``ops/packet.py`` and
``ops/wide_bvh.py``, the grid arithmetic of the wrappers, the build helper's
source hash and its parse of nvcc's ``-Xptxas -v`` report.  The JAX package
is the reference of the plain walks (tests/test_torch_traverse.py,
tests/test_torch_split.py); this file holds the kernel's logic to them."""

import ctypes
import os
import re
import shutil
import subprocess

import jax  # noqa: F401  (both frameworks load in one process, as elsewhere)
import numpy as np
import pytest
import torch

from buas_pathtracer_tpu_torch.core import vec as tvec
from buas_pathtracer_tpu_torch.core.vec import Vec3 as TV
from buas_pathtracer_tpu_torch.models.mesh import Mesh
from buas_pathtracer_tpu_torch.models.scene import Scene
from buas_pathtracer_tpu_torch.ops import cuda_lib, packet, wide_bvh
from buas_pathtracer_tpu_torch.utils import trace
from buas_pathtracer_tpu_torch.utils.procgen import icosphere

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "buas_pathtracer_tpu_torch",
                    "csrc")
HOST = os.path.join(HERE, "walk_host")


def _constexpr(name):
    src = open(os.path.join(CSRC, "walk.cuh")).read()
    m = re.search(rf"constexpr (?:int|float) {name} = ([^;]+);", src)
    assert m, name
    return float(m.group(1).rstrip("f"))


@pytest.mark.parametrize("name,value", [
    ("STACK", packet.STACK), ("THREADS", packet.WALK_THREADS),
    ("WIDE", wide_bvh.WIDE), ("ROW_W", wide_bvh.ROW_W),
    ("LEAF_ROW_W", wide_bvh.LEAF_ROW_W), ("WIDE_LEAF", wide_bvh.WIDE_LEAF),
    ("DMA_LEAF_K", wide_bvh.DMA_LEAF_K),
    ("KIND_INTERNAL", wide_bvh.KIND_INTERNAL),
    ("KIND_TRIS", wide_bvh.KIND_TRIS), ("KIND_PRIM", wide_bvh.KIND_PRIM),
    ("KIND_EMPTY", wide_bvh.KIND_EMPTY),
    ("PRIM_SPHERE", packet.PRIM_SPHERE), ("BIG_T", packet.BIG_T),
    ("LINK_BITS", packet.LINK_LIMIT.bit_length()),
])
def test_csrc_constants_match_python(name, value):
    assert _constexpr(name) == value


def test_no_kernel_source_keeps_its_own_stack():
    """Both traversal sources take STACK and the row constants from
    walk.cuh and define none of their own."""
    for f in ("wide_traverse.cu", "split_traverse.cu"):
        src = open(os.path.join(CSRC, f)).read()
        assert '#include "walk.cuh"' in src
        assert not re.search(r"constexpr int (STACK|ROW_W|WIDE)\b", src)


@pytest.mark.parametrize("n,resident,blocks", [
    (0, 1056, 1), (1, 1056, 1), (128, 1056, 1), (129, 1056, 2),
    (1056 * 128, 1056, 1056), (1056 * 128 + 1, 1056, 1056),
    (2073600, 1056, 1056), (2073600, 132, 132),
])
def test_walk_grid(n, resident, blocks):
    assert packet.walk_grid(n, resident) == blocks


def test_walk_grid_needs_resident_blocks():
    with pytest.raises(RuntimeError, match="occupancy"):
        packet.walk_grid(100, 0)


def test_table_rows_bounded_by_link_bits(monkeypatch):
    monkeypatch.setattr(packet, "LINK_LIMIT", 2)
    o = TV(*(torch.zeros(4) for _ in range(3)))
    with pytest.raises(ValueError, match="links at most"):
        packet.wide_traverse(torch.zeros((2, 64)), 1, o, o, torch.zeros(4),
                             torch.zeros(4, dtype=torch.int32), False)


def test_build_key_covers_every_source(tmp_path, monkeypatch):
    """An edit to walk.cuh, which no SOURCES entry names, rebuilds."""
    shutil.copytree(CSRC, tmp_path / "csrc",
                    ignore=shutil.ignore_patterns("_build"))
    monkeypatch.setattr(cuda_lib, "_CSRC", str(tmp_path / "csrc"))
    before = cuda_lib._key()
    with open(tmp_path / "csrc" / "walk.cuh", "a") as f:
        f.write("\n// edited\n")
    edited = cuda_lib._key()
    assert edited != before
    monkeypatch.setattr(cuda_lib, "NVCC_FLAGS", cuda_lib.NVCC_FLAGS + ("-DX",))
    assert cuda_lib._key() != edited
    assert "-v" in cuda_lib.NVCC_FLAGS


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121wide_traverse_\
closestEN4walk7UnifiedENS0_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121wide_traverse_\
closestEN4walk7UnifiedENS0_4ArgsE
    896 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 72 registers, 16384 bytes smem, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_Z17tristream_closestPKfi' for \
'sm_90a'
ptxas info    : Function properties for _Z17tristream_closestPKfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 400 bytes cmem[0]
"""


def test_parse_ptxas():
    r = cuda_lib.parse_ptxas(PTXAS)
    assert r == {
        "wide_traverse_closest": {"registers": 72, "spill_stores": 8,
                                  "spill_loads": 12, "stack_frame": 896,
                                  "smem": 16384},
        "tristream_closest": {"registers": 40, "spill_stores": 0,
                              "spill_loads": 0, "stack_frame": 0,
                              "smem": 0}}


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_124split_traverse_occlusionEN4walk5SplitENS0_4ArgsE",
     "split_traverse_occlusion"),
    ("_Z10post_rgba8PKfS0_Ph", "post_rgba8"), ("plain_c_name", "plain_c_name"),
])
def test_kernel_name(mangled, name):
    assert cuda_lib._kernel_name(mangled) == name


# ---------------------------------------------------------------------------
# the walk core on the host
# ---------------------------------------------------------------------------

def build_host_lib(tmp_path_factory, source):
    """``tests/walk_host/<source>`` and the csrc header it includes, built
    with g++ (no FP contraction, as nvcc's -fmad=false) and loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    so = str(tmp_path_factory.mktemp("walk_host") / source.replace(".cpp",
                                                                   ".so"))
    build = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", f"-I{CSRC}", "-o", so, os.path.join(HOST, source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    assert build.returncode == 0, build.stdout.decode(errors="replace")
    return ctypes.CDLL(so)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory, "walk_host.cpp")


def _packet_scene():
    """tests/test_pallas_packet.py:23-43: two mesh instances, an analytic
    sphere and box."""
    sc = Scene(name="packet-parity")
    grey = sc.add_diffuse_material((0.6, 0.6, 0.6), 1.2)
    red = sc.add_diffuse_material((0.8, 0.2, 0.2), 1.4)
    glass = sc.add_translucent_material((0.1, 0.05, 0.02), 1.5)
    mesh = icosphere(subdivisions=2)
    sc.add_mesh(grey, mesh, tvec.translate([0, 1.2, 2.5]))
    sc.add_mesh(red, mesh, tvec.translate([-2.2, 1.0, 4.0]) * tvec.scale(0.8))
    sc.add_sphere(glass, 0.9, tvec.translate([2.0, 1.0, 3.0]))
    sc.add_box(grey, (8, 0.5, 8), tvec.translate([0, -0.5, 3.0]))
    return sc


def deep_scene(n_tris=12000, seed=0):
    """A degenerate mesh: ``n_tris`` near-copies of one triangle.  A ray
    through it enters every box of the tree, so each internal step pushes
    all 8 children and the stack grows by 7 a level."""
    rng = np.random.default_rng(seed)
    base = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    tris = base[None] + rng.normal(scale=1e-3, size=(n_tris, 3, 3))
    sc = Scene(name="deep")
    m = sc.add_diffuse_material((0.5, 0.5, 0.5), 1.0)
    sc.add_mesh(m, Mesh(triangles=tris.astype(np.float32)),
                tvec.translate([0, 0, 3]))
    return sc


def deep_rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  np.zeros(n)]).astype(np.float32)
    d = np.stack([rng.normal(0, 0.01, n), rng.normal(0, 0.01, n),
                  np.ones(n)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    return o, d, np.full(n, 3.0e38, np.float32), np.full(n, -1, np.int32)


@pytest.fixture(scope="module")
def tables():
    ps = _packet_scene().pack(device="cpu", split=True)
    deep = deep_scene().pack(device="cpu", split=True)
    return {"packet": ps, "deep": deep}


def edge_rays(n, seed, dead=0.0, nan=0.0, occlusion=False):
    """Random rays through the packet scene; a share ``dead`` with t0 < 0,
    a share ``nan`` with a NaN origin; some ignore the glass sphere."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-2, 2, n), rng.uniform(0, 3, n),
                  rng.uniform(-3, 4, n)]).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    t0 = np.full(n, 6.0 if occlusion else 3.0e38, np.float32)
    t0[rng.uniform(size=n) < dead] = -1.0
    o[0, rng.uniform(size=n) < nan] = np.nan
    ign = np.full(n, -1, np.int32)
    ign[::7] = 2
    return o, d, t0, ign


# (n, dead share, NaN share): the fetch loop's edges
EDGES = {"n0": (0, 0.0, 0.0), "n1": (1, 0.0, 0.0), "n31": (31, 0.3, 0.1),
         "n33": (33, 0.3, 0.1), "many": (900, 0.6, 0.05),
         "all_dead": (300, 1.0, 0.0), "all_nan": (300, 0.0, 1.0)}


def _tv(a):
    return TV(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def plain_walk(ps, split, o, d, t0, ign, occlusion):
    args = (_tv(o), _tv(d), torch.from_numpy(t0), torch.from_numpy(ign),
            occlusion)
    if split:
        out = packet.split_traverse_plain(ps.v4_res, ps.v4_leaf,
                                          ps.wide_depth, *args)
    else:
        out = packet.wide_traverse_plain(ps.wide_rows, ps.wide_depth, *args)
    return [x.numpy() for x in out]


def host_walk(lib, ps, split, o, d, t0, ign, occlusion, resident_blocks=2,
              counters=None):
    """The walk core's kernel on the host, launched as the wrapper launches
    it: walk_grid blocks, a zeroed counter.  Returns the plain walk's
    outputs, the warp steps and the counter's final value.  ``counters``,
    a zeroed int64 (2,) array and a zeroed uint32 bitmap of the leaf rows,
    runs the counted split walk, which fills them."""
    n = t0.size
    outs = [np.zeros(n, dt) for dt in (np.float32, np.int32, np.int32,
                                       np.float32, np.float32)]
    stats = np.zeros(2, np.int64)
    nxt = np.zeros(1, np.int32)
    steps = np.zeros(1, np.int64)
    keep = [np.ascontiguousarray(c) for c in (*o, *d)]

    def p(a):
        return ctypes.c_void_p(a.ctypes.data)

    args = [ctypes.c_int(n), *map(p, keep), p(t0), p(ign),
            ctypes.c_int(int(occlusion)), *map(p, outs), p(stats), p(nxt),
            p(steps), ctypes.c_int(packet.walk_grid(n, resident_blocks))]
    if counters is not None:
        args[-1:-1] = map(p, counters)
        lib.emu_split_counted(p(ps.v4_res.numpy()), p(ps.v4_leaf.numpy()),
                              *args)
    elif split:
        lib.emu_split(p(ps.v4_res.numpy()), p(ps.v4_leaf.numpy()), *args)
    else:
        lib.emu_wide(p(ps.wide_rows.numpy()), *args)
    return outs + [stats], int(steps[0]), int(nxt[0])


def assert_same(out, ref):
    for a, b in zip(out[:5], ref[:5]):
        b = b.astype(a.dtype)
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    assert out[5].tolist() == ref[5].tolist()


@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
@pytest.mark.parametrize("split", [False, True], ids=["unified", "split"])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_host_walk_matches_plain(host_lib, tables, edge, split, occlusion):
    n, dead, nan = EDGES[edge]
    o, d, t0, ign = edge_rays(n, seed=n + 5, dead=dead, nan=nan,
                              occlusion=occlusion)
    ps = tables["packet"]
    ref = plain_walk(ps, split, o, d, t0, ign, occlusion)
    out, steps, _ = host_walk(host_lib, ps, split, o, d, t0, ign, occlusion)
    assert_same(out, ref)
    live = (t0 >= 0) & ~np.isnan(o).any(axis=0)
    # dead and NaN rays pass through without a row read
    assert (out[0][~live].view(np.uint32)
            == t0[~live].view(np.uint32)).all()
    assert (out[1][~live] == -1).all() and (out[2][~live] == -1).all()
    assert (ref[5][0] > 0) == live.any()
    # every warp step reads at least one row, at most 32
    assert steps <= ref[5][0] <= 32 * steps


@pytest.mark.parametrize("blocks", [1, 3, 5])
@pytest.mark.parametrize("split", [False, True], ids=["unified", "split"])
def test_host_walk_blocks_share_the_counter(host_lib, tables, split, blocks):
    """Every block of the grid takes rays from one counter at once; each ray
    is walked once, whichever block fetched it, and the counter runs past
    the last ray."""
    o, d, t0, ign = edge_rays(1500, seed=11, dead=0.4, nan=0.02)
    ps = tables["packet"]
    ref = plain_walk(ps, split, o, d, t0, ign, False)
    out, _, counter = host_walk(host_lib, ps, split, o, d, t0, ign, False,
                                resident_blocks=blocks)
    assert_same(out, ref)
    assert counter >= t0.size


@pytest.mark.parametrize("split", [False, True], ids=["unified", "split"])
def test_host_walk_deep_stack(host_lib, tables, split, monkeypatch):
    """The deep tree's walks grow their stacks past 16 entries; the outputs
    and stats stay the plain walk's."""
    ps = tables["deep"]
    deepest = [0]
    internal = packet._Walk.internal

    def spy(self, *a, **k):
        internal(self, *a, **k)
        deepest[0] = max(deepest[0], int(self.sp.max()))

    monkeypatch.setattr(packet._Walk, "internal", spy)
    o, d, t0, ign = deep_rays(96)
    ref = plain_walk(ps, split, o, d, t0, ign, False)
    assert deepest[0] > 16 and packet.stack_fits(ps.wide_depth)
    out, _, _ = host_walk(host_lib, ps, split, o, d, t0, ign, False)
    assert_same(out, ref)
    assert (out[1] >= 0).all()


@pytest.mark.parametrize("occlusion", [False, True],
                         ids=["closest", "occlusion"])
@pytest.mark.parametrize("edge", ["n0", "n33", "many", "all_dead", "all_nan",
                                  "deep"])
def test_host_counted_walk_counts_the_plain_walks_leaf_reads(
        host_lib, tables, edge, occlusion):
    """The counted split walk (``COUNT``): the plain walk's outputs and
    stats, the rays with t0 >= 0 as its live rays, the plain walk's leaf
    reads as its leaf-row fetches, and a bit set in its bitmap for each
    leaf row the plain walk read, and for no other."""
    if edge == "deep":
        ps = tables["deep"]
        o, d, t0, ign = deep_rays(96)
    else:
        ps = tables["packet"]
        n, dead, nan = EDGES[edge]
        o, d, t0, ign = edge_rays(n, seed=n + 17, dead=dead, nan=nan,
                                  occlusion=occlusion)
    rows = ps.v4_leaf.shape[0]
    reads = torch.zeros(rows, dtype=torch.int64)
    ref = [x.numpy() for x in packet.split_traverse_plain(
        ps.v4_res, ps.v4_leaf, ps.wide_depth, _tv(o), _tv(d),
        torch.from_numpy(t0), torch.from_numpy(ign), occlusion,
        leaf_reads=reads)]
    counts = np.zeros(2, np.int64)
    bits = np.zeros(-(-rows // 32), np.uint32)
    out, _, _ = host_walk(host_lib, ps, True, o, d, t0, ign, occlusion,
                          counters=(counts, bits))
    assert_same(out, ref)
    assert counts.tolist() == [int((t0 >= 0).sum()), int(reads.sum())]
    flags = np.unpackbits(bits.view(np.uint8), bitorder="little")
    assert np.array_equal(flags[:rows] != 0, reads.numpy() > 0)
    assert not flags[rows:].any()
    if edge in ("n33", "many", "deep"):
        assert counts[1] > 0


def test_plain_walk_reads_no_row_for_nan_rays(tables):
    ps = tables["packet"]
    o, d, t0, ign = edge_rays(64, seed=3, nan=1.0)
    for split in (False, True):
        out = plain_walk(ps, split, o, d, t0, ign, False)
        assert out[5].tolist() == [0, 0]
        assert np.array_equal(out[0], t0) and (out[1] == -1).all()


# ---------------------------------------------------------------------------
# the same edges through the kernels on the card (gpu tests of
# test_torch_traverse.py and test_torch_split.py call this)
# ---------------------------------------------------------------------------

CARD_EDGES = ["n0", "n1", "n31", "n33", "below_grid", "above_grid",
              "all_dead", "all_nan", "deep"]


def check_edge_on_card(edge, split, occlusion, card):
    """Kernel against plain on the card: outputs and stats equal, one
    launch counted.  ``below_grid`` / ``above_grid`` take 33 rays fewer /
    more than the lanes of one full persistent grid."""
    name = "split_traverse" if split else "wide_traverse"
    if edge == "deep":
        ps = deep_scene().pack(device="cpu", split=True)
        o, d, t0, ign = deep_rays(2048)
    else:
        ps = _packet_scene().pack(device="cpu", split=True)
        if edge.endswith("_grid"):
            lanes = getattr(cuda_lib.load(), f"{name}_blocks")(
                int(occlusion)) * packet.WALK_THREADS
            n = lanes - 33 if edge == "below_grid" else lanes + 33
            o, d, t0, ign = edge_rays(n, seed=9, dead=0.5, nan=0.01,
                                      occlusion=occlusion)
        else:
            n, dead, nan = EDGES[edge]
            o, d, t0, ign = edge_rays(n, seed=n + 5, dead=dead, nan=nan,
                                      occlusion=occlusion)
    args = (TV(*(c.to(card) for c in _tv(o))),
            TV(*(c.to(card) for c in _tv(d))),
            torch.from_numpy(t0).to(card), torch.from_numpy(ign).to(card),
            occlusion)
    if split:
        tabs = (ps.v4_res.to(card), ps.v4_leaf.to(card), ps.wide_depth)
        key = "split_occlusion" if occlusion else "split_closest"
        kernel, plain = packet.split_traverse, packet.split_traverse_plain
    else:
        tabs = (ps.wide_rows.to(card), ps.wide_depth)
        key = "occlusion" if occlusion else "closest"
        kernel, plain = packet.wide_traverse, packet.wide_traverse_plain
    before = trace.launch_totals()[key]
    out = kernel(*tabs, *args)
    ref = plain(*tabs, *args)
    torch.cuda.synchronize()
    assert trace.launch_totals()[key] == before + 1
    for a, b in zip(out, ref):
        assert torch.equal(a.cpu(), b.cpu().to(a.dtype))
