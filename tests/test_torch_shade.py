"""The kernels of the Advanced Pathtracer's bounce (``csrc/shade.cu``,
``csrc/nee.cu``, ``ops/shade_kernel.py``) against their plain version
(``integrators/advanced.py`` ``_shade_hit_plain`` / ``_nee_plain`` /
``_shade_next_plain``).

On the card the kernels must equal the plain version bit for bit
(``torch.equal``) on every lane's total, alive, throughput, origin,
direction, stack, stack index, specular flag and previous normal, on the
RNG state of the lanes alive at the bounce's entry, on NEE's samples (slot,
pick probability, the light's and environment's terms, facing, occlusion)
and shadow wave (rays, t0 after the plane pass, ignored prim, plane flag),
and on the stats: over a grid of the integrator's flags, the three sampling
strategies, bounce 0 and later bounces, hits from inside and outside, empty
and full stacks, rough metal and emissive hits; a whole small frame too,
and the caller's rays and sampler are left as they were.

Here on the CPU: the module imports without ``nvcc`` and CPU tensors take
the plain path; the wrappers' checks; the table offsets and the argument
struct that ``csrc/shade.cuh`` hard-codes, parsed from its source; and the
lane logic itself, compiled with g++ (``tests/shade_host/``) and held to the
plain version within float tolerance: exact in every integer, flag, branch,
light slot and RNG state, close in every float (the CPU's PyTorch rounds a
division by a scalar and its transcendentals differently from the card's).
NEE's lanes are held so over light counts of 0, 1, 2 and 5, uniform and
importance picks, the environment's sample on and off, MIS on and off, 0, 1
and 2 planes, and dead lanes and lanes NEE does not serve.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from buas_pathtracer_tpu_torch.core import sampler as smp
from buas_pathtracer_tpu_torch.core import vec
from buas_pathtracer_tpu_torch.core.vec import Vec3
from buas_pathtracer_tpu_torch.integrators import advanced as adv
from buas_pathtracer_tpu_torch.models import camera as cm
from buas_pathtracer_tpu_torch.models import scene as scene_mod
from buas_pathtracer_tpu_torch.models.materials import Material
from buas_pathtracer_tpu_torch.models.scene import Scene, SceneSettings
from buas_pathtracer_tpu_torch.ops import cuda_lib, shade_kernel, traverse
from buas_pathtracer_tpu_torch.ops import traverse_wide
from buas_pathtracer_tpu_torch.utils import trace

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "buas_pathtracer_tpu_torch",
                    "csrc")
W, H = 48, 32
GLASS = 5  # shade_scene's outer glass
U, B, S = (smp.Strategy.UNIFORM, smp.Strategy.BLUE_NOISE,
           smp.Strategy.STRATIFIED)

# settings that change the kernels' paths, by case name
FLAGS = {
    "default": dict(),
    "no_nee": dict(next_event_estimation=False),
    "no_mis": dict(use_mis=False),
    "reference_mis": dict(reference_mis=True),
    "uniform_picks": dict(importance_sample_lights=False,
                          importance_sample_diffuse=False),
    "no_rr_no_caustics": dict(russian_roulette=False, caustics=False),
    "env": dict(),
    "env_no_mis_uniform": dict(use_mis=False,
                               importance_sample_diffuse=False),
    "env_no_nee": dict(next_event_estimation=False),
}


def shade_scene(env: bool):
    """Checker ground, two walls, diffuse, rough metal, half-metal, a glass
    sphere with a glass sphere inside it, two sphere lights and a box
    light; an environment map with ``env``."""
    sc = Scene(name="shade")
    ground = sc.add_diffuse_material((0.6, 0.6, 0.6), 1.2, checkers=True,
                                     checker_color=(0.2, 0.3, 0.1))
    red = sc.add_diffuse_material((0.8, 0.2, 0.2), 1.4, 0.25)
    metal = sc.add_material(Material(albedo=(0.9, 0.8, 0.5), ior=1.3,
                                     metallic=1.0, roughness=0.3))
    half = sc.add_material(Material(albedo=(0.3, 0.7, 0.9), ior=1.6,
                                    metallic=0.5))
    glass = sc.add_translucent_material((0.3, 0.1, 0.05), 1.5)
    inner = sc.add_translucent_material((0.05, 0.2, 0.3), 1.33, 0.1)
    warm = sc.add_emissive_material((12.0, 10.0, 7.0))
    cool = sc.add_emissive_material((3.0, 5.0, 9.0))
    sc.add_plane(ground, (0, 1, 0), 0.0)
    sc.add_plane(red, (0, 0, -1), -10.0)  # a back wall
    sc.add_plane(half, (1, 0, 0), -6.0)  # a half-metal left wall
    sc.add_sphere(red, 1.0, vec.translate([-2.2, 1.0, 4.0]))
    sc.add_sphere(metal, 0.9, vec.translate([2.2, 0.9, 4.0]))
    sc.add_box(half, (0.6, 0.6, 0.6), vec.translate([0.0, 0.6, 6.5]))
    sc.add_sphere(glass, 1.2, vec.translate([0.0, 1.2, 3.0]))
    sc.add_sphere(inner, 0.6, vec.translate([0.0, 1.2, 3.0]))
    sc.add_sphere(warm, 0.5, vec.translate([-1.5, 4.0, 2.0]))
    sc.add_sphere(cool, 0.4, vec.translate([2.0, 3.5, 1.5]))
    sc.add_box(cool, (0.3, 0.3, 0.3), vec.translate([0.0, 3.0, 5.5]))
    sc.camera = cm.aim_camera_at(
        cm.make_camera(p=(0.0, 2.2, -2.5), vfov=np.radians(60),
                       aspect=W / H), (0.0, 1.2, 3.5))
    if env:
        r = np.random.RandomState(5)
        sky = (r.rand(8, 16, 3) ** 3 * 3.0).astype(np.float32)
        sky[2, 5] = 80.0
        sc.env_map = sky
    return sc


def _settings(case, strategy):
    return SceneSettings(max_bounce_count=6, sampling_strategy=strategy,
                         **FLAGS[case])


def _initial(sc, settings, dev, w=W, h=H):
    """The pass's sampler and primary rays, as ``runtime/render.py`` makes
    them, and the integrator's entry state."""
    n = w * h
    st_ = int(settings.sampling_strategy)
    px = (torch.arange(n) % w).to(dev)
    py = (torch.arange(n) // w).to(dev)
    s = smp.make_sampler(px, py, 5, strategy=st_)
    s, au, av = smp.sample_2d(s, st_, smp.SampleDimension.AA, 0)
    s, du, dv = smp.sample_2d(s, st_, smp.SampleDimension.DOF, 0)
    rays = cm.generate_rays(cm.camera_on(sc.camera, dev), px, py, w, h, au,
                            av, du, dv, 0.0, 1.0, 6, 0.0, 0.0)
    return s, rays


def _entry_state(ps, settings, s, rays, n_lights):
    """``advanced()``'s flags, entry state and stats."""
    st = adv._entry_state(rays.o, rays.d, s)
    return (adv._flags(ps, settings, n_lights), st,
            torch.zeros(3, dtype=torch.float32, device=rays.o.x.device))


def _hit(ps, st):
    return traverse_wide.intersect_scene(
        ps, st.o, st.d, max_t=torch.where(st.alive, traverse.BIG_T, -1.0))


def _plain_bounce(ps, f, st, stats, bounce):
    hit = _hit(ps, st)
    st, stats, sh = adv._shade_hit_plain(ps, f, st, hit, stats, bounce)
    s, light, env = adv._nee_plain(ps, f, st.s, hit.p, sh.N, sh.nee_lanes,
                                   bounce)
    return adv._shade_next_plain(ps, f, st._replace(s=s), sh, light, env,
                                 stats, bounce)


def _clone(st):
    """A deep copy of the state, one tensor a field, as the loop owns it."""
    c = lambda x: x.clone()  # noqa: E731
    v = lambda x: Vec3(*(c(t) for t in x))  # noqa: E731
    return st._replace(alive=c(st.alive), o=v(st.o), d=v(st.d), tp=v(st.tp),
                       total=v(st.total), s=st.s._replace(state=c(st.s.state)),
                       stack=c(st.stack), stack_at=c(st.stack_at),
                       is_spec=c(st.is_spec), prev_n=v(st.prev_n))


def case_state(case, strategy, bounce, dev, w=W, h=H):
    """(ps, flags, state, stats) at ``bounce``: the plain loop run up to it
    on the scene, then the stacks of some lanes made full (7 glass entries)
    or empty."""
    sc = shade_scene(env=case.startswith("env"))
    ps = sc.pack(device=dev)
    settings = _settings(case, strategy)
    s, rays = _initial(sc, settings, dev, w, h)
    f, st, stats = _entry_state(ps, settings, s, rays, sc.n_lights)
    for b in range(bounce):
        st, stats = _plain_bounce(ps, f, st, stats, b)
    n = st.alive.shape[0]
    lane = torch.arange(n, device=dev)
    full = lane % 11 == 3
    stack = st.stack.clone()
    stack[:, full] = GLASS
    st = st._replace(stack=stack,
                     stack_at=torch.where(full, adv.STACK_DEPTH - 1,
                                          torch.where(lane % 11 == 5, 0,
                                                      st.stack_at)))
    return ps, f, _clone(st), stats


# ---------------------------------------------------------------------------
# CPU: the plain path, the wrapper's checks, the source's layout
# ---------------------------------------------------------------------------

def _no_library(monkeypatch):
    def load():
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(cuda_lib, "load", load)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """An Advanced pass on CPU tensors runs the plain version: no kernel
    launch is counted, the kernel library is never asked for (there is no
    nvcc here), and the result equals a loop of the plain bounces."""
    _no_library(monkeypatch)
    sc = shade_scene(env=False)
    ps = sc.pack(device="cpu")
    settings = _settings("default", S)
    s, rays = _initial(sc, settings, torch.device("cpu"))
    before = trace.launch_totals()
    color, _, stats = adv.advanced(ps, settings, s, rays.o, rays.d,
                                   n_lights=sc.n_lights)
    after = trace.launch_totals()
    for k in ("shade_hit", "nee_sample", "shade_next"):
        assert after[k] == before[k], k
    f, st, st_stats = _entry_state(ps, settings, s, rays, sc.n_lights)
    for b in range(f.max_bounces):
        if not bool(st.alive.any()):
            break
        st, st_stats = _plain_bounce(ps, f, st, st_stats, b)
    for a, b in zip(color, st.total):
        assert torch.equal(a, b)
    assert torch.equal(stats, st_stats)


def test_advanced_leaves_the_callers_tensors():
    """The loop's state is its own: the caller's rays and sampler are not
    written (on the card the kernels update the state in place)."""
    sc = shade_scene(env=False)
    ps = sc.pack(device="cpu")
    settings = _settings("default", S)
    s, rays = _initial(sc, settings, torch.device("cpu"))
    keep = [x.clone() for x in (*rays.o, *rays.d, s.state, s.pre, s.x, s.y)]
    adv.advanced(ps, settings, s, rays.o, rays.d, n_lights=sc.n_lights)
    for a, b in zip(keep, (*rays.o, *rays.d, s.state, s.pre, s.x, s.y)):
        assert torch.equal(a, b)


def _bad(edit):
    ps, f, st, stats = case_state("default", S, 1, torch.device("cpu"))
    hit = _hit(ps, st)
    if edit == "dtype":
        st = st._replace(tp=Vec3(st.tp.x.double(), st.tp.y, st.tp.z))
    elif edit == "shape":
        st = st._replace(o=Vec3(st.o.x[:-1], st.o.y, st.o.z))
    elif edit == "stride":
        st = st._replace(total=Vec3(torch.zeros(2 * st.alive.shape[0])[::2],
                                    st.total.y, st.total.z))
    elif edit == "stack":
        st = st._replace(stack=st.stack[:4])
    elif edit == "hit":
        hit = hit._replace(mat_id=hit.mat_id.to(torch.int32))
    elif edit == "stats":
        stats = stats.double()
    elif edit == "bases":
        # a per-ray sample index: no first-bounce bases
        st = st._replace(s=st.s._replace(pre=torch.zeros((0, st.alive.shape[
            0]))))
        return ps, f, st, hit, stats, 0
    return ps, f, st, hit, stats, 1


@pytest.mark.parametrize("edit,match", [
    ("dtype", "tp.x must be"), ("shape", "o.x must be"),
    ("stride", "total.x must be"), ("stack", "stack must be"),
    ("hit", "hit.mat_id must be"), ("stats", "stats must be"),
    ("bases", "first-bounce bases"), ("device", "no shade_hit for device")])
def test_wrapper_rejects_bad_inputs(edit, match, monkeypatch):
    """Wrong dtypes, shapes, strides and devices raise before the kernel
    library is asked for, and so does the first bounce of a sampler without
    first-bounce bases under stratified or blue noise (valid CPU tensors
    reach the device check)."""
    _no_library(monkeypatch)
    ps, f, st, hit, stats, bounce = _bad(edit)
    with pytest.raises(ValueError, match=match):
        shade_kernel.shade_hit(ps, f, st, hit, stats, bounce)


def test_shade_next_rejects_missing_nee():
    ps, f, st, stats = case_state("default", S, 1, torch.device("cpu"))
    hit = _hit(ps, st)
    args, scratch = shade_kernel.hit_args(ps, f, st, hit, stats, 1)
    with pytest.raises(ValueError, match="NEE's samples"):
        shade_kernel.shade_next(ps, f, st, scratch, None, stats, 1)
    _, nee = shade_kernel.nee_args(ps, f, st, scratch, 1)
    with pytest.raises(ValueError, match="NEE's samples"):
        shade_kernel.shade_next(ps, f, st, scratch, nee, stats, 1)


@pytest.mark.parametrize("edit,match", [
    ("device", "no nee_sample for device"), ("sf", "sf must be"),
    ("si", "si must be"), ("p", "hit.p.y must be"),
    ("rng", "rng must be"), ("off", "next-event estimation is off"),
    ("alias", "env_alias_idx must be")])
def test_nee_wrapper_rejects_bad_inputs(edit, match, monkeypatch):
    """``nee_sample`` raises for CPU tensors (the plain version serves the
    CPU), for a scratch or state of the wrong shape or dtype, for flags with
    NEE off and for a scene table of the wrong dtype, before the kernel
    library is asked for."""
    _no_library(monkeypatch)
    ps, f, st, stats = case_state("env", S, 1, torch.device("cpu"))
    hit = _hit(ps, st)
    _, scratch = shade_kernel.hit_args(ps, f, st, hit, stats, 1)
    sf, si, p = scratch
    if edit == "sf":
        scratch = (sf[:-1], si, p)
    elif edit == "si":
        scratch = (sf, si.to(torch.int32), p)
    elif edit == "p":
        scratch = (sf, si, Vec3(p.x, p.y[:-1], p.z))
    elif edit == "rng":
        st = st._replace(s=st.s._replace(state=st.s.state.to(torch.int32)))
    elif edit == "off":
        f = f._replace(nee=False, env_nee=False)
    elif edit == "alias":
        ps = ps._replace(env_alias_idx=ps.env_alias_idx.to(torch.int32))
    with pytest.raises(ValueError, match=match):
        shade_kernel.nee_sample(ps, f, st, scratch, 1)


def _constants(src):
    return {k: v for k, v in re.findall(
        r"constexpr (?:int|int64_t|uint8_t) (\w+) = (-?\w+);", src)}


def _struct_fields(src):
    body = re.search(r"struct Args \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        names = decl.split(",")
        first = names[0].split()
        names[0] = first[-1]
        for name in names:
            name = name.strip().lstrip("*")
            m = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", name)
            out.append((m.group(1), int(m.group(2) or 1)))
    return out


def test_csrc_layout_matches_the_tables():
    """The offsets csrc/shade.cuh hard-codes follow models/scene.py's mat16
    and light16 rows and prim_fwd, the material flags, PRIM_SPHERE, the
    sampler's enums, advanced.STACK_DEPTH and the wrapper's scratch rows;
    its ``shade::Args`` is ``ShadeArgs`` field for field."""
    src = open(os.path.join(CSRC, "shade.cuh")).read()
    k = {name: int(v, 0) for name, v in _constants(src).items()}
    sc = Scene(name="layout")
    m = Material(flags=0x2, albedo=(0.11, 0.12, 0.13),
                 checker_color=(0.21, 0.22, 0.23),
                 emission_color=(1.31, 1.32, 1.33), ior=1.41, metallic=0.51,
                 roughness=0.61, is_participating_medium=True,
                 absorb=(0.71, 0.72, 0.73))
    mid = sc.add_material(m)
    sc.add_sphere(mid, 0.75, vec.translate([3.0, 4.0, 5.0]))
    ps = sc.pack(device="cpu")
    row = ps.mat16[mid].tolist()
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    for key, vals in (("MAT_ALBEDO", m.albedo), ("MAT_EMISSION",
                                                 m.emission_color),
                      ("MAT_ABSORB", m.absorb),
                      ("MAT_CHECKER", m.checker_color)):
        assert row[k[key]:k[key] + 3] == [f32(x) for x in vals], key
    assert row[k["MAT_IOR"]] == f32(m.ior)
    assert row[k["MAT_METALLIC"]] == f32(m.metallic)
    assert row[k["MAT_ROUGHNESS"]] == f32(m.roughness)
    code = int(row[k["MAT_CODE"]])
    assert code == m.flags + k["CODE_MEDIUM"]
    assert code & k["CODE_EMISSIVE"] and code & k["CODE_CHECKERS"]
    assert k["MAT_ROW"] == ps.mat16.shape[1] == 16
    light = ps.light16[0].tolist()
    assert light[k["LIGHT_R"]] == 0.75
    assert light[k["LIGHT_EMISSION"]:k["LIGHT_EMISSION"] + 3] == [
        f32(x) for x in m.emission_color]
    assert k["LIGHT_ROW"] == ps.light16.shape[1]
    fwd = ps.prim_fwd[0].tolist()
    assert k["FWD_ROW"] == ps.prim_fwd.shape[1]
    assert [fwd[k["FWD_TX"]], fwd[k["FWD_TY"]], fwd[k["FWD_TZ"]]] == [
        3.0, 4.0, 5.0]
    assert k["PRIM_SPHERE"] == scene_mod.PRIM_SPHERE
    assert k["STACK_DEPTH"] == adv.STACK_DEPTH == shade_kernel.STACK_DEPTH
    assert (k["BLUE_NOISE"], k["STRATIFIED"]) == (smp.Strategy.BLUE_NOISE,
                                                  smp.Strategy.STRATIFIED)
    D = smp.SampleDimension
    assert (k["DIM_DIRECT"], k["DIM_INDIRECT"], k["DIM_SELECT"],
            k["DIM_REFLECTANCE"], k["DIM_ROULETTE"], k["DIM_ENV"]) == (
        D.DIRECT_LIGHTING, D.INDIRECT_LIGHTING, D.LIGHT_SELECTION,
        D.REFLECTANCE, D.ROULETTE, D.ENV_LIGHTING)
    assert (k["SF_ROWS"], k["SF_N"], k["SI_ROWS"], k["SI_NEE"]) == (
        shade_kernel.SF_ROWS, shade_kernel.SF_N, shade_kernel.SI_ROWS,
        shade_kernel.SI_NEE)
    assert (k["NF_ROWS"], k["WF_ROWS"], k["WF_O"], k["WF_D"],
            k["WB_FACING"], k["WB_PLANE"]) == (
        shade_kernel.NF_ROWS, shade_kernel.WF_ROWS, 0, 3,
        shade_kernel.WB_FACING, shade_kernel.WB_PLANE)
    want = [(name, ctypes.sizeof(t) // 8)
            for name, t in shade_kernel.ShadeArgs._fields_]
    assert _struct_fields(src) == want


def test_trace_counts_the_shade_kernels():
    assert {"shade_hit", "nee_sample", "shade_next"} <= set(trace.KERNELS)


# ---------------------------------------------------------------------------
# CPU: the lane logic, compiled with g++, against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the lane logic on the host")
    so = str(tmp_path_factory.mktemp("shade_host") / "shade_host.so")
    build = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-o", so, os.path.join(HERE, "shade_host", "shade_host.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    assert build.returncode == 0, build.stdout.decode(errors="replace")
    lib = ctypes.CDLL(so)
    assert lib.shade_args_size() == ctypes.sizeof(shade_kernel.ShadeArgs)
    return lib


def _close(a, b, what):
    a, b = a.double(), b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    ok = both_nan | torch.isclose(a, b, rtol=2e-5, atol=1e-6)
    assert bool(ok.all()), f"{what}: {int((~ok).sum())} lanes differ"


def _compare(pa, pb, entry_alive, exact_floats, what):
    """The two states, field by field: exact in every flag, integer and
    live lane's RNG state; floats exact or within tolerance."""
    def eq(a, b, name):
        if not torch.equal(a, b):
            pytest.fail(f"{what}: {name} differs in "
                        f"{int((a != b).sum())} values")

    for name in ("alive", "stack", "stack_at", "is_spec"):
        eq(getattr(pa, name), getattr(pb, name), name)
    eq(pa.s.state[entry_alive], pb.s.state[entry_alive], "rng")
    for name in ("total", "tp", "o", "d", "prev_n"):
        for c, x, y in zip("xyz", getattr(pa, name), getattr(pb, name)):
            if exact_floats:
                eq(x, y, f"{name}.{c}")
            else:
                _close(x, y, f"{what}: {name}.{c}")


def _same(x, y, exact, what):
    if exact:
        if not torch.equal(x, y):
            pytest.fail(f"{what} differs in {int((x != y).sum())} values")
    else:
        _close(x, y, what)


def _compare_nee(ps, f, plain, nee, lanes, entry, exact, what):
    """NEE's outputs, ``nee_sample``'s and the walk's (``nee``, with the
    RNG state it left) against the plain version's (``plain``: its sampler,
    light and env samples and shadow queries): the live lanes' RNG state;
    on the lanes NEE serves, the slot and the samples' terms and the
    queries' rays and ignored prim; on every lane, facing, occlusion, the
    plane flag and t0 after the plane pass."""
    (s, light, env, queries), state = plain, nee[1]
    nee = nee[0]
    eq = lambda x, y, w: _same(x, y, True, f"{what}: {w}")  # noqa: E731
    eq(s.state[entry], state[entry], "the live lanes' RNG state")
    n = lanes.shape[0]
    samples = [(kind, x) for kind, x in (("light", light), ("env", env))
               if x is not None]
    assert len(samples) == len(queries) == nee.flags.shape[0] // n
    for k, ((kind, sample), query) in enumerate(zip(samples, queries)):
        sl = slice(k * n, (k + 1) * n)
        flags = nee.flags[sl]
        facing = (flags & shade_kernel.WB_FACING) != 0
        plane = (flags & shade_kernel.WB_PLANE) != 0
        eq(facing, sample.facing, f"{kind} facing")
        eq((nee.prim[sl] >= 0) | plane, sample.occluded, f"{kind} occluded")
        t_pl, plane_idx = traverse._intersect_planes(ps, *query[:3])
        eq(plane, plane_idx >= 0, f"{kind} plane flag")
        _same(nee.t0[sl], t_pl, exact, f"{what}: {kind} t0")
        o, d, _, ign = nee.rays()
        for c in range(3):
            _same(o[c][sl][lanes], query[0][c][lanes], exact,
                  f"{what}: {kind} o")
            _same(d[c][sl][lanes], query[1][c][lanes], exact,
                  f"{what}: {kind} d")
        eq(ign[sl][lanes].long(), query[3][lanes], f"{kind} ignored prim")
        T = nee.terms
        if kind == "light":
            eq(nee.slot[lanes].long(), light.slot[lanes], "slot")
            for row, x in ((0, light.n_dot_l), (1, light.nl_dot_l),
                           (2, light.area), (3, light.dist_sq),
                           (4, light.rcp_pdf)):
                _same(T[row][lanes], x[lanes], exact, f"{what}: term {row}")
        else:
            for row, x in ((5, env.n_dot_e), (6, env.pdf),
                           *((7 + c, env.radiance[c]) for c in range(3))):
                _same(T[row][lanes], x[lanes], exact, f"{what}: term {row}")


def run_both(ps, f, st, stats, bounce, hit_fn, nee_fn, next_fn, exact):
    """One bounce of the plain version and of ``hit_fn`` / ``nee_fn`` with
    the occlusion walk / ``next_fn`` (the kernels, or their lane logic on
    the host) from the same state, compared after each step.  Returns the
    number of live lanes compared."""
    hit = _hit(ps, st)
    entry = st.alive.clone()
    a, b = _clone(st), _clone(st)
    sa, sb = stats.clone(), stats.clone()
    a, sa, sha = adv._shade_hit_plain(ps, f, a, hit, sa, bounce)
    scratch = hit_fn(ps, f, b, hit, sb, bounce)
    what = f"bounce {bounce} shade_hit"
    _compare(a, b, entry, exact, what)
    lanes = sha.nee_lanes
    assert torch.equal(lanes, shade_kernel.nee_lanes(scratch)), what
    for x, y in zip(sha.N, shade_kernel.normal(scratch)):
        _same(x[lanes], y[lanes], exact, f"{what}: N")
    _same(sa, sb, exact, f"{what}: stats")
    s, light, env = adv._nee_plain(ps, f, a.s, hit.p, sha.N, lanes, bounce)
    nee = None
    if f.nee or f.env_nee:
        nee = adv._shadow_walk(ps, nee_fn(ps, f, b, scratch, bounce))
        queries = adv._nee_queries(ps, f, a.s, hit.p, sha.N, lanes,
                                   bounce)[3]
        _compare_nee(ps, f, (s, light, env, queries), (nee, b.s.state),
                     lanes, entry, exact, f"bounce {bounce} nee_sample")
    a, sa = adv._shade_next_plain(ps, f, a._replace(s=s), sha, light, env,
                                  sa, bounce)
    next_fn(ps, f, b, scratch, nee, sb, bounce)
    _compare(a, b, entry, exact, f"bounce {bounce} shade_next")
    _same(sa, sb, exact, "shade_next stats")
    return int(entry.sum())


def host_fns(host_lib):
    """The three kernels' lane logic on the host, with the arguments the
    wrappers check and allocate (``hit_args``, ``nee_args``, ``next_args``)."""
    def hit_fn(ps, f, st, hit, stats, bounce):
        args, scratch = shade_kernel.hit_args(ps, f, st, hit, stats, bounce)
        host_lib.shade_hit_host(ctypes.c_void_p(ctypes.addressof(args)))
        return scratch

    def nee_fn(ps, f, st, scratch, bounce):
        args, nee = shade_kernel.nee_args(ps, f, st, scratch, bounce)
        host_lib.nee_sample_host(ctypes.c_void_p(ctypes.addressof(args)))
        return nee

    def next_fn(ps, f, st, scratch, nee, stats, bounce):
        args = shade_kernel.next_args(ps, f, st, scratch, nee, stats,
                                      bounce)
        host_lib.shade_next_host(ctypes.c_void_p(ctypes.addressof(args)))
    return hit_fn, nee_fn, next_fn


HOST_CASES = [("default", S, 0), ("default", S, 2), ("default", U, 1),
              ("default", B, 0), ("no_nee", S, 1), ("no_mis", U, 2),
              ("reference_mis", S, 2), ("uniform_picks", S, 1),
              ("no_rr_no_caustics", S, 3), ("env", S, 0), ("env", S, 2),
              ("env_no_mis_uniform", U, 1), ("env_no_nee", B, 1)]


@pytest.mark.parametrize("case,strategy,bounce", HOST_CASES,
                         ids=[f"{c}-{int(s)}-b{b}" for c, s, b in HOST_CASES])
def test_lane_logic_matches_plain_on_host(host_lib, case, strategy, bounce):
    """csrc/shade.cuh's and csrc/nee.cuh's lanes, run on the host, against
    the plain version on CPU tensors: every flag, branch, stack entry, slot
    and live lane's RNG state equal, every float within 2e-5."""
    dev = torch.device("cpu")
    ps, f, st, stats = case_state(case, strategy, bounce, dev)
    live = run_both(ps, f, st, stats, bounce, *host_fns(host_lib),
                    exact=False)
    assert live > 100


def nee_scene(lights: int, planes: int, env: bool):
    """A scene for NEE's cases: ``lights`` emitters (sphere lights of
    several sizes, the fifth a box, whose pick weight is 0), ``planes``
    planes (else a box ground), diffuse, checker, metal and glass spheres;
    an environment map with ``env``."""
    sc = Scene(name="nee")
    ground = sc.add_diffuse_material((0.6, 0.6, 0.6), 1.2, checkers=True,
                                     checker_color=(0.2, 0.3, 0.1))
    red = sc.add_diffuse_material((0.8, 0.2, 0.2), 1.4, 0.25)
    metal = sc.add_material(Material(albedo=(0.9, 0.8, 0.5), ior=1.3,
                                     metallic=1.0, roughness=0.3))
    glass = sc.add_translucent_material((0.3, 0.1, 0.05), 1.5)
    if planes:
        sc.add_plane(ground, (0, 1, 0), 0.0)
    else:
        sc.add_box(ground, (12.0, 0.5, 12.0), vec.translate([0.0, -0.5, 4.0]))
    if planes > 1:
        sc.add_plane(red, (0, 0, -1), -10.0)
    sc.add_sphere(red, 1.0, vec.translate([-2.2, 1.0, 4.0]))
    sc.add_sphere(metal, 0.9, vec.translate([2.2, 0.9, 4.0]))
    sc.add_sphere(glass, 1.2, vec.translate([0.0, 1.2, 3.0]))
    sc.add_sphere(ground, 0.7, vec.translate([0.8, 0.7, 6.0]))
    spots = [((12.0, 10.0, 7.0), 0.5, (-1.5, 4.0, 2.0)),
             ((3.0, 5.0, 9.0), 0.4, (2.0, 3.5, 1.5)),
             ((6.0, 6.0, 6.0), 0.25, (0.0, 2.6, 5.0)),
             ((1.0, 9.0, 2.0), 0.8, (-3.0, 2.0, 7.0))]
    for k in range(lights):
        if k < 4:
            emission, r, at = spots[k]
            sc.add_sphere(sc.add_emissive_material(emission), r,
                          vec.translate(list(at)))
        else:
            sc.add_box(sc.add_emissive_material((4.0, 4.0, 4.0)),
                       (0.3, 0.3, 0.3), vec.translate([0.0, 3.0, 5.5]))
    sc.camera = cm.aim_camera_at(
        cm.make_camera(p=(0.0, 2.2, -2.5), vfov=np.radians(60),
                       aspect=W / H), (0.0, 1.2, 3.5))
    if env:
        r = np.random.RandomState(7)
        sky = (r.rand(8, 16, 3) ** 3 * 3.0).astype(np.float32)
        sky[1, 9] = 60.0
        sc.env_map = sky
    return sc


def nee_state(lights, planes, env, importance, mis, strategy, bounce, dev,
              w=W, h=H):
    """(ps, flags, state, stats) at ``bounce`` of ``nee_scene``: the plain
    loop run up to it, then every 13th lane made dead."""
    sc = nee_scene(lights, planes, env)
    ps = sc.pack(device=dev)
    settings = SceneSettings(max_bounce_count=6, sampling_strategy=strategy,
                             importance_sample_lights=importance,
                             use_mis=mis)
    s, rays = _initial(sc, settings, dev, w, h)
    f, st, stats = _entry_state(ps, settings, s, rays, sc.n_lights)
    for b in range(bounce):
        st, stats = _plain_bounce(ps, f, st, stats, b)
    lane = torch.arange(st.alive.shape[0], device=dev)
    st = st._replace(alive=st.alive & (lane % 13 != 7))
    return ps, f, _clone(st), stats


# (lights, planes, env, importance pick, MIS, strategy, bounce)
NEE_CASES = [(2, 1, False, True, True, S, 0), (2, 1, False, True, True, S, 1),
             (1, 1, False, True, True, U, 0), (1, 0, False, False, True, B, 1),
             (5, 2, False, True, True, B, 0), (5, 2, False, True, False, U, 1),
             (5, 0, True, True, True, S, 1), (2, 2, True, False, True, U, 0),
             (1, 1, True, True, False, B, 0), (2, 0, True, True, True, B, 1),
             (5, 1, False, False, True, S, 0), (2, 2, True, True, False, S, 1),
             (0, 1, True, True, True, S, 1), (0, 2, True, True, False, B, 0)]
NEE_IDS = [f"L{L}-P{P}-{'env' if e else 'noenv'}-"
           f"{'imp' if i else 'uni'}-{'mis' if m else 'nomis'}-{int(s)}-b{b}"
           for L, P, e, i, m, s, b in NEE_CASES]


@pytest.mark.parametrize("lights,planes,env,importance,mis,strategy,bounce",
                         NEE_CASES, ids=NEE_IDS)
def test_nee_lane_logic_matches_plain_on_host(host_lib, lights, planes, env,
                                              importance, mis, strategy,
                                              bounce):
    """csrc/nee.cuh's lanes, run on the host, against ``_nee_plain``: the
    live lanes' RNG state, the slot and every facing, occlusion and plane
    flag equal; the pick probability, the terms, the shadow wave's rays
    and t0 within 2e-5; and the whole bounce after it as in
    ``test_lane_logic_matches_plain_on_host``."""
    dev = torch.device("cpu")
    ps, f, st, stats = nee_state(lights, planes, env, importance, mis,
                                 strategy, bounce, dev)
    assert f.nee == (lights > 0) and f.env_nee == env
    assert int(ps.plane_d.shape[0]) == max(planes, 1)  # padded
    live = run_both(ps, f, st, stats, bounce, *host_fns(host_lib),
                    exact=False)
    assert live > 100


def test_threaded_walk_takes_the_shadow_wave(host_lib, monkeypatch):
    """Under ``BUAS_TRAVERSAL=threaded`` the card's NEE wave goes to the
    threaded oracle walk (no wide walk is called) and answers as the plain
    version's threaded shadow queries do."""
    monkeypatch.setenv("BUAS_TRAVERSAL", "threaded")
    dev = torch.device("cpu")
    ps, f, st, stats = nee_state(2, 1, True, True, True, S, 1, dev)
    assert ps.node_miss is not None
    hit = _hit(ps, st)
    a, sa, sha = adv._shade_hit_plain(ps, f, _clone(st), hit, stats.clone(),
                                      1)
    hit_fn, nee_fn, _ = host_fns(host_lib)
    b = _clone(st)
    scratch = hit_fn(ps, f, b, hit, stats.clone(), 1)
    nee = nee_fn(ps, f, b, scratch, 1)
    walks = []

    def no_wide(*args, **kw):
        raise AssertionError("the wide walk took a threaded wave")

    real = traverse._traverse_bvh

    def threaded(*args, **kw):
        walks.append(args[4].dtype)
        return real(*args, **kw)

    monkeypatch.setattr(traverse_wide.packet, "wide_traverse", no_wide)
    monkeypatch.setattr(traverse, "_traverse_bvh", threaded)
    nee = adv._shadow_walk(ps, nee)
    assert walks == [torch.int32] and nee.prim.dtype == torch.int32
    _, light, env = adv._nee_plain(ps, f, a.s, hit.p, sha.N, sha.nee_lanes, 1)
    n = st.alive.shape[0]
    occ = (nee.prim >= 0) | ((nee.flags & shade_kernel.WB_PLANE) != 0)
    assert torch.equal(occ[:n], light.occluded)
    assert torch.equal(occ[n:], env.occluded)
    assert 0 < int(light.occluded.sum()) and 0 < int(env.occluded.sum())


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_CASES = [(c, s, b) for c in FLAGS for s in (U, B, S) for b in (0, 1, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case,strategy,bounce", CARD_CASES,
    ids=[f"{c}-{int(s)}-b{b}" for c, s, b in CARD_CASES])
def test_kernels_bit_equal_plain_on_card(case, strategy, bounce):
    dev = _card()
    ps, f, st, stats = case_state(case, strategy, bounce, dev, 160, 120)
    before = trace.launch_totals()
    live = run_both(ps, f, st, stats, bounce, shade_kernel.shade_hit,
                    shade_kernel.nee_sample, shade_kernel.shade_next,
                    exact=True)
    after = trace.launch_totals()
    assert after["shade_hit"] == before["shade_hit"] + 1
    assert after["nee_sample"] == before["nee_sample"] + int(
        f.nee or f.env_nee)
    assert after["shade_next"] == before["shade_next"] + 1
    assert live > 1000


@pytest.mark.gpu
@pytest.mark.parametrize("lights,planes,env,importance,mis,strategy,bounce",
                         NEE_CASES, ids=NEE_IDS)
def test_nee_bit_equal_plain_on_card(lights, planes, env, importance, mis,
                                     strategy, bounce):
    """``nee_sample`` and the walk of its wave against ``_nee_plain`` bit
    for bit, and the bounce around them, on NEE's cases at 160x120."""
    dev = _card()
    ps, f, st, stats = nee_state(lights, planes, env, importance, mis,
                                 strategy, bounce, dev, 160, 120)
    live = run_both(ps, f, st, stats, bounce, shade_kernel.shade_hit,
                    shade_kernel.nee_sample, shade_kernel.shade_next,
                    exact=True)
    assert live > 1000


def patch_plain_bounce(monkeypatch):
    """Patch the Advanced loop's bounce to its plain version on the card:
    the shading and NEE (the hit record and the walks stay the card's)."""
    monkeypatch.setattr(adv, "_shade_hit", adv._shade_hit_plain)

    def nee_plain(ps, f, st, p, sh, bounce):
        s, light, env = adv._nee_plain(ps, f, st.s, p, sh.N, sh.nee_lanes,
                                       bounce)
        return st._replace(s=s), (light, env)

    def next_plain(ps, f, st, sh, nee, stats, bounce):
        return adv._shade_next_plain(ps, f, st, sh, *nee, stats, bounce)
    monkeypatch.setattr(adv, "_nee", nee_plain)
    monkeypatch.setattr(adv, "_shade_next", next_plain)


def _frame(dev, monkeypatch, plain):
    if plain:
        patch_plain_bounce(monkeypatch)
    sc = shade_scene(env=True)
    ps = sc.pack(device=dev)
    settings = SceneSettings(max_bounce_count=8, samples_per_pixel=1)
    s, rays = _initial(sc, settings, dev, 64, 48)
    with trace.frame() as rec:
        color, _, stats = adv.advanced(ps, settings, s, rays.o, rays.d,
                                       n_lights=sc.n_lights)
    monkeypatch.undo()
    return color, stats, rec


@pytest.mark.gpu
def test_frame_bit_equal_plain_on_card(monkeypatch):
    """A 64x48 Advanced pass (8 bounces, env NEE, glass inside glass):
    the kernels' colour and stats equal the plain version's; the record
    shows one shade_hit, one nee_sample and one shade_next a bounce
    run."""
    dev = _card()
    ck, sk, rec = _frame(dev, monkeypatch, plain=False)
    cp, sp, rec_p = _frame(dev, monkeypatch, plain=True)
    for a, b in zip(ck, cp):
        assert torch.equal(a, b)
    assert torch.equal(sk, sp)
    runs = len(rec.bounces)
    assert runs >= 3 and rec.bounces == rec_p.bounces
    assert rec.launches.get("shade_hit") == runs
    assert rec.launches.get("nee_sample") == runs
    assert rec.launches.get("shade_next") == runs
    assert "shade_hit" not in rec_p.launches
    assert "nee_sample" not in rec_p.launches


@pytest.mark.gpu
def test_caller_tensors_unchanged_on_card():
    dev = _card()
    sc = shade_scene(env=False)
    ps = sc.pack(device=dev)
    settings = _settings("default", S)
    s, rays = _initial(sc, settings, dev)
    keep = [x.clone() for x in (*rays.o, *rays.d, s.state, s.pre, s.x, s.y)]
    adv.advanced(ps, settings, s, rays.o, rays.d, n_lights=sc.n_lights)
    for a, b in zip(keep, (*rays.o, *rays.d, s.state, s.pre, s.x, s.y)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_per_ray_sample_index_raises_on_card():
    """A stratified sampler with a per-ray sample index has no first-bounce
    bases: on the card the integrator raises instead of falling back."""
    dev = _card()
    sc = shade_scene(env=False)
    ps = sc.pack(device=dev)
    settings = _settings("default", S)
    n = W * H
    px = (torch.arange(n) % W).to(dev)
    py = (torch.arange(n) // W).to(dev)
    s = smp.make_sampler(px, py, torch.full((n,), 3, device=dev),
                         strategy=int(S))
    _, rays = _initial(sc, settings, dev)
    with pytest.raises(ValueError, match="first-bounce bases"):
        adv.advanced(ps, settings, s, rays.o, rays.d, n_lights=sc.n_lights)
