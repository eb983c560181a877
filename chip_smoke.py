#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``buas_pathtracer_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, renders
small frames against the repository's golden images, renders the bench
frame (``bench.py``'s scene: 1920x1080, 1 spp, 8 bounces, Advanced
Pathtracer) through the kernels, times each kernel at the shapes that frame
gives it, then does the same for the big-scene path: the stress frame
(``BENCH_SCENE=stress``: 655,360 triangles, 1920x1080, 1 spp, 6 bounces)
through the split-table walk, and the dense triangle-stream entry point on
the bench scene.  Each traversal kernel is held to its plain version with
equal outputs and equal stats (rows read, triangle tests) on every wave; each
wave's record carries its time, bound, plain time, lane utilisation and the
kernel's registers and spills from nvcc's report.  The post and
triangle-stream records add an issue bound: the SASS instructions
(``cuobjdump -sass``) that the run's path issues per pixel or per
ray-triangle pair, at one warp instruction per clock per scheduler and the
SM clock nvidia-smi reports under load; the post kernel is timed by its
device time, with the L2 warm and flushed.  It prints one JSON line of
kernel records.  The last line of
standard output is ``{"ok": true, "device": {...}}``; any failed phase
raises and the script exits non-zero without that line.  Without a CUDA
card, or without the port's package beside it, it exits non-zero at once.

Imports nothing of JAX or of the JAX package ``buas_pathtracer_tpu``.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA data sheet), used for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

PARITY_RAYS = 65536
KERNEL_REPS = 20
PLAIN_REPS = 3


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms of ``fn`` over ``reps`` calls, timed with CUDA events after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps):
    """Mean ms of ``fn`` with a cold L2: before each call a 128 MB buffer
    (2.5x the H100's 50 MB L2) is written, then events are recorded around
    that call alone.  One warm-up call first."""
    import torch
    buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()
    pairs = []
    for _ in range(reps):
        buf.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def device_ms(fn, reps, kernel, flush=False):
    """Mean device time (ms) of the launches of CUDA kernels whose name
    holds ``kernel``, over ``reps`` calls of ``fn`` under torch.profiler:
    the kernel's own time on the card, whatever the host spends between
    launches.  ``flush``: a 128 MB buffer (2.5x the H100's 50 MB L2) is
    written before each call, so each launch finds a cold L2.  One
    warm-up call first.  None when the profiler records no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush:
                buf.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            total += us
            count += e.count
    return total / 1e3 / count if count else None


def sm_clock_under(fn, seconds=0.5):
    """Mean SM clock (MHz) that nvidia-smi reports every 100 ms while ``fn``
    runs back to back for ``seconds``; the sample taken before the load
    starts is dropped.  None when nvidia-smi gives no sample."""
    import torch
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "100"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        proc.stdout.readline()  # sampling has started
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    vals = [float(x) for x in out.split() if x.strip().isdigit()]
    return sum(vals) / len(vals) if vals else None


# ---------------------------------------------------------------------------
# SASS instruction counts (cuobjdump), for the issue bounds
# ---------------------------------------------------------------------------

SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
SASS_FUNC = re.compile(r"Function\s*:\s*(\S+)")
SASS_PARAM = re.compile(
    r"^U?LDC(?:\.64)?\s+(U?R\d+),\s*c\[0x0\]\[(0x[0-9a-f]+)\]")
SASS_CONST = re.compile(r"c\[0x0\]\[(0x[0-9a-f]+)\]")


def sass_functions(text):
    """``cuobjdump -sass`` text -> {kernel name: [(address, instruction)]}
    (the instruction without its trailing ';'; names as cuda_lib gives
    them)."""
    from buas_pathtracer_tpu_torch.ops.cuda_lib import _kernel_name
    out, cur = {}, None
    for line in text.splitlines():
        m = SASS_FUNC.search(line)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), [])
            continue
        m = SASS_LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def sass_path(ins, start, stop=None, params=None, vote=False, info=None):
    """The instructions one thread issues from address ``start`` until an
    unguarded EXIT or the instruction at ``stop`` (counted), NOPs left out.
    Branches: unguarded ones are followed; a guard is evaluated where its
    predicate is known: a comparison of a kernel parameter with zero (its
    value in ``params``, {constant-bank offset: value}), a VOTE.ANY
    (``vote``), or a float ``>= 0`` test (taken as true: the counted
    operands are finite and non-negative).  Other guards fall through,
    except a forward branch over a CALL (the IEEE division's slow path),
    which is taken.  ``info``, where given, receives "reads": the offsets
    of ``params`` that the path reads, and "unresolved": the addresses of
    the branches on the path whose guard derives from one of ``params``
    but could not be evaluated."""
    params = params or {}
    at = {a: i for i, (a, _) in enumerate(ins)}
    regs, preds, path = {}, {}, []
    # registers and predicates that derive from ``params`` in a way the
    # walk does not evaluate
    tainted, reads, unresolved = set(), set(), []
    i, steps = at[start], 0
    while i < len(ins) and steps < 200000:
        steps += 1
        addr, text = ins[i]
        guard = re.match(r"@(!?)(U?P\d)\s+", text)
        body = text[guard.end():] if guard else text
        op = body.split()[0] if body else ""
        if op != "NOP":
            path.append((addr, body))
        if addr == stop:
            break
        args = [a.strip() for a in body[len(op):].split(",")]
        consts = {int(c, 16) for c in SASS_CONST.findall(body)} & set(params)
        reads |= consts
        srcs = re.findall(r"U?R\d+|U?P\d", ", ".join(args[1:]))
        derived = bool(consts) or any(
            r in tainted or regs.get(r) in params for r in srcs)
        if args and re.fullmatch(r"U?R\d+", args[0]):
            regs.pop(args[0], None)  # overwritten
            tainted.discard(args[0])
        m = SASS_PARAM.match(body)
        if m:
            regs[m.group(1)] = int(m.group(2), 16)
            if ".64" in op:
                nxt = re.sub(r"\d+$", lambda x: str(int(x.group()) + 1),
                             m.group(1))
                regs[nxt] = int(m.group(2), 16) + 4
                reads |= {regs[nxt]} & set(params)
        elif op == "P2R" and len(args) == 4:
            # a predicate saved into a register (restored by a compare
            # of the register with zero)
            bit = int(args[3], 16)
            if bit and bit & (bit - 1) == 0:
                src = f"P{bit.bit_length() - 1}"
                regs[args[0]] = ("pred", preds.get(src))
                if src in tainted:
                    tainted.add(args[0])
        elif derived and args and re.fullmatch(r"U?R\d+", args[0]):
            tainted.add(args[0])
        dst = args[0] if args and re.fullmatch(r"U?P\d", args[0]) else None
        if dst:
            val = None
            if op.startswith("VOTE.ANY"):
                val = vote
            elif re.match(r"U?ISETP\.(NE|EQ)", op) and len(args) >= 4:
                a, b = args[2], args[3]
                reg = b if a in ("RZ", "URZ") else a
                c = SASS_CONST.fullmatch(reg)
                src = int(c.group(1), 16) if c else regs.get(reg)
                nz = None
                if isinstance(src, tuple):
                    nz = src[1]
                elif src in params:
                    nz = params[src] != 0
                if nz is not None and {a, b} & {"RZ", "URZ"}:
                    val = nz if ".NE" in op else not nz
            elif re.match(r"FSETP\.GEU?\.AND$", op) and len(args) >= 4 \
                    and args[3] == "RZ" and args[1] == "PT":
                val = True
            preds[dst] = val
            if val is None and derived:
                tainted.add(dst)
            else:
                tainted.discard(dst)
        taken = None
        if op in ("BRA", "EXIT"):
            if guard is None:
                taken = True
            else:
                v = preds.get(guard.group(2))
                if v is not None:
                    taken = v != (guard.group(1) == "!")
                elif guard.group(2) in tainted:
                    unresolved.append(addr)
        if op == "EXIT":
            if taken:
                break
            i += 1
            continue
        if op == "BRA":
            m = re.search(r"0x([0-9a-f]+)", body)
            target = int(m.group(1), 16) if m else None
            if taken is None:
                skipped = [t for a, t in ins[i + 1:] if target and a < target]
                taken = target is not None and target > addr and any(
                    t.split()[0].startswith("CALL") for t in skipped)
            if taken and target in at:
                i = at[target]
                continue
        i += 1
    if info is not None:
        info["reads"], info["unresolved"] = reads, unresolved
    return [t for _, t in path]


def sass_inner_loop(ins):
    """(start, back-edge address) of the innermost loop holding a MUFU.RCP:
    the per-pair test's reciprocal."""
    loops = []
    for i, (addr, text) in enumerate(ins):
        m = re.search(r"BRA\s+.*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            if any(t.startswith("MUFU.RCP") for a, t in ins
                   if lo <= a <= addr):
                loops.append((addr - lo, lo, addr))
    if not loops:
        return None
    _, lo, hi = min(loops)
    return lo, hi


def sass_report():
    """cuobjdump -sass of the loaded kernel library, split by kernel; None
    where the toolkit has no cuobjdump."""
    from buas_pathtracer_tpu_torch.ops import cuda_lib
    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", cuda_lib._so_path()],
                         capture_output=True, text=True, timeout=300)
    return sass_functions(out.stdout) if out.returncode == 0 else None


def k6_sass_counts(ins):
    """Instructions per (ray, triangle) pair in the stream kernel's inner
    loop: when every ray slot's vote finds no lane in play (the second half
    skipped) and when every vote finds one.  The pairs of one iteration are
    its MUFU.RCP (one reciprocal per pair)."""
    loop = sass_inner_loop(ins)
    if loop is None:
        return None
    culled = sass_path(ins, loop[0], stop=loop[1], vote=False)
    full = sass_path(ins, loop[0], stop=loop[1], vote=True)
    pairs = sum(t.startswith("MUFU.RCP") for t in culled)
    if pairs == 0:
        return None
    return {"culled": len(culled) / pairs, "full": len(full) / pairs,
            "pairs_per_iteration": pairs}


# post_rgba8_kernel's parameters in constant bank 0 on sm_90 start at
# 0x210: accum, tile and out (8 bytes each), n and w (4 each), then
# PostParams, whose five int flags follow its six floats (csrc/post.cu
# asserts that layout; tests/test_torch_post.py holds it to these names)
SM90_PARAM_BASE = 0x210
POST_PARAMS_AT = SM90_PARAM_BASE + 3 * 8 + 2 * 4
POST_FLAGS = ("exposure_on", "tonemapping", "srgb", "contrast_on", "dither")
POST_FLAG_OFFSETS = {k: POST_PARAMS_AT + 6 * 4 + 4 * i
                     for i, k in enumerate(POST_FLAGS)}


def k3_sass_count(ins, flags):
    """Per pixel, on the path one thread issues from entry to EXIT with the
    settings' flags (its pixels are its 16-byte accumulation loads): the
    instructions, and the fp32 operations among them (FADD, FMUL, FMNMX
    one each, FFMA two).  Raises unless the path reads every flag at its
    offset and evaluates every branch that depends on one: otherwise the
    offsets are stale and the path would count the wrong blocks."""
    params = {POST_FLAG_OFFSETS[k]: v for k, v in flags.items()}
    info = {}
    path = sass_path(ins, ins[0][0], params=params, info=info)
    missing = [k for k in POST_FLAGS if POST_FLAG_OFFSETS[k] not in
               info["reads"]]
    if missing or info["unresolved"]:
        raise AssertionError(
            f"post_rgba8_kernel's SASS: flags {missing} not read at their "
            f"offsets, branches on a flag not evaluated at "
            f"{[hex(a) for a in info['unresolved']]}: POST_FLAG_OFFSETS "
            f"does not match csrc/post.cu")
    pix = sum(t.startswith("LDG.E.128") for t in path)
    if not pix:
        raise AssertionError("post_rgba8_kernel's SASS path loads no pixel")
    ops = sum({"FADD": 1, "FMUL": 1, "FMNMX": 1, "FFMA": 2}.get(
        t.split()[0].split(".")[0], 0) for t in path)
    return {"per_pixel": len(path) / pix, "fp32_ops_per_pixel": ops / pix}


def post_flags(settings):
    """post_rgba8_launch's flags for a PostProcessSettings."""
    return dict(exposure_on=int(settings.exposure != 0.0),
                tonemapping=int(bool(settings.tonemapping)),
                srgb=int(bool(settings.srgb_transform)),
                contrast_on=int(settings.contrast != 0.0),
                dither=int(bool(settings.dither)))


def issue_ms(count, sms, mhz):
    """Time to issue ``count`` thread instructions at one warp instruction
    per clock on each of an SM's 4 schedulers."""
    return count / (sms * 4 * 32 * mhz * 1e6) * 1e3


# ---------------------------------------------------------------------------
# traversal parity
# ---------------------------------------------------------------------------

def compare_hits(out, ref, what):
    """Kernel vs plain outputs (t, prim, tri, bv, bw, stats): every output
    and both stats (rows read, triangle tests) equal.  The kernel pops each
    ray's rows in the plain walk's order, so not even a shared-edge tie may
    differ.  Returns the max |t| difference of finite t (0)."""
    t_o, t_r = out[0].cpu().numpy(), ref[0].cpu().numpy()
    p_o, p_r = out[1].cpu().numpy(), ref[1].cpu().numpy()
    tri_o, tri_r = out[2].cpu().numpy(), ref[2].cpu().numpy()
    n = t_o.size
    bad_prim = int((p_o != p_r).sum())
    bad_t = int((t_o.view(np.uint32) != t_r.view(np.uint32)).sum())
    fin = np.isfinite(t_o) & np.isfinite(t_r)
    err = float(np.abs(t_o[fin] - t_r[fin]).max()) if fin.any() else 0.0
    n_tri = int((tri_o != tri_r).sum())
    bary = [int((a.cpu().numpy().view(np.uint32)
                 != b.cpu().numpy().view(np.uint32)).sum())
            for a, b in zip(out[3:5], ref[3:5])]
    st_o, st_r = out[5].cpu().tolist(), ref[5].cpu().tolist()
    log(f"  {what}: rays {n}, hits {int((p_r >= 0).sum())}, prim mismatches "
        f"{bad_prim}, t mismatches {bad_t}, tri ties {n_tri}, bv/bw "
        f"mismatches {bary}, stats {st_o} vs plain {st_r}")
    if bad_prim or bad_t or n_tri or any(bary) or st_o != st_r:
        raise AssertionError(f"{what}: the kernel differs from the plain "
                             "version")
    return err


def record_waves(packet, walk, frame):
    """Run ``frame()`` once with ``packet.<walk>`` wrapped, keeping copies
    of the inputs of its first closest-hit call (the primary wave), its
    second (bounce-1) and its first occlusion call (shadow-0).  Returns
    {wave: (o, d, t0, ign, occlusion)}."""
    import torch
    real = getattr(packet, walk)
    waves, calls = {}, {"closest": 0, "occlusion": 0}

    def recorder(*args):
        o, d, t0_, ign, occlusion = args[-5:]
        mode = "occlusion" if occlusion else "closest"
        key = {("closest", 0): "primary", ("closest", 1): "bounce",
               ("occlusion", 0): "shadow"}.get((mode, calls[mode]))
        calls[mode] += 1
        if key is not None:
            waves[key] = (type(o)(*(c.clone() for c in o)),
                          type(d)(*(c.clone() for c in d)), t0_.clone(),
                          ign.clone(), occlusion)
        return real(*args)

    setattr(packet, walk, recorder)
    try:
        frame()
        torch.cuda.synchronize()
    finally:
        setattr(packet, walk, real)
    return waves


def ptxas_fields(report, kernel):
    """The build report's numbers for one kernel, as record fields."""
    r = report.get(kernel)
    if r is None:
        raise AssertionError(f"nvcc's report has no kernel {kernel}")
    return {"registers": r["registers"], "spill_stores": r["spill_stores"],
            "spill_loads": r["spill_loads"], "stack_frame": r["stack_frame"],
            "smem": r["smem"]}


def lane_util(walk_fn, args):
    """One more launch with the warp-step counter: rows read / (32 x warp
    steps that read a row), and the steps."""
    import torch
    steps = torch.zeros(1, dtype=torch.int64, device=args[-3].device)
    out = walk_fn(*args, steps=steps)
    rows = int(out[5][0])
    n_steps = int(steps[0])
    return (rows / (32 * n_steps) if n_steps else 0.0), n_steps


def parity_rays(ps, cam, w, h, dev):
    """Three sets of PARITY_RAYS rays: primary rays in tile order from the
    middle of the frame, incoherent random rays (60% dead), and shadow rays
    from primary hit points toward the lights (alternating)."""
    import torch
    from buas_pathtracer_tpu_torch.core.vec import EPSILON, Vec3, normalize
    from buas_pathtracer_tpu_torch.models.camera import camera_on, generate_rays
    from buas_pathtracer_tpu_torch.ops import packet
    from buas_pathtracer_tpu_torch.runtime.render import _tiled

    n = PARITY_RAYS
    gen = torch.Generator(device="cpu").manual_seed(7)
    py_, px_ = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    mid = (h * w) // 2 - n // 2
    px = _tiled(px_)[mid:mid + n].to(dev)
    py = _tiled(py_)[mid:mid + n].to(dev)
    z = torch.zeros(n, device=dev)
    pr = generate_rays(camera_on(cam, dev), px, py, w, h, z + 0.5, z + 0.5,
                       z, z, 0.0, 0.0, 6.0, 0.0, 0.0)
    big = torch.full((n,), 3.0e38, device=dev)
    none = torch.full((n,), -1, dtype=torch.int32, device=dev)
    sets = {"primary": (pr.o, pr.d, big, none)}

    lo, hi = ps.scene_lo.cpu(), ps.scene_hi.cpu()
    u = torch.rand((3, n), generator=gen)
    o = Vec3(*[(lo[k] + (hi[k] - lo[k]) * u[k]).to(dev) for k in range(3)])
    g = torch.randn((3, n), generator=gen)
    d = normalize(Vec3(g[0].to(dev), g[1].to(dev), g[2].to(dev)))
    dead = (torch.rand(n, generator=gen) < 0.6).to(dev)
    sets["incoherent_60pct_dead"] = (o, d, torch.where(dead, -1.0, big), none)

    hit = packet.wide_traverse(ps.wide_rows, ps.wide_depth, pr.o, pr.d, big,
                               none, False)
    t = torch.where(hit[1] >= 0, hit[0], 10.0)
    p = pr.o + pr.d * t
    which = torch.arange(n, device=dev) % ps.light16.shape[0]
    lights = ps.light16[which]  # (n, 16): fwd12 | r | emission
    lp = Vec3(lights[:, 3], lights[:, 7], lights[:, 11])
    jit = torch.randn((3, n), generator=gen).to(dev) * 0.5
    to_l = Vec3(lp.x + jit[0], lp.y + jit[1], lp.z + jit[2]) - p
    dist = torch.sqrt(to_l.x * to_l.x + to_l.y * to_l.y + to_l.z * to_l.z)
    ld = normalize(to_l)
    so = p + ld * EPSILON
    sets["shadow"] = (so, ld, dist - 2.0 * EPSILON,
                      ps.light_prim[which].to(torch.int32))
    return {k: tuple(x.contiguous() if isinstance(x, torch.Tensor) else
                     Vec3(*(c.contiguous() for c in x)) for x in v)
            for k, v in sets.items()}


# ---------------------------------------------------------------------------
# golden images
# ---------------------------------------------------------------------------

def golden_scene(name):
    from buas_pathtracer_tpu_torch.core import vec
    from buas_pathtracer_tpu_torch.models import camera as cm
    from buas_pathtracer_tpu_torch.models.scene import Scene
    from buas_pathtracer_tpu_torch.utils.procgen import icosphere
    if name == "spheres_advanced":  # tests/test_golden.py scene_spheres
        sc = Scene(name="g-spheres")
        grey = sc.add_diffuse_material((0.6, 0.6, 0.6), 1.2)
        red = sc.add_diffuse_material((0.8, 0.2, 0.2), 1.4)
        glass = sc.add_translucent_material((0.2, 0.1, 0.0), 1.5)
        li = sc.add_emissive_material((15, 14, 12))
        sc.add_plane(grey, (0, 1, 0), 0.0)
        sc.add_sphere(red, 1.0, vec.translate([-1.2, 1, 4]))
        sc.add_sphere(glass, 0.9, vec.translate([1.2, 0.9, 3]))
        sc.add_sphere(li, 0.6, vec.translate([0, 4, 2]))
        sc.top_sky_color = (0.4, 0.55, 0.8)
        sc.bot_sky_color = (0.9, 0.9, 0.9)
        sc.camera = cm.aim_camera_at(
            cm.make_camera(p=(0, 1.8, -3), vfov=np.radians(55), aspect=1.0),
            (0, 1.0, 3.5))
        return sc
    sc = Scene(name="g-mesh")  # tests/test_golden.py scene_mesh
    grey = sc.add_diffuse_material((0.55, 0.55, 0.55), 1.2, 0.0, True)
    blue = sc.add_diffuse_material((0.2, 0.3, 0.8), 1.4)
    li = sc.add_emissive_material((20, 20, 20))
    sc.add_plane(grey, (0, 1, 0), 0.0)
    sc.add_mesh(blue, icosphere(subdivisions=2),
                vec.translate([0, 1.2, 3]) * vec.scale(1.2))
    sc.add_box(grey, (0.5, 0.5, 0.5),
               vec.translate([1.8, 0.5, 4]) * vec.rotate_y(0.6))
    sc.add_sphere(li, 0.5, vec.translate([-2, 4, 1]))
    sc.camera = cm.aim_camera_at(
        cm.make_camera(p=(0, 2, -2.5), vfov=np.radians(55), aspect=1.0),
        (0.3, 1.0, 3.2))
    return sc


def image_agreement(img, ref):
    """Share of pixels outside rtol=atol=2e-3 and the mean relative error
    (tests/test_torch_render.py states the rule: at most 1% of pixels
    outside, mean relative error at most 1e-3)."""
    diff = np.abs(img - ref)
    out = (diff > 2e-3 + 2e-3 * np.abs(ref)).any(axis=-1)
    rel = float((diff / np.maximum(np.abs(ref), 1e-3)).mean())
    return float(out.mean()), rel


# ---------------------------------------------------------------------------
# frame breakdown
# ---------------------------------------------------------------------------

def frame_breakdown(frame, packet, walk, card, frame_ms, tag):
    """Two more frames.  The first times each call of ``packet.<walk>`` (the
    frame's traversal) on the host clock with a synchronise on both sides
    (the traversal's share of the frame).  The second runs under
    torch.profiler: device time by kernel name; its sum over ``frame_ms``
    (the unprofiled frame) is the device's busy share.  The profiled
    frame's own wall time is mostly profiler overhead and is printed only
    as that."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    real = getattr(packet, walk)
    spent = {"closest": [0.0, 0], "occlusion": [0.0, 0]}

    def timed(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a)
        torch.cuda.synchronize()
        acc = spent["occlusion" if a[-1] else "closest"]
        acc[0] += time.perf_counter() - t0
        acc[1] += 1
        return out

    setattr(packet, walk, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        setattr(packet, walk, real)
    trav = spent["closest"][0] + spent["occlusion"][0]
    log(f"{tag} host-timed frame {wall * 1e3:.3f} ms: traversal calls "
        f"{trav * 1e3:.3f} ms ({trav / wall * 100:.2f}%; closest "
        f"{spent['closest'][1]} calls {spent['closest'][0] * 1e3:.3f} ms, "
        f"occlusion {spent['occlusion'][1]} calls "
        f"{spent['occlusion'][0] * 1e3:.3f} ms), everything else "
        f"{(wall - trav) * 1e3:.3f} ms ({card})")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frame()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    if not rows:
        log(f"{tag} profiler: no device time recorded (not measured)")
        return
    rows.sort(reverse=True)
    dev_ms = sum(r[0] for r in rows)
    busy = dev_ms / frame_ms * 100
    log(f"{tag} profiled frame: device kernel time {dev_ms:.3f} ms in "
        f"{sum(r[1] for r in rows)} launches of {len(rows)} kernel names; "
        f"against frame_ms {frame_ms:.3f}: busy {busy:.2f}%, idle "
        f"{100 - busy:.2f}% (profiled wall {wall * 1e3:.1f} ms, profiler "
        f"overhead included) ({card})")
    for ms, count, key in rows[:15]:
        log(f"{tag}   {ms:9.3f} ms {count:6d}x {ms / dev_ms * 100:6.2f}%  "
            f"{key[:110]}")
    if busy > 105.0:  # device time cannot exceed the frame's wall time
        raise AssertionError(f"profiled device time {dev_ms:.3f} ms exceeds "
                             f"frame_ms {frame_ms:.3f} by more than 5%")


# ---------------------------------------------------------------------------
# the big-scene path: split tables
# ---------------------------------------------------------------------------

def compare_walks(out, ref, occlusion, what):
    """split_traverse vs wide_traverse on the same scene's unified table.
    Closest hit: prim and t equal, tri different only on exact-t ties
    (merged leaves test their triangles in another order), at most
    max(2, N/1000) rays.  Occlusion is any-hit: the same rays blocked."""
    p_o, p_r = out[1].cpu().numpy(), ref[1].cpu().numpy()
    n = p_o.size
    if occlusion:
        bad = int(((p_o >= 0) != (p_r >= 0)).sum())
        log(f"  {what}: rays {n}, blocked {int((p_r >= 0).sum())}, "
            f"blocked-state mismatches {bad}")
        if bad:
            raise AssertionError(f"{what}: occlusion differs")
        return
    t_o, t_r = out[0].cpu().numpy(), ref[0].cpu().numpy()
    tri_o, tri_r = out[2].cpu().numpy(), ref[2].cpu().numpy()
    bad_prim = int((p_o != p_r).sum())
    bad_t = int((t_o != t_r).sum())
    diff = tri_o != tri_r
    log(f"  {what}: rays {n}, hits {int((p_r >= 0).sum())}, prim mismatches "
        f"{bad_prim}, t mismatches {bad_t}, tri ties {int(diff.sum())}")
    if bad_prim or bad_t:
        raise AssertionError(f"{what}: prim/t differ from the unified walk")
    if int(diff.sum()) > max(2, n // 1000) or (diff & (t_o != t_r)).any():
        raise AssertionError(f"{what}: {int(diff.sum())} triangle mismatches")


def reset_launches():
    from buas_pathtracer_tpu_torch.ops import packet, post_kernel, tristream
    for counts in (packet.LAUNCHES, post_kernel.LAUNCHES, tristream.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_launches():
    from buas_pathtracer_tpu_torch.ops import packet, post_kernel, tristream
    return {**packet.LAUNCHES, **post_kernel.LAUNCHES, **tristream.LAUNCHES}


def run_stress(dev, card, report):
    """Phases 10-14: the stress frame through split_traverse.  Returns the
    kernel records and the frame numbers."""
    import torch
    from buas_pathtracer_tpu_torch.models.scenes import build_stress_scene
    from buas_pathtracer_tpu_torch.ops import packet
    from buas_pathtracer_tpu_torch.runtime import film, post
    from buas_pathtracer_tpu_torch.runtime.render import render_frame

    W, H = 1920, 1080
    mb = lambda x: x.numel() * 4 / 1e6  # noqa: E731

    # ---- 10. stress pack ----
    scene = build_stress_scene(W, H)
    t0 = time.perf_counter()
    ps = scene.pack(device=dev)
    pack_s = time.perf_counter() - t0
    split = ps.v4_res is not None
    log(f"[10] stress scene packed in {pack_s:.2f} s: unified rows "
        f"{ps.wide_rows.shape[0]} ({mb(ps.wide_rows):.2f} MB), depth "
        f"{ps.wide_depth}, wtri_nrm16 {mb(ps.wtri_nrm16):.2f} MB; split "
        f"chosen {split} (limit "
        f"{packet.RESIDENT_TABLE_LIMIT_BYTES / 1e6:.1f} MB)")
    if not split:
        raise AssertionError("the stress scene did not split its tables")
    log(f"[10] split tables: resident {ps.v4_res.shape[0]} rows "
        f"({mb(ps.v4_res):.2f} MB), leaf {ps.v4_leaf.shape[0]} rows "
        f"({mb(ps.v4_leaf):.2f} MB), together "
        f"{mb(ps.v4_res) + mb(ps.v4_leaf):.2f} MB")
    walk = (ps.v4_res, ps.v4_leaf, ps.wide_depth)

    # ---- 11. split parity: kernel vs plain, and vs the unified walk ----
    max_err = {"closest": 0.0, "occlusion": 0.0}
    for name, (o, d, t0_, ign) in parity_rays(ps, scene.camera, W, H,
                                              dev).items():
        for occ in (False, True):
            mode = "occlusion" if occ else "closest"
            out = packet.split_traverse(*walk, o, d, t0_, ign, occ)
            ref = packet.split_traverse_plain(*walk, o, d, t0_, ign, occ)
            torch.cuda.synchronize()
            err = compare_hits(out, ref, f"[11] {name}/{mode} "
                               "split_traverse vs plain")
            max_err[mode] = max(max_err[mode], err)
            uni = packet.wide_traverse(ps.wide_rows, ps.wide_depth, o, d, t0_,
                                       ign, occ)
            compare_walks(out, uni, occ, f"[11] {name}/{mode} split_traverse "
                          "vs wide_traverse on the unified table")

    # ---- 12. small stress frame: kernels vs plain versions ----
    settings = scene.settings
    small_cam = build_stress_scene(64, 64).camera

    def small():
        acc = film.new_accumulation_buffer(64, 64, dev)
        acc, _ = render_frame(ps, settings, small_cam, acc, 0, h=64, w=64,
                              n_lights=scene.n_lights, device=dev)
        return film.resolve(acc).cpu().numpy()

    real_st = packet.split_traverse
    img_k = small()
    packet.split_traverse = packet.split_traverse_plain
    try:
        img_p = small()
    finally:
        packet.split_traverse = real_st
    same = bool(np.array_equal(img_k, img_p))
    log(f"[12] 64x64 stress scene, {settings.max_bounce_count} bounces: "
        f"kernels vs plain identical {same}, max |diff| "
        f"{float(np.abs(img_k - img_p).max()):.3g}, mean "
        f"{float(img_k.mean()):.4f}")
    if not np.isfinite(img_k).all() or not same:
        raise AssertionError("small stress frame: kernels and plain differ")

    # ---- 13. stress frame ----
    accum = film.new_accumulation_buffer(H, W, dev)
    calls = {"closest": 0}

    def warm():  # warm-up frame, recording the path's wave inputs
        nonlocal accum
        accum, _ = render_frame(ps, settings, scene.camera, accum, 0, h=H,
                                w=W, n_lights=scene.n_lights, device=dev)

    waves = record_waves(packet, "split_traverse", warm)

    wave_calls = {"primary": 0, "bounce": 0, "shadow": 0}

    def wave_counter(res, leaf, depth, o, d, t0_, ign, occlusion):
        if occlusion:
            wave_calls["shadow"] += 1
        else:
            wave_calls["bounce" if calls["closest"] else "primary"] += 1
            calls["closest"] += 1
        return real_st(res, leaf, depth, o, d, t0_, ign, occlusion)

    def frames(pk, n, first):
        nonlocal accum
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f_i in range(n):
            calls["closest"] = 0
            accum, stats = render_frame(pk, settings, scene.camera, accum,
                                        first + f_i, h=H, w=W,
                                        n_lights=scene.n_lights, device=dev)
        rays = float(stats[0])  # syncs
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3, rays

    n_frames = 3
    reset_launches()
    packet.split_traverse = wave_counter
    try:
        frame_ms, rays = frames(ps, n_frames, 1)
    finally:
        packet.split_traverse = real_st
    image = post.post_process(accum, scene.post_settings, device=dev)
    torch.cuda.synchronize()
    launches = read_launches()
    hdr = film.resolve(accum)
    finite = bool(torch.isfinite(hdr).all())
    log(f"[13] stress frame {W}x{H}, 1 spp, {settings.max_bounce_count} "
        f"bounces: frame_ms {frame_ms:.3f}, rays_per_frame_M "
        f"{rays / 1e6:.4f}, Mrays/s {rays / frame_ms / 1e3:.3f} ({card})")
    log(f"[13] launches over {n_frames} frames + post: {launches}; waves "
        f"{wave_calls}; image {tuple(image.shape)} {image.dtype}, hdr "
        f"finite {finite}, mean hdr {float(hdr.mean()):.4f}")
    if (wave_calls["primary"] + wave_calls["bounce"]
            != launches["split_closest"]
            or wave_calls["shadow"] != launches["split_occlusion"]):
        raise AssertionError(f"wave calls {wave_calls} do not add up to the "
                             f"launches {launches}")
    if not (launches["split_closest"] > 0 and launches["split_occlusion"] > 0
            and launches["post_rgba8"] > 0):
        raise AssertionError(f"a kernel of the stress path never ran: "
                             f"{launches}")
    if launches["closest"] or launches["occlusion"]:
        raise AssertionError(f"wide_traverse ran on the split path: "
                             f"{launches}")
    if not finite or tuple(image.shape) != (H, W, 4):
        raise AssertionError("stress frame image is not finite / misshaped")

    # the same frames through wide_traverse on the unified table, in turns
    # with the split path on one card: split (above), unified, unified,
    # split, each over the same frame indices
    uni_ps = ps._replace(v4_res=None, v4_leaf=None)
    frames(uni_ps, 1, 0)  # warm-up
    reset_launches()
    uni_ms, uni_rays = frames(uni_ps, n_frames, 1)
    uni_launch = read_launches()
    if (uni_launch["split_closest"] or uni_launch["split_occlusion"]
            or not uni_launch["closest"]):
        raise AssertionError(f"unified stress frame launches {uni_launch}")
    uni_ms_b, _ = frames(uni_ps, n_frames, 1)
    split_ms_b, _ = frames(ps, n_frames, 1)
    log(f"[13] stress frame, in turns: split tables "
        f"({mb(ps.v4_res) + mb(ps.v4_leaf):.2f} MB) frame_ms {frame_ms:.3f}, "
        f"unified table ({mb(ps.wide_rows):.2f} MB, wide_traverse) "
        f"{uni_ms:.3f}, unified {uni_ms_b:.3f}, split {split_ms_b:.3f}; "
        f"rays {rays / 1e6:.4f} M split, {uni_rays / 1e6:.4f} M unified "
        f"({card})")
    frame_breakdown(lambda: render_frame(
        ps, settings, scene.camera, accum, 99, h=H, w=W,
        n_lights=scene.n_lights, device=dev), packet, "split_traverse", card,
        frame_ms, "[13]")

    # ---- 14. split_traverse times and bounds on the stress waves ----
    records = []
    res_bytes = ps.v4_res.numel() * 4
    for wave, k, line in (("primary", "K5", 1216), ("bounce", "K4", 616),
                          ("shadow", "K4", 616)):
        o, d, t0_, ign, occ = waves[wave]
        mode = "occlusion" if occ else "closest"
        n = int(t0_.shape[0])
        live = int((t0_ >= 0).sum())
        out = real_st(*walk, o, d, t0_, ign, occ)
        reads = torch.zeros(ps.v4_leaf.shape[0], dtype=torch.int64,
                            device=dev)
        ref = packet.split_traverse_plain(*walk, o, d, t0_, ign, occ,
                                          leaf_reads=reads)
        err = compare_hits(out, ref, f"[14] {wave} wave/{mode}")
        visits, tests = (int(x) for x in out[5].cpu())
        util, steps = lane_util(real_st, (*walk, o, d, t0_, ign, occ))
        leaf_rows = int((reads > 0).sum())
        leaf_pops = int(reads.sum())
        ms = cuda_ms(lambda: real_st(*walk, o, d, t0_, ign, occ), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: packet.split_traverse_plain(
            *walk, o, d, t0_, ign, occ), PLAIN_REPS)
        # the same wave through wide_traverse on the unified table: the
        # same hits (as in [11]), and its time beside the split walk's
        uni = packet.wide_traverse(ps.wide_rows, ps.wide_depth, o, d, t0_,
                                   ign, occ)
        compare_walks(out, uni, occ, f"[14] {wave} wave/{mode} vs unified")
        uni_kernel_ms = cuda_ms(lambda: packet.wide_traverse(
            ps.wide_rows, ps.wide_depth, o, d, t0_, ign, occ), KERNEL_REPS)
        # bytes: a live ray 52 B, a dead one 24 B (as wide_traverse); the
        # resident table once; each distinct leaf row the walk reads once,
        # 512 B; the stats.  operations: 12 fp32 per child slab, 8 children
        # per resident-row pop, and 45 per triangle test
        nbytes = live * 52 + (n - live) * 24 + res_bytes + leaf_rows * 512 + 16
        ops = (visits - leaf_pops) * 8 * 12 + tests * 45
        t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_PER_S * 1e3
        log(f"[14] split_traverse<{mode}> {wave} wave: {n} rays ({live} "
            f"live), rows read {visits} ({leaf_pops} leaf, {leaf_rows} "
            f"distinct leaf rows of {ps.v4_leaf.shape[0]}), tri tests {tests}"
            f", lane utilisation {util:.4f} ({steps} warp steps): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
            f"{max(t_b, t_o):.4f} ms (bytes {t_b:.4f}, operations "
            f"{t_o:.4f}); wide_traverse on the unified table "
            f"{uni_kernel_ms:.4f} ms (rows read {int(uni[5][0])}, tri tests "
            f"{int(uni[5][1])}); {wave_calls[wave]} calls in the timed "
            f"frames ({card})")
        records.append(dict(
            k=k, name=f"split_traverse<{mode}> {wave} wave", route="cuda",
            source="buas_pathtracer_tpu_torch/csrc/split_traverse.cu",
            replaces=f"buas_pathtracer_tpu/ops/pallas_packet.py:{line}",
            launches=launches[f"split_{mode}"],
            wave_launches=wave_calls[wave],
            parity="equal to plain (outputs and stats)",
            max_abs_err=max(err, max_err[mode]), ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations",
            library_ms=None, lane_util=util, warp_steps=steps,
            rows_read=visits, tri_tests=tests,
            **ptxas_fields(report, f"split_traverse_{mode}"),
            unified_wide_traverse_ms=uni_kernel_ms))
    info = {"stress_frame_ms": frame_ms, "stress_frame_ms_b": split_ms_b,
            "stress_unified_frame_ms": uni_ms,
            "stress_unified_frame_ms_b": uni_ms_b,
            "stress_rays_per_frame_M": rays / 1e6,
            "stress_pack_s": pack_s}
    return records, info


def vote_share(o, d, tris):
    """Share of the K6 kernel's warp votes that find a lane in play: for
    each group of 32 consecutive rays (one ray slot of a warp) and each
    non-padding triangle, whether any ray passes the det and u tests (the
    plain version's first half).  The cull skips the rest of the test for
    the others."""
    import torch
    from buas_pathtracer_tpu_torch.core.vec import Vec3
    from buas_pathtracer_tpu_torch.ops.tristream import first_half
    n = o.x.shape[0]
    g = -(-n // 32)
    pad = g * 32 - n
    col = [torch.nn.functional.pad(c, (0, pad))[:, None] for c in (*o, *d)]
    ro, rd = Vec3(*col[:3]), Vec3(*col[3:])
    live = tris[tris[:, 9] >= 0]
    passed = 0
    for c0 in range(0, live.shape[0], 256):
        ok = first_half(ro, rd, live[c0:c0 + 256].T[:, None, :])[-1]
        passed += int(ok.view(g, 32, -1).any(dim=1).sum())
    return passed / (g * max(1, live.shape[0]))


def run_tristream(ps, sets, card, report, sass):
    """Phase 15: the dense triangle-stream entry point on the bench scene's
    world triangles and its primary rays (the entry point's run, counted);
    then the same on the incoherent ray set.  Both held equal to the plain
    version, timed, and their vote pass shares and issue bounds computed.
    Returns the kernel record."""
    import torch
    from buas_pathtracer_tpu_torch.ops import packet, tristream

    tris = tristream.tris_from_rows(ps.wide_rows)
    o, d, _, _ = sets["primary"]
    n, n_tris = int(o.x.shape[0]), int(tris.shape[0])
    reset_launches()
    out = tristream.intersect_tristream(o, d, tris)  # the entry point's run
    torch.cuda.synchronize()
    launches = read_launches()["tristream_closest"]
    if launches != 1:
        raise AssertionError(f"tristream_closest launched {launches} times")
    big = torch.full((n,), 3.0e38, device=o.x.device)
    none = torch.full((n,), -1, dtype=torch.int32, device=o.x.device)
    w = packet.wide_traverse(ps.wide_rows, ps.wide_depth, o, d, big, none,
                             False)
    mesh = (w[1] >= 0) & (w[2] >= 0)
    agree = float((out[0] == w[0])[mesh].float().mean())
    log(f"[15] rays whose wide_traverse hit is a triangle: {int(mesh.sum())};"
        f" tristream t equal on {agree * 100:.3f}% of them (information)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # SASS instructions per pair of the inner loop, with every ray slot's
    # vote culled and with none; a run issues culled + share x (full -
    # culled) per pair, share being the votes that find a lane in play
    counts = k6_sass_counts(sass["tristream_closest"]) if sass else None
    log(f"[15] tristream_closest SASS instructions per pair: "
        f"{counts or 'not measured'}")
    per_set = {}
    for name in ("primary", "incoherent_60pct_dead"):
        o, d, _, _ = sets[name]
        if name != "primary":
            out = tristream.intersect_tristream(o, d, tris)
        ref = tristream.intersect_tristream_plain(o, d, tris)
        same = [bool(torch.equal(a, b)) for a, b in zip(out, ref)]
        hits = int((ref[1] >= 0).sum())
        log(f"[15] tristream_closest {name}: {n} rays x {n_tris} triangles, "
            f"hits {hits}, kernel vs plain equal (t, id, u, v) {same}")
        if not all(same):
            raise AssertionError(f"tristream_closest disagrees with its plain "
                                 f"version on the {name} rays")
        ms = cuda_ms(lambda: tristream.intersect_tristream(o, d, tris),
                     KERNEL_REPS)
        mhz = sm_clock_under(lambda: tristream.intersect_tristream(o, d, tris))
        share = vote_share(o, d, tris)
        issue = None
        if counts and mhz:
            per_pair = counts["culled"] + share * (counts["full"]
                                                   - counts["culled"])
            issue = issue_ms(n * n_tris * per_pair, sms, mhz)
        per_set[name] = dict(ms=ms, vote_share=share, sm_mhz=mhz,
                             issue_ms=issue)
        log(f"[15] tristream_closest {name}: kernel {ms:.4f} ms, vote pass "
            f"share {share:.5f}, SM clock {mhz} MHz, issue bound "
            f"{'not measured' if issue is None else f'{issue:.4f} ms'} "
            f"({card})")
    o, d, _, _ = sets["primary"]
    plain_ms = cuda_ms(lambda: tristream.intersect_tristream_plain(
        o, d, tris), PLAIN_REPS)
    # operations: 46 fp32 per ray-triangle test (csrc/tristream.cuh); bytes:
    # rays in (24 B) and out (16 B), the stream once
    t_o = n * n_tris * 46 / PEAK_FP32_PER_S * 1e3
    t_b = (n * 40 + n_tris * 40) / PEAK_BYTES_PER_S * 1e3
    prim = per_set["primary"]
    log(f"[15] tristream_closest: kernel {prim['ms']:.4f} ms, plain "
        f"{plain_ms:.2f} ms, bound {max(t_b, t_o):.4f} ms (operations "
        f"{t_o:.4f}, bytes {t_b:.4f}) ({card})")
    return dict(
        k="K6", name="tristream_closest", route="cuda",
        source="buas_pathtracer_tpu_torch/csrc/tristream.cu",
        replaces="buas_pathtracer_tpu/ops/pallas_tristream.py:35",
        launches=launches, path="entry point ops/tristream.intersect_tristream"
        " (not on a frame)", parity="equal to plain (t, id, u, v) on the "
        "primary and incoherent rays", max_abs_err=0.0, ms=prim["ms"],
        plain_ms=plain_ms, bound_ms=max(t_b, t_o),
        bound_by="bytes" if t_b >= t_o else "operations", library_ms=None,
        issue_ms=prim["issue_ms"] if prim["issue_ms"] else "not measured",
        sass_per_pair=counts or "not measured",
        vote_share=prim["vote_share"], sm_mhz=prim["sm_mhz"], sms=sms,
        incoherent={k: v if v is not None else "not measured"
                    for k, v in per_set["incoherent_60pct_dead"].items()},
        **ptxas_fields(report, "tristream_closest"),
        finish=ptxas_fields(report, "tristream_finish"))


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import buas_pathtracer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 2
    from dataclasses import replace

    from buas_pathtracer_tpu_torch import native
    from buas_pathtracer_tpu_torch.models.scene import (PostProcessSettings,
                                                        SceneSettings)
    from buas_pathtracer_tpu_torch.models.scenes import build_bench_scene
    from buas_pathtracer_tpu_torch.ops import cuda_lib, packet, post_kernel
    from buas_pathtracer_tpu_torch.runtime import film, post
    from buas_pathtracer_tpu_torch.runtime.render import render, render_frame

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # ---- 1. the card ----
    log(f"[1] device: {kind}; count {torch.cuda.device_count()}")
    log(f"[1] nvidia-smi: {card}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    cuda_lib.load()
    log(f"[2] CUDA kernels built ({len(cuda_lib.SOURCES)} nvcc in parallel "
        f"+ link) and loaded in {time.perf_counter() - t0:.2f} s")
    report = cuda_lib.build_report()
    for kname, r in sorted(report.items()):
        log(f"[2] nvcc -Xptxas -v {kname}: registers {r['registers']}, spill "
            f"stores {r['spill_stores']} B, spill loads {r['spill_loads']} B,"
            f" stack frame {r['stack_frame']} B, shared memory {r['smem']} B")
    for kname in ("wide_traverse_closest", "wide_traverse_occlusion",
                  "split_traverse_closest", "split_traverse_occlusion",
                  "tristream_closest", "tristream_finish",
                  "post_rgba8_kernel"):
        ptxas_fields(report, kname)  # fails when the report lacks one
    sass = sass_report()
    log(f"[2] cuobjdump -sass: "
        f"{'%d kernels' % len(sass) if sass else 'not available'}")
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("native builders unavailable (g++)")
    log(f"[2] native builders built+loaded in {time.perf_counter() - t0:.2f} s")

    # ---- 3. traversal parity on the bench-scene table ----
    W, H = 1920, 1080
    scene = build_bench_scene(W, H)
    t0 = time.perf_counter()
    ps = scene.pack(device=dev)
    log(f"[3] bench scene packed in {time.perf_counter() - t0:.2f} s: rows "
        f"{tuple(ps.wide_rows.shape)} ({ps.wide_rows.numel() * 4 / 1e6:.2f} "
        f"MB), depth {ps.wide_depth}, lights {scene.n_lights}")
    sets = parity_rays(ps, scene.camera, W, H, dev)
    max_err = {"closest": 0.0, "occlusion": 0.0}
    for name, (o, d, t0_, ign) in sets.items():
        for occ in (False, True):
            mode = "occlusion" if occ else "closest"
            out = packet.wide_traverse(ps.wide_rows, ps.wide_depth, o, d,
                                       t0_, ign, occ)
            ref = packet.wide_traverse_plain(ps.wide_rows, ps.wide_depth, o,
                                             d, t0_, ign, occ)
            torch.cuda.synchronize()
            err = compare_hits(out, ref, f"[3] {name}/{mode}")
            max_err[mode] = max(max_err[mode], err)

    # ---- 4. post parity ----
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 4, (H, W, 4)).astype(np.float32)
    a[..., 3] = rng.uniform(0.5, 8, (H, W))
    a[3, 7] = np.nan           # cyan path
    a[9, 11, 3] = -1.0         # magenta path
    a[0, 0, 3] = 0.0           # zero-weight path
    a[500:504, 900:910, 3] = 0.0
    accum_t = torch.from_numpy(a).to(dev)
    tile = post.dither_tile(dev)
    post_err = 0
    for st in (PostProcessSettings(),
               PostProcessSettings(exposure=0.7, contrast=0.4, midpoint=0.4),
               PostProcessSettings(tonemapping=False, srgb_transform=False,
                                   dither=False)):
        k = post_kernel.post_rgba8(accum_t, tile, st)
        p = post_kernel.post_rgba8_plain(accum_t, tile, st)
        diff = (k.to(torch.int16) - p.to(torch.int16)).abs()
        mx = int(diff.max())
        same = float((diff == 0).float().mean())
        log(f"[4] post {st}: max |diff| {mx} LSB, identical {same * 100:.5f}%")
        if mx > 1 or same < 0.9999:
            raise AssertionError("post_rgba8 disagrees with its plain version")
        post_err = max(post_err, mx)

    # ---- 5. small frames: kernels vs plain versions, and the goldens ----
    small = build_bench_scene(64, 64)
    small.settings = replace(small.settings, max_bounce_count=4)
    img_k, _, _ = render(small, 64, 64, frames=1, device=dev)
    real_wt = packet.wide_traverse
    packet.wide_traverse = packet.wide_traverse_plain
    try:
        img_p, _, _ = render(small, 64, 64, frames=1, device=dev)
    finally:
        packet.wide_traverse = real_wt
    same = bool(np.array_equal(img_k, img_p))
    log(f"[5] 64x64 bench scene, 4 bounces: kernels vs plain identical "
        f"{same}, max |diff| {float(np.abs(img_k - img_p).max()):.3g}")
    if not np.isfinite(img_k).all() or not same:
        raise AssertionError("small frame: kernels and plain versions differ")
    for gname in ("spheres_advanced", "mesh_advanced"):
        ref = np.load(os.path.join(HERE, "tests", "goldens",
                                   f"{gname}.npz"))["hdr"]
        sc = golden_scene(gname)
        sc.settings = SceneSettings(samples_per_pixel=1, max_bounce_count=4)
        img, _, _ = render(sc, 32, 32, frames=8, device=dev)
        frac, rel = image_agreement(img, ref)
        log(f"[5] golden {gname} 32x32x8: pixels outside 2e-3 {frac * 100:.2f}"
            f"%, mean rel err {rel:.3g}")
        if not np.isfinite(img).all() or frac > 0.01 or rel > 1e-3:
            raise AssertionError(f"golden {gname} disagrees")

    # ---- 6. bench frame ----
    settings = scene.settings
    accum = film.new_accumulation_buffer(H, W, dev)
    calls = {"closest": 0}

    def warm():  # warm-up frame, recording the main path's wave inputs
        nonlocal accum
        accum, _ = render_frame(ps, settings, scene.camera, accum, 0, h=H,
                                w=W, n_lights=scene.n_lights, device=dev)

    waves = record_waves(packet, "wide_traverse", warm)

    # the timed frames count each wave kind's calls (the first closest-hit
    # call of a frame is its primary wave); the kernels' own launch counters
    # count per instantiation
    wave_calls = {"primary": 0, "bounce": 0, "shadow": 0}

    def wave_counter(rows, depth, o, d, t0_, ign, occlusion):
        if occlusion:
            wave_calls["shadow"] += 1
        else:
            wave_calls["bounce" if calls["closest"] else "primary"] += 1
            calls["closest"] += 1
        return real_wt(rows, depth, o, d, t0_, ign, occlusion)

    frames = 3
    reset_launches()
    packet.wide_traverse = wave_counter
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f_i in range(frames):
            calls["closest"] = 0
            accum, stats = render_frame(ps, settings, scene.camera, accum,
                                        f_i + 1, h=H, w=W,
                                        n_lights=scene.n_lights, device=dev)
        rays = float(stats[0])  # syncs
        torch.cuda.synchronize()
        frame_s = (time.perf_counter() - t0) / frames
    finally:
        packet.wide_traverse = real_wt
    image = post.post_process(accum, scene.post_settings, device=dev)
    torch.cuda.synchronize()
    launches = read_launches()
    hdr = film.resolve(accum)
    finite = bool(torch.isfinite(hdr).all())
    log(f"[6] bench frame {W}x{H}, 1 spp, 8 bounces: frame_ms "
        f"{frame_s * 1e3:.3f}, rays_per_frame_M {rays / 1e6:.4f}, Mrays/s "
        f"{rays / frame_s / 1e6:.3f} ({card})")
    if (wave_calls["primary"] + wave_calls["bounce"] != launches["closest"]
            or wave_calls["shadow"] != launches["occlusion"]):
        raise AssertionError(f"wave calls {wave_calls} do not add up to the "
                             f"launches {launches}")
    log(f"[6] launches over {frames} frames + post: {launches}; waves "
        f"{wave_calls}; image "
        f"{tuple(image.shape)} {image.dtype}, hdr finite {finite}, "
        f"mean hdr {float(hdr.mean()):.4f}")
    if not (launches["closest"] > 0 and launches["occlusion"] > 0
            and launches["post_rgba8"] > 0):
        raise AssertionError(f"a kernel of the main path never ran: {launches}")
    if launches["split_closest"] or launches["split_occlusion"]:
        raise AssertionError(f"split_traverse ran on the bench frame: "
                             f"{launches}")
    if not finite or tuple(image.shape) != (H, W, 4):
        raise AssertionError("bench frame image is not finite / misshaped")

    # ---- 7. kernel times at the main-path shapes ----
    records = []
    table_bytes = ps.wide_rows.numel() * 4
    for wave, k, replaces in (
            ("primary", "K1", "buas_pathtracer_tpu/ops/pallas_packet.py:406"),
            ("bounce", "K2", "buas_pathtracer_tpu/ops/pallas_packet.py:639"),
            ("shadow", "K2", "buas_pathtracer_tpu/ops/pallas_packet.py:639")):
        o, d, t0_, ign, occ = waves[wave]
        mode = "occlusion" if occ else "closest"
        n = int(t0_.shape[0])
        live = int((t0_ >= 0).sum())
        out = real_wt(ps.wide_rows, ps.wide_depth, o, d, t0_, ign, occ)
        ref = packet.wide_traverse_plain(ps.wide_rows, ps.wide_depth, o, d,
                                         t0_, ign, occ)
        err = compare_hits(out, ref, f"[7] {wave} wave/{mode}")
        visits, tests = (int(x) for x in out[5].cpu())
        util, steps = lane_util(real_wt, (ps.wide_rows, ps.wide_depth, o, d,
                                          t0_, ign, occ))
        ms = cuda_ms(lambda: real_wt(ps.wide_rows, ps.wide_depth, o, d, t0_,
                                     ign, occ), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: packet.wide_traverse_plain(
            ps.wide_rows, ps.wide_depth, o, d, t0_, ign, occ), PLAIN_REPS)
        # bytes: a live ray reads o, d, t0, ign (32 B), a dead one (t0 < 0)
        # only t0 (4 B); every ray writes 20 B; the table and the stats
        # once.  operations: fp32 arithmetic of this wave's visits (12 per
        # child slab, 8 children) and triangle tests (45 each)
        nbytes = live * 52 + (n - live) * 24 + table_bytes + 16
        ops = visits * 8 * 12 + tests * 45
        t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_PER_S * 1e3
        log(f"[7] wide_traverse<{mode}> {wave} wave: {n} rays ({live} live), "
            f"visits {visits}, tri tests {tests}, lane utilisation "
            f"{util:.4f} ({steps} warp steps): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, bound {max(t_b, t_o):.4f} ms (bytes "
            f"{t_b:.4f}, operations {t_o:.4f}), {wave_calls[wave]} calls "
            f"in the timed frames ({card})")
        # one instantiation serves the primary (K1) and bounce (K2) waves:
        # "launches" is that instantiation's counter, "wave_launches" the
        # timed frames' calls of this wave kind
        records.append(dict(
            k=k, name=f"wide_traverse<{mode}> {wave} wave", route="cuda",
            source="buas_pathtracer_tpu_torch/csrc/wide_traverse.cu",
            replaces=replaces, launches=launches[mode],
            wave_launches=wave_calls[wave],
            parity="equal to plain (outputs and stats)",
            max_abs_err=max(err, max_err[mode]), ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations",
            library_ms=None, lane_util=util, warp_steps=steps,
            rows_read=visits, tri_tests=tests,
            **ptxas_fields(report, f"wide_traverse_{mode}")))
    # K7 (the v1 kernel) computes K1's function: the same instantiation on
    # the same primary wave serves it
    records.append(dict(
        records[0], k="K7", name="wide_traverse<closest> primary wave (K7)",
        replaces="buas_pathtracer_tpu/ops/pallas_packet.py:71"))
    post_in = accum.contiguous()

    def post_fn():
        return post_kernel.post_rgba8(post_in, tile, scene.post_settings)

    # ms and ms_cold_l2: CUDA events around back-to-back calls, and around
    # each call alone after an L2 flush; the kernel takes less time than the
    # wrapper's host work, so these hold host time too.  device_ms and
    # device_ms_cold_l2: the kernel's own time on the card (torch.profiler),
    # L2 warm and flushed
    ms = cuda_ms(post_fn, KERNEL_REPS)
    ms_cold = cuda_ms_cold(post_fn, 50)
    dev_ms = device_ms(post_fn, 50, "post_rgba8")
    dev_cold = device_ms(post_fn, 50, "post_rgba8", flush=True)
    if dev_ms is None or dev_cold is None:
        raise AssertionError("the profiler recorded no post_rgba8 launch")
    plain_ms = cuda_ms(lambda: post_kernel.post_rgba8_plain(
        post_in, tile, scene.post_settings), PLAIN_REPS)
    k_img = post_kernel.post_rgba8(post_in, tile, scene.post_settings)
    p_img = post_kernel.post_rgba8_plain(post_in, tile, scene.post_settings)
    frame_err = int((k_img.to(torch.int16) - p_img.to(torch.int16)).abs().max())
    if frame_err > 1:
        raise AssertionError("post_rgba8 disagrees on the bench frame")
    # bytes: accumulation in (16 B) and RGBA out (4 B) per pixel, the tile
    # once; operations: the fp32 operations on the SASS path of these
    # settings (k3_sass_count), not measured without cuobjdump
    pcount = (k3_sass_count(sass["post_rgba8_kernel"],
                            post_flags(scene.post_settings))
              if sass else None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = sm_clock_under(post_fn)
    nbytes = H * W * 20 + 64 * 64 * 3 * 4
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = (H * W * pcount["fp32_ops_per_pixel"] / PEAK_FP32_PER_S * 1e3
           if pcount else None)
    bound = max(t_b, t_o or 0.0)
    issue = (issue_ms(H * W * pcount["per_pixel"], sms, mhz)
             if pcount and mhz else None)
    log(f"[7] post_rgba8 {W}x{H}: kernel {ms:.4f} ms (events around "
        f"back-to-back calls), {ms_cold:.4f} ms (events around each call, "
        f"L2 cold), device time {dev_ms:.4f} ms (L2 warm), {dev_cold:.4f} ms"
        f" (L2 cold), plain {plain_ms:.3f} ms, bound {bound:.4f} ms (bytes "
        f"{t_b:.4f}, operations "
        f"{'not measured' if t_o is None else f'{t_o:.4f}'}), SASS per "
        f"pixel {pcount or 'not measured'}, SM clock {mhz} MHz, issue bound "
        f"{'not measured' if issue is None else f'{issue:.4f} ms'}, "
        f"max |diff| {frame_err} LSB ({card})")
    records.append(dict(
        k="K3", name="post_rgba8", route="cuda",
        source="buas_pathtracer_tpu_torch/csrc/post.cu",
        replaces="buas_pathtracer_tpu/ops/pallas_post.py:32",
        launches=launches["post_rgba8"], parity="within 1 LSB of plain",
        max_abs_err=max(post_err, frame_err),
        ms=ms, ms_cold_l2=ms_cold, device_ms=dev_ms,
        device_ms_cold_l2=dev_cold, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes" if t_o is None or t_b >= t_o else "operations",
        bound_bytes_ms=t_b,
        bound_operations_ms=t_o if t_o is not None else "not measured",
        library_ms=None,
        issue_ms=issue if issue is not None else "not measured",
        sass_per_pixel=pcount or "not measured", sm_mhz=mhz, sms=sms,
        **ptxas_fields(report, "post_rgba8_kernel")))

    # ---- 8. where the bench frame's time goes ----
    frame_breakdown(lambda: render_frame(
        ps, settings, scene.camera, accum, 99, h=H, w=W,
        n_lights=scene.n_lights, device=dev), packet, "wide_traverse", card,
        frame_s * 1e3, "[8]")

    # ---- 10-14. the stress frame through the split tables ----
    stress_records, stress = run_stress(dev, card, report)
    records += stress_records

    # ---- 15. the dense triangle stream on the bench scene ----
    records.append(run_tristream(ps, sets, card, report, sass))

    # ---- 16. records ----
    records.sort(key=lambda r: r["k"])
    log(f"[16] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records, "frame_ms": frame_s * 1e3,
                      "rays_per_frame_M": rays / 1e6, **stress,
                      "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
