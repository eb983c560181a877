#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --shade    # the shading kernels alone ([16])
    python3 chip_smoke.py --hit      # the hit record alone ([16h])
    python3 chip_smoke.py --nee      # NEE's kernel alone ([16n])

Builds the port's CUDA kernels from ``buas_pathtracer_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, renders
small frames against the repository's golden images, renders the bench
frame (``bench.py``'s scene: 1920x1080, 1 spp, 8 bounces, Advanced
Pathtracer) through the kernels, times each kernel at the shapes that frame
gives it, and the bounce's two shading kernels at bounces 0 and 1 of that
frame against their plain version ([16]; ``--shade`` runs only these after
the build), then does the same for the big-scene path: the stress frame
(``BENCH_SCENE=stress``: 655,360 triangles, 1920x1080, 1 spp, 6 bounces)
through the split-table walk, the closest-hit queries' hit record
(``hit_record``) at bounces 0 and 1 of the bench and stress frames against
its plain version ([16h]; ``--hit`` runs only these after the build), and
the dense triangle-stream entry point on the bench scene.  NEE's kernel
(``nee_sample``), the walk of its wave and ``shade_next`` are held to their
plain version at bounces 0 and 1 of the bench, stress and hero frames and
timed ([16n]; ``--nee`` runs only these and the hero frame against its
plain version after the build).  Then the
integrator layer: the env-lit hero frame (``tools/hero_render.py``'s scene
with ``gallery/hero_sky.hdr``, 1920x1080, 8 bounces, env NEE) packed and
rendered through ``device=None``, with its bounces' live counts, its
breakdown, its waves held to the plain walk and one frame held bit for bit
to the same frame with the plain shading and NEE; Whitted, Ground Truth,
Normals and Distances at 1080p and the Whitted and Normals goldens;
the blue-noise sampler built on the card equal to the CPU's, and a bench
frame with it.  Then the session layer: the twelve built-in scenes through
``load_scene`` and ``ProgressiveRenderer(device=None)`` at 1920x1080,
without their asset files and with synthetic ones written at run time
(each at 64x36 identical through the kernels and the plain versions, the
waves of three held to the plain walk); a 16 spp Cornell Box
``take_picture`` interrupted and resumed from its checkpoint, bit-identical
to an uninterrupted one; the CLI in a subprocess, its PNG equal to the
in-process render's; and the viewer on an ephemeral port, its focus pick
equal to the plain walk's t.  Then row-sharded rendering
(``parallel/mesh.py``): the bench frame through ``ShardedRenderer`` on a
world of one rank over NCCL, and the bench, hero and stress frames over 2
ranks and a 1920x32 Lanczos-12 bench frame over 4 ranks that share the
card over gloo, one process a rank, each gathered image bit-equal to the
single-device frame on the card; and the native OBJ parser and HDR decoder
against the Python ones on the synthetic assets, and a 64x64 bench frame
through the threaded oracle walk (``BUAS_TRAVERSAL=threaded``) against the
kernel frame.  Each traversal kernel is held to its plain version with
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

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
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
# synthetic stand-ins for the built-in scenes' asset files
# ---------------------------------------------------------------------------

ASSET_MESH = "dragon_mcguire.obj"
# the three skies and the sun direction of each stand-in
ASSET_SKIES = {"ballroom_2k.hdr": (0.4, 0.6, 0.2),
               "boiler_room_2k.hdr": (-0.5, 0.5, 0.3),
               "epping_forest_02_2k.hdr": (0.2, 0.8, -0.4)}


def obj_text(mesh):
    """OBJ text of an icosphere: its shared vertices, their unit normals
    (the vertices lie on a sphere about the origin) and v//vn faces, every
    float written as the repr of its float64 value, so that any parser
    rounds it to the same float32."""
    verts, inv = np.unique(mesh.triangles.reshape(-1, 3), axis=0,
                           return_inverse=True)
    v64 = verts.astype(np.float64)
    nrm = v64 / np.linalg.norm(v64, axis=1, keepdims=True)
    faces = inv.reshape(-1, 3) + 1
    return "\n".join(
        [f"v {x!r} {y!r} {z!r}" for x, y, z in v64.tolist()]
        + [f"vn {x!r} {y!r} {z!r}" for x, y, z in nrm.tolist()]
        + [f"f {a}//{a} {b}//{b} {c}//{c}" for a, b, c in faces.tolist()]
    ) + "\n"


def write_synthetic_assets(data_dir, subdivisions, sky_h, sky_w):
    """Write stand-ins for the built-in scenes' asset files into
    ``data_dir``: the mesh as an icosphere of 20 * 4**subdivisions
    triangles with vertex normals, the skies as procedural equirect HDRs of
    sky_h x sky_w.  Returns the mesh's triangle count."""
    from buas_pathtracer_tpu_torch.utils.image import (procedural_sky_hdr,
                                                       write_hdr)
    from buas_pathtracer_tpu_torch.utils.procgen import icosphere
    os.makedirs(data_dir, exist_ok=True)
    mesh = icosphere(subdivisions=subdivisions)
    with open(os.path.join(data_dir, ASSET_MESH), "w") as f:
        f.write(obj_text(mesh))
    for name, sun in ASSET_SKIES.items():
        write_hdr(os.path.join(data_dir, name),
                  procedural_sky_hdr(sky_h, sky_w, sun_dir=sun))
    return mesh.triangle_count


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


_LAUNCH_BASE = {}


def reset_launches():
    """Start counting the port's kernel launches (the tracer's
    process totals) from here."""
    from buas_pathtracer_tpu_torch.utils import trace
    _LAUNCH_BASE.update(trace.launch_totals())


def read_launches():
    """The port's kernel launches since ``reset_launches``, by kernel."""
    from buas_pathtracer_tpu_torch.utils import trace
    return {k: n - _LAUNCH_BASE.get(k, 0)
            for k, n in trace.launch_totals().items()}


# bytes one lane of each class moves through the shading kernels, read and
# written (csrc/shade.cu's note; the material, light and environment rows
# come from cache and are not counted).  shade_hit: a dead lane reads its
# alive flag and writes two codes; a live lane that missed reads its ray,
# throughput, total, flags, RNG state and hit id and writes its total, RNG
# state and codes; a lane with a hit also reads the hit record, stack index
# and two stack entries and writes its throughput and normal, then its
# branch's scratch; a push writes one stack entry and the index.  At bounce
# 0 each live lane reads its first-bounce base pair.  shade_next: a dead
# lane reads its flag; a path that ends reads its code, RNG state and
# throughput; a path that goes on reads its normal and its branch's scratch
# and writes its ray, normal, throughput, flag and RNG state; a lane whose
# light sample faced it reads NEE's terms and updates its total.
SHADE_HIT_BYTES = dict(dead=3, missed=76, found=160, reflect=36, refract=24,
                       diffuse=12, push=16, base=8)
SHADE_NEXT_BYTES = dict(dead=1, ends=31, reflect=127, refract=115,
                        diffuse=116, facing=53, base=16)


def clone_state(st):
    """A deep copy of an ``advanced._State``, one tensor a field."""
    from buas_pathtracer_tpu_torch.core.vec import Vec3

    def v(x):
        return Vec3(*(c.clone() for c in x))
    return st._replace(
        alive=st.alive.clone(), o=v(st.o), d=v(st.d), tp=v(st.tp),
        total=v(st.total), s=st.s._replace(state=st.s.state.clone()),
        stack=st.stack.clone(), stack_at=st.stack_at.clone(),
        is_spec=st.is_spec.clone(), prev_n=v(st.prev_n))


def states_equal(a, b, entry, what):
    """Raise unless the two states are equal bit for bit (the RNG state on
    the lanes alive at the bounce's entry)."""
    import torch
    for name in ("alive", "stack", "stack_at", "is_spec"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"{what}: {name} differs")
    if not torch.equal(a.s.state[entry], b.s.state[entry]):
        raise AssertionError(f"{what}: the live lanes' RNG state differs")
    for name in ("total", "tp", "o", "d", "prev_n"):
        for c, x, y in zip("xyz", getattr(a, name), getattr(b, name)):
            if not torch.equal(x, y):
                raise AssertionError(
                    f"{what}: {name}.{c} differs in "
                    f"{int((x != y).sum())} lanes")


def record_bounces(ps, scene, dev, W=1920, H=1080):
    """Render one frame with ``advanced._shade_hit`` wrapped, keeping the
    inputs of bounces 0 and 1: {bounce: (flags, state, hit, stats)}."""
    import torch
    from buas_pathtracer_tpu_torch.integrators import advanced as adv
    from buas_pathtracer_tpu_torch.runtime import film
    from buas_pathtracer_tpu_torch.runtime.render import render_frame

    inputs = {}
    real_hit = adv._shade_hit

    def record(ps_, f, st, hit, stats, bounce):
        if bounce in (0, 1) and bounce not in inputs:
            inputs[bounce] = (f, clone_state(st), hit, stats.clone())
        return real_hit(ps_, f, st, hit, stats, bounce)

    adv._shade_hit = record
    try:
        accum = film.new_accumulation_buffer(H, W, dev)
        render_frame(ps, scene.settings, scene.camera, accum, 7, h=H, w=W,
                     n_lights=scene.n_lights, device=dev)
        torch.cuda.synchronize()
    finally:
        adv._shade_hit = real_hit
    return inputs


def run_shade(ps, scene, dev, card, report, W=1920, H=1080):
    """[16] The shading kernels at the bench frame's shapes: the inputs of
    bounces 0 and 1 recorded from a frame, each kernel held bit for bit to
    the plain version (``shade_next`` after ``nee_sample`` and the walk,
    which [16n] holds), timed (its own device time under the profiler, and
    CUDA events around the wrapper) beside the plain version's time and its
    byte bound."""
    import torch
    from buas_pathtracer_tpu_torch.integrators import advanced as adv
    from buas_pathtracer_tpu_torch.ops import shade_kernel

    inputs = record_bounces(ps, scene, dev, W, H)
    records = []
    for b in (0, 1):
        f, st0, hit, stats0 = inputs[b]
        n = int(st0.alive.shape[0])
        entry = st0.alive.clone()
        a = clone_state(st0)
        a, sa, sha = adv._shade_hit_plain(ps, f, a, hit, stats0.clone(), b)
        k = clone_state(st0)
        sk = stats0.clone()
        scratch = shade_kernel.shade_hit(ps, f, k, hit, sk, b)
        states_equal(a, k, entry, f"[16] shade_hit bounce {b}")
        lanes = sha.nee_lanes
        if not (torch.equal(sa, sk) and torch.equal(
                lanes, shade_kernel.nee_lanes(scratch)) and all(
                torch.equal(x[lanes], y[lanes]) for x, y in zip(
                    sha.N, shade_kernel.normal(scratch)))):
            raise AssertionError(f"[16] shade_hit bounce {b}: stats, NEE "
                                 f"lanes or normals differ")
        s, light, env = adv._nee_plain(ps, f, a.s, hit.p, sha.N, lanes, b)
        a_hit, sa_hit = a, sa.clone()
        a2, sa = adv._shade_next_plain(ps, f, a._replace(s=s), sha, light,
                                       env, sa, b)
        nee = adv._shadow_walk(ps, shade_kernel.nee_sample(ps, f, k, scratch,
                                                            b))
        after_nee, stats_hit = clone_state(k), sk.clone()
        if not torch.equal(after_nee.s.state[entry], s.state[entry]):
            raise AssertionError(f"[16] nee_sample bounce {b}: the live "
                                 f"lanes' RNG state differs")
        shade_kernel.shade_next(ps, f, k, scratch, nee, sk, b)
        states_equal(a2, k, entry, f"[16] shade_next bounce {b}")
        if not torch.equal(sa, sk):
            raise AssertionError(f"[16] shade_next bounce {b}: stats differ")

        # the lanes by class, for the bytes each kernel moves
        code = scratch[1][0]
        live = int(entry.sum())
        missed = int((entry & (hit.hit_id < 0)).sum())
        counts = {c: int((entry & (code == v)).sum())
                  for c, v in (("reflect", 1), ("refract", 2),
                               ("diffuse", 3))}
        push = int((after_nee.stack_at > st0.stack_at).sum())
        base = live if b == 0 and f.strategy != 0 else 0
        hb = SHADE_HIT_BYTES
        hit_bytes = ((n - live) * hb["dead"] + missed * hb["missed"]
                     + (live - missed) * hb["found"]
                     + sum(counts[c] * hb[c] for c in counts)
                     + push * hb["push"] + base * hb["base"])
        facing = int(light.facing.sum()) if light is not None else 0
        nb = SHADE_NEXT_BYTES
        ends = live - sum(counts.values())
        next_bytes = ((n - live) * nb["dead"] + ends * nb["ends"]
                      + sum(counts[c] * nb[c] for c in counts)
                      + facing * nb["facing"] + base * nb["base"])

        def hit_fn():
            return shade_kernel.shade_hit(ps, f, clone_state(st0), hit,
                                          stats0.clone(), b)

        def next_fn():
            return shade_kernel.shade_next(ps, f, clone_state(after_nee),
                                           scratch, nee, stats_hit.clone(), b)

        for name, fn, plain, nbytes in (
                ("shade_hit", hit_fn, lambda: adv._shade_hit_plain(
                    ps, f, st0, hit, stats0, b), hit_bytes),
                ("shade_next", next_fn, lambda: adv._shade_next_plain(
                    ps, f, a_hit._replace(s=s), sha, light, env, sa_hit, b),
                 next_bytes)):
            dev_ms = device_ms(fn, KERNEL_REPS, name)
            if dev_ms is None:
                raise AssertionError(f"the profiler recorded no {name}")
            ms = cuda_ms(fn, KERNEL_REPS)
            plain_ms = cuda_ms(plain, PLAIN_REPS)
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            log(f"[16] {name} bounce {b}: {n} lanes ({live} live, "
                f"{missed} missed, branches {counts}): device time "
                f"{dev_ms:.4f} ms, events {ms:.4f} ms (with the state's "
                f"copy), plain {plain_ms:.3f} ms, bound {bound:.4f} ms "
                f"({nbytes / 1e6:.1f} MB), equal to plain ({card})")
            records.append(dict(
                k=f"S{b}", name=f"{name} bounce {b}", route="cuda",
                source="buas_pathtracer_tpu_torch/csrc/shade.cu",
                replaces="no TPU kernel (XLA fuses the TPU's shading)",
                lanes=n, live=live, parity="equal to plain (bit for bit)",
                device_ms=dev_ms, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", bytes=nbytes,
                **ptxas_fields(report, f"{name}_kernel")))
    return records


# bytes one lane of each class moves through nee_sample (csrc/nee.cu's
# note; light rows from cache): a dead lane reads its alive flag and writes
# t0 and flags a query kind; a live lane NEE does not serve also reads its
# NEE flag and RNG state and writes its RNG state; a served lane reads its
# normal and hit point too, and writes a light sample's terms, slot and
# query, an environment sample's terms and query (and reads its alias entry
# and texel).  At bounce 0 a served lane reads its first-bounce bases:
# stratified 8 B a draw, blue noise 4 B a 1-D draw and 8 B a 2-D one.
NEE_BYTES = dict(dead=1, unserved=18, served=42, query=5, light=57, env=81)
NEE_BASES = {1: (12, 8), 2: (16, 8)}  # strategy: (light draws, env draw)


def nee_bytes(f, n, live, served, bounce):
    """The least bytes of one nee_sample launch (``NEE_BYTES``)."""
    nb = NEE_BYTES
    kinds = int(bool(f.nee)) + int(bool(f.env_nee))
    per = nb["query"] * kinds
    total = ((n - live) * (nb["dead"] + per)
             + (live - served) * (nb["unserved"] + per)
             + served * (nb["served"] + nb["light"] * bool(f.nee)
                         + nb["env"] * bool(f.env_nee)))
    if bounce == 0 and int(f.strategy) in NEE_BASES:
        light, env = NEE_BASES[int(f.strategy)]
        total += served * (light * bool(f.nee) + env * bool(f.env_nee))
    return total


def nee_equal(ps, f, plain, nee, state, lanes, entry, what):
    """Raise unless ``nee_sample`` and the walk of its wave (``nee``, with
    the RNG ``state`` it left) equal the plain version (``plain``: its
    sampler, light and env samples and shadow queries) bit for bit: the
    live lanes' RNG state; on the lanes NEE serves, the slot, the samples'
    terms and the queries' rays and ignored prim; on every lane, facing,
    occlusion, the plane flag and t0 after the plane pass."""
    import torch
    from buas_pathtracer_tpu_torch.ops import shade_kernel, traverse
    s, light, env, queries = plain

    def eq(x, y, name):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {name} differs in "
                                 f"{int((x != y).sum())} values")

    eq(s.state[entry], state[entry], "the live lanes' RNG state")
    n = int(lanes.shape[0])
    samples = [(k, x) for k, x in (("light", light), ("env", env))
               if x is not None]
    o, d, t0, ign = nee.rays()
    for k, ((kind, sample), query) in enumerate(zip(samples, queries)):
        sl = slice(k * n, (k + 1) * n)
        flags = nee.flags[sl]
        plane = (flags & shade_kernel.WB_PLANE) != 0
        eq((flags & shade_kernel.WB_FACING) != 0, sample.facing,
           f"{kind} facing")
        eq((nee.prim[sl] >= 0) | plane, sample.occluded, f"{kind} occluded")
        t_pl, plane_idx = traverse._intersect_planes(ps, *query[:3])
        eq(plane, plane_idx >= 0, f"{kind} plane flag")
        eq(t0[sl], t_pl, f"{kind} t0")
        for c in range(3):
            eq(o[c][sl][lanes], query[0][c][lanes], f"{kind} o")
            eq(d[c][sl][lanes], query[1][c][lanes], f"{kind} d")
        eq(ign[sl][lanes].long(), query[3][lanes], f"{kind} ignored prim")
        T = nee.terms
        rows = (((0, light.n_dot_l), (1, light.nl_dot_l), (2, light.area),
                 (3, light.dist_sq), (4, light.rcp_pdf)) if kind == "light"
                else ((5, env.n_dot_e), (6, env.pdf),
                      *((7 + c, env.radiance[c]) for c in range(3))))
        for row, x in rows:
            eq(T[row][lanes], x[lanes], f"{kind} term {row}")
        if kind == "light":
            eq(nee.slot[lanes].long(), light.slot[lanes], "slot")


def run_nee(cells, dev, card, report, W=1920, H=1080):
    """[16n] NEE on the card (``nee_sample``, the walk of its wave, then
    ``shade_next``) on the inputs of bounces 0 and 1 of each cell's
    1920x1080 frame: held bit for bit to ``_nee_plain`` and
    ``_shade_next_plain``, and ``nee_sample`` timed (its device time under
    the profiler with the L2 warm and flushed, and CUDA events around the
    wrapper) beside the plain samples' time and its byte bound."""
    import torch
    from buas_pathtracer_tpu_torch.integrators import advanced as adv
    from buas_pathtracer_tpu_torch.ops import shade_kernel, traverse
    records = []
    for name, ps, scene in cells:
        inputs = record_bounces(ps, scene, dev, W, H)
        for b in (0, 1):
            f, st0, hit, stats0 = inputs[b]
            what = f"[16n] nee_sample {name} bounce {b}"
            n = int(st0.alive.shape[0])
            entry = st0.alive.clone()
            a, sa, sha = adv._shade_hit_plain(ps, f, clone_state(st0), hit,
                                              stats0.clone(), b)
            k, sk = clone_state(st0), stats0.clone()
            scratch = shade_kernel.shade_hit(ps, f, k, hit, sk, b)
            states_equal(a, k, entry, f"{what}: shade_hit")
            lanes = sha.nee_lanes
            after_hit = clone_state(k)
            plain = adv._nee_queries(ps, f, a.s, hit.p, sha.N, lanes, b)
            s, light, env = adv._nee_plain(ps, f, a.s, hit.p, sha.N, lanes,
                                           b)
            nee = adv._shadow_walk(ps, shade_kernel.nee_sample(
                ps, f, k, scratch, b))
            nee_equal(ps, f, (s, light, env, plain[3]), nee, k.s.state,
                      lanes, entry, what)
            a2, sa = adv._shade_next_plain(ps, f, a._replace(s=s), sha,
                                           light, env, sa, b)
            shade_kernel.shade_next(ps, f, k, scratch, nee, sk, b)
            states_equal(a2, k, entry, f"{what}: shade_next")
            if not torch.equal(sa, sk):
                raise AssertionError(f"{what}: stats differ")

            def kern():
                return shade_kernel.nee_sample(ps, f, clone_state(after_hit),
                                               scratch, b)

            def plain_fn():
                qs = adv._nee_queries(ps, f, a.s, hit.p, sha.N, lanes, b)[3]
                return [traverse._intersect_planes(ps, *q[:3]) for q in qs]

            live, served = int(entry.sum()), int(lanes.sum())
            nbytes = nee_bytes(f, n, live, served, b)
            dev_ms = device_ms(kern, KERNEL_REPS, "nee_sample_kernel")
            cold_ms = device_ms(kern, KERNEL_REPS, "nee_sample_kernel",
                                flush=True)
            if dev_ms is None or cold_ms is None:
                raise AssertionError("the profiler recorded no nee_sample")
            ms = cuda_ms(kern, KERNEL_REPS)
            plain_ms = cuda_ms(plain_fn, PLAIN_REPS)
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            facing = sum(int(x.facing.sum()) for x in (light, env)
                         if x is not None)
            log(f"{what}: {n} lanes ({live} live, {served} served, {facing} "
                f"queries facing, lights {int(ps.light_prim.shape[0])}, "
                f"env {bool(f.env_nee)}): device time {dev_ms:.4f} ms, L2 "
                f"cold {cold_ms:.4f} ms, events {ms:.4f} ms (with the "
                f"state's copy), plain samples and plane pass "
                f"{plain_ms:.3f} ms, bound {bound:.4f} ms "
                f"({nbytes / 1e6:.1f} MB); NEE, walk and shade_next equal "
                f"to plain ({card})")
            records.append(dict(
                k=f"N{b}", name=f"nee_sample {name} bounce {b}",
                route="cuda", source="buas_pathtracer_tpu_torch/csrc/nee.cu",
                replaces="no TPU kernel (XLA fuses the TPU's NEE)",
                lanes=n, live=live, served=served,
                parity="equal to plain (bit for bit)", device_ms=dev_ms,
                device_ms_cold_l2=cold_ms, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", bytes=nbytes,
                **ptxas_fields(report, "nee_sample_kernel")))
    return records


def record_hit_queries(ps, scene, dev, W=1920, H=1080, count=2):
    """Render one frame with ``hit_kernel.hit_record`` wrapped, keeping
    copies of the inputs of its first ``count`` calls (the closest-hit
    queries of bounces 0 and 1)."""
    import torch
    from buas_pathtracer_tpu_torch.core.vec import Vec3
    from buas_pathtracer_tpu_torch.ops import hit_kernel
    from buas_pathtracer_tpu_torch.runtime import film
    from buas_pathtracer_tpu_torch.runtime.render import render_frame
    kept, real = [], hit_kernel.hit_record

    def rec(ps_, o, d, plane_idx, *walked):
        if len(kept) < count:
            kept.append((Vec3(*(c.clone() for c in o)),
                         Vec3(*(c.clone() for c in d)), plane_idx.clone(),
                         *(x.clone() for x in walked)))
        return real(ps_, o, d, plane_idx, *walked)

    hit_kernel.hit_record = rec
    try:
        render_frame(ps, scene.settings, scene.camera,
                     film.new_accumulation_buffer(H, W, dev), 7, h=H, w=W,
                     n_lights=scene.n_lights, device=dev)
        torch.cuda.synchronize()
    finally:
        hit_kernel.hit_record = real
    return kept


def hit_record_bytes(prim, tri, plane_idx):
    """The least bytes of one hit_record launch (csrc/hit.cu's note): each
    lane's own reads and writes by its class, and each distinct row and
    table entry the lanes read once.  Returns (bytes, lanes by class)."""
    import torch
    hit = prim >= 0
    mesh, ana = hit & (tri >= 0), hit & (tri < 0)
    plane = ~hit & (plane_idx >= 0)
    cls = {"mesh": int(mesh.sum()), "analytic": int(ana.sum()),
           "plane": int(plane.sum()), "none": int((~hit & ~plane).sum())}
    n = int(prim.shape[0])
    lanes = (80 * n + 12 * cls["mesh"] + 4 * cls["analytic"]
             + 8 * (cls["plane"] + cls["none"]))
    rows = 64 * (torch.unique(tri[mesh]).numel()
                 + torch.unique(prim[ana]).numel())
    tables = (8 * torch.unique(prim[hit]).numel()
              + 20 * torch.unique(plane_idx[plane]).numel())
    return lanes + rows + tables, cls


def run_hit(cells, dev, card, report):
    """[16h] The hit record (``hit_record``) on the closest-hit queries of
    bounces 0 and 1 of each cell's 1920x1080 frame: held to the plain
    version (every field bit for bit, the normal on every lane that hit),
    timed (its device time under the profiler with the L2 warm and flushed,
    and CUDA events around the wrapper) beside the plain version's time
    and its byte bound."""
    import torch
    from buas_pathtracer_tpu_torch.ops import hit_kernel
    records = []
    for name, ps, scene in cells:
        for b, wave in enumerate(record_hit_queries(ps, scene, dev)):
            o, d, plane_idx, t, prim, tri, bv, bw, stats = wave

            def kern():
                return hit_kernel.hit_record(ps, o, d, plane_idx, t, prim,
                                             tri, bv, bw, stats)

            def plain():
                return hit_kernel.hit_record_plain(
                    ps, o, d, plane_idx, t, prim.long(), tri.long(), bv, bw,
                    stats)

            what = f"[16h] hit_record {name} bounce {b}"
            k, p = kern(), plain()
            torch.cuda.synchronize()
            found = p.hit_id >= 0
            same = all(torch.equal(getattr(k, f), getattr(p, f))
                       for f in ("hit_id", "mat_id", "tri")) and all(
                torch.equal(x.view(torch.int32), y.view(torch.int32))
                for x, y in zip(k.p, p.p)) and all(
                torch.equal(x.view(torch.int32)[found],
                            y.view(torch.int32)[found])
                for x, y in zip(k.n, p.n)) and all(
                bool((x[~found] == 0).all()) for x in k.n)
            if not same:
                raise AssertionError(f"{what}: the kernel differs from the "
                                     "plain version")
            nbytes, cls = hit_record_bytes(prim, tri, plane_idx)
            dev_ms = device_ms(kern, KERNEL_REPS, "hit_record_kernel")
            cold_ms = device_ms(kern, KERNEL_REPS, "hit_record_kernel",
                                flush=True)
            if dev_ms is None or cold_ms is None:
                raise AssertionError("the profiler recorded no hit_record")
            ms = cuda_ms(kern, KERNEL_REPS)
            plain_ms = cuda_ms(plain, PLAIN_REPS)
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            n = int(prim.shape[0])
            log(f"{what}: {n} lanes {cls}: device time {dev_ms:.4f} ms, L2 "
                f"cold {cold_ms:.4f} ms, events {ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bound:.4f} ms "
                f"({nbytes / 1e6:.1f} MB), equal to plain ({card})")
            records.append(dict(
                k=f"H{b}", name=f"hit_record {name} bounce {b}",
                route="cuda", source="buas_pathtracer_tpu_torch/csrc/hit.cu",
                replaces="no TPU kernel (XLA computes the TPU's hit record)",
                lanes=n, classes=cls,
                parity="equal to plain (bit for bit; n where hit_id >= 0)",
                device_ms=dev_ms, device_ms_cold_l2=cold_ms, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                bytes=nbytes, **ptxas_fields(report, "hit_record_kernel")))
    return records


def run_stress(dev, card, report):
    """Phases 10-14: the stress frame through split_traverse.  Returns the
    kernel records, the frame numbers, the packed scene and the scene."""
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
    return records, info, ps, scene


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
# the integrator layer: the hero frame, the other integrators and the
# blue-noise sampler
# ---------------------------------------------------------------------------

class env_vars:
    """Set environment variables inside a block."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def time_frames(ps, scene, dev, n, first, w=1920, h=1080, settings=None):
    """(mean ms, rays of the last frame, accumulation) of ``n`` frames
    into a fresh accumulation buffer, host clock, synchronised."""
    import torch
    from buas_pathtracer_tpu_torch.runtime import film
    from buas_pathtracer_tpu_torch.runtime.render import render_frame
    settings = settings or scene.settings
    accum = film.new_accumulation_buffer(h, w, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(n):
        accum, stats = render_frame(ps, settings, scene.camera, accum,
                                    first + k, h=h, w=w,
                                    n_lights=scene.n_lights,
                                    has_medium=scene.has_medium, device=dev)
    rays = float(stats[0])  # syncs
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3, rays, accum


def bounce_shape(fn):
    """Run ``fn()`` in a frame record of its own: the (bounce, lanes, live
    lanes) of every bounce of it and of the frames it renders."""
    from buas_pathtracer_tpu_torch.utils import trace
    with trace.frame() as rec:
        first = rec.seq
        fn()
    return [b for r in trace.records() if r.seq >= first for b in r.bounces]


def wide_wave_records(ps, waves, wave_calls, launches, card, report, tag,
                      label, specs, max_err):
    """Kernel records of ``wide_traverse`` on recorded waves of a resident
    table: each wave held to the plain version (outputs and stats), timed
    against it, with its lane utilisation and bound.  ``specs``: (wave, K,
    replaces).  ``launches``: the path's launch counts."""
    from buas_pathtracer_tpu_torch.ops import packet
    walk = packet.wide_traverse
    records = []
    table_bytes = ps.wide_rows.numel() * 4
    for wave, k, replaces in specs:
        o, d, t0_, ign, occ = waves[wave]
        mode = "occlusion" if occ else "closest"
        n = int(t0_.shape[0])
        live = int((t0_ >= 0).sum())
        args = (ps.wide_rows, ps.wide_depth, o, d, t0_, ign, occ)
        out = walk(*args)
        ref = packet.wide_traverse_plain(*args)
        err = compare_hits(out, ref, f"{tag} {label}{wave} wave/{mode}")
        visits, tests = (int(x) for x in out[5].cpu())
        util, steps = lane_util(walk, args)
        ms = cuda_ms(lambda: walk(*args), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: packet.wide_traverse_plain(*args),
                           PLAIN_REPS)
        # bytes: a live ray reads o, d, t0, ign (32 B), a dead one (t0 < 0)
        # only t0 (4 B); every ray writes 20 B; the table and the stats
        # once.  operations: fp32 arithmetic of this wave's visits (12 per
        # child slab, 8 children) and triangle tests (45 each)
        nbytes = live * 52 + (n - live) * 24 + table_bytes + 16
        ops = visits * 8 * 12 + tests * 45
        t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_PER_S * 1e3
        log(f"{tag} wide_traverse<{mode}> {label}{wave} wave: {n} rays "
            f"({live} live), visits {visits}, tri tests {tests}, lane "
            f"utilisation {util:.4f} ({steps} warp steps): kernel {ms:.4f} "
            f"ms, plain {plain_ms:.2f} ms, bound {max(t_b, t_o):.4f} ms "
            f"(bytes {t_b:.4f}, operations {t_o:.4f}), {wave_calls[wave]} "
            f"calls in the timed frames ({card})")
        records.append(dict(
            k=k, name=f"wide_traverse<{mode}> {label}{wave} wave",
            route="cuda",
            source="buas_pathtracer_tpu_torch/csrc/wide_traverse.cu",
            replaces=replaces, launches=launches[mode],
            wave_launches=wave_calls[wave],
            parity="equal to plain (outputs and stats)",
            max_abs_err=max(err, max_err.get(mode, 0.0)), ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_b, t_o),
            bound_by="bytes" if t_b >= t_o else "operations",
            library_ms=None, lane_util=util, warp_steps=steps,
            rows_read=visits, tri_tests=tests,
            **ptxas_fields(report, f"wide_traverse_{mode}")))
    return records


def frame_equal_plain(ps, scene, dev, w, h, index, what):
    """Raise unless one frame through the bounce's kernels (``shade_hit``,
    ``nee_sample``, ``shade_next``) equals, bit for bit in its
    accumulation and stats, the same frame with the bounce's shading and
    NEE in their plain versions (the walks and the hit record stay the
    card's in both).  Returns the frame's stats."""
    import torch
    from buas_pathtracer_tpu_torch.integrators import advanced as adv
    from buas_pathtracer_tpu_torch.runtime import film
    from buas_pathtracer_tpu_torch.runtime.render import render_frame

    def nee_plain(ps_, f, st, p, sh, bounce):
        s, light, env = adv._nee_plain(ps_, f, st.s, p, sh.N, sh.nee_lanes,
                                       bounce)
        return st._replace(s=s), (light, env)

    def next_plain(ps_, f, st, sh, nee, stats, bounce):
        return adv._shade_next_plain(ps_, f, st, sh, *nee, stats, bounce)

    def one():
        accum = film.new_accumulation_buffer(h, w, dev)
        return render_frame(ps, scene.settings, scene.camera, accum, index,
                            h=h, w=w, n_lights=scene.n_lights,
                            has_medium=scene.has_medium, device=dev)

    kern = one()
    real = adv._shade_hit, adv._nee, adv._shade_next
    adv._shade_hit, adv._nee, adv._shade_next = (adv._shade_hit_plain,
                                                 nee_plain, next_plain)
    try:
        plain = one()
    finally:
        adv._shade_hit, adv._nee, adv._shade_next = real
    torch.cuda.synchronize()
    for x, y, field in zip(kern, plain, ("accumulation", "stats")):
        if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
            raise AssertionError(f"{what}: the frame's {field} differs from "
                                 f"the plain version's")
    return kern[1]


def run_hero(dev, card, report):
    """Phases 18 and 19: the hero scene packed and rendered at 1920x1080
    through ``device=None``, 1 spp, 8 bounces, env NEE.  Returns (kernel
    records, numbers, ps, scene)."""
    import torch
    from buas_pathtracer_tpu_torch.integrators.common import has_env
    from buas_pathtracer_tpu_torch.models.scenes import build_hero_scene
    from buas_pathtracer_tpu_torch.ops import packet
    from buas_pathtracer_tpu_torch.runtime import film, post
    from buas_pathtracer_tpu_torch.runtime.render import render_frame

    W, H = 1920, 1080
    scene = build_hero_scene(W, H)
    t0 = time.perf_counter()
    ps = scene.pack()  # device=None: the card
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    split = ps.v4_res is not None
    he, we, _ = ps.env_pixels.shape
    log(f"[18] hero scene packed (device=None -> {ps.wide_rows.device}) in "
        f"{pack_s:.2f} s: rows {tuple(ps.wide_rows.shape)} "
        f"({ps.wide_rows.numel() * 4 / 1e6:.2f} MB), depth {ps.wide_depth}, "
        f"{'split' if split else 'resident'}, lights {scene.n_lights}, env "
        f"map {we}x{he} ({he * we} texels), has_env {has_env(ps)}, env NEE "
        f"{scene.settings.env_nee}")
    if split or not has_env(ps) or ps.wide_rows.device.type != "cuda":
        raise AssertionError("hero scene: expected a resident table with an "
                             "env map on the card")
    settings = scene.settings
    accum = film.new_accumulation_buffer(H, W, dev)

    def one(index=0):
        nonlocal accum
        accum, _ = render_frame(ps, settings, scene.camera, accum, index,
                                h=H, w=W, n_lights=scene.n_lights,
                                has_medium=scene.has_medium)

    waves = record_waves(packet, "wide_traverse", one)
    real = packet.wide_traverse
    shape = bounce_shape(lambda: one(1))
    calls = {"closest": 0}
    wave_calls = {"primary": 0, "bounce": 0, "shadow": 0}

    def counter(rows, depth, o, d, t0_, ign, occlusion):
        if occlusion:
            wave_calls["shadow"] += 1
        else:
            wave_calls["bounce" if calls["closest"] else "primary"] += 1
            calls["closest"] += 1
        return real(rows, depth, o, d, t0_, ign, occlusion)

    # the launch counts are set to 0 just before the timed frames and read
    # just after
    n_frames = 3
    reset_launches()
    packet.wide_traverse = counter
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f_i in range(n_frames):
            calls["closest"] = 0
            accum, stats = render_frame(
                ps, settings, scene.camera, accum, 2 + f_i, h=H, w=W,
                n_lights=scene.n_lights, has_medium=scene.has_medium)
        rays = float(stats[0])
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) / n_frames * 1e3
    finally:
        packet.wide_traverse = real
    image = post.post_process(accum, scene.post_settings)
    torch.cuda.synchronize()
    launches = read_launches()
    hdr = film.resolve(accum)
    finite = bool(torch.isfinite(hdr).all())
    log(f"[19] hero frame {W}x{H}, 1 spp, {settings.max_bounce_count} "
        f"bounces, env NEE: bounces (bounce, lanes, live lanes) {shape}")
    log(f"[19] hero frame: frame_ms {frame_ms:.3f}, rays_per_frame_M "
        f"{rays / 1e6:.4f}, Mrays/s {rays / frame_ms / 1e3:.3f} ({card})")
    log(f"[19] launches over {n_frames} frames + post: {launches}; waves "
        f"{wave_calls}; image {tuple(image.shape)} {image.dtype}, hdr "
        f"finite {finite}, mean hdr {float(hdr.mean()):.4f}")
    if (wave_calls["primary"] + wave_calls["bounce"] != launches["closest"]
            or wave_calls["shadow"] != launches["occlusion"]):
        raise AssertionError(f"wave calls {wave_calls} do not add up to the "
                             f"launches {launches}")
    if not (launches["closest"] > 0 and launches["occlusion"] > 0
            and launches["post_rgba8"] > 0):
        raise AssertionError(f"a kernel of the hero path never ran: "
                             f"{launches}")
    if not finite or tuple(image.shape) != (H, W, 4):
        raise AssertionError("hero frame image is not finite / misshaped")
    frame_breakdown(lambda: one(99), packet, "wide_traverse", card,
                    frame_ms, "[19]")
    frame_equal_plain(ps, scene, dev, W, H, 5, "[19] hero frame")
    log(f"[19] hero frame (index 5): the kernels' accumulation and stats "
        f"equal the plain shading and NEE's bit for bit")
    records = wide_wave_records(
        ps, waves, wave_calls, launches, card, report, "[19]", "hero ",
        (("primary", "K1", "buas_pathtracer_tpu/ops/pallas_packet.py:406"),
         ("bounce", "K2", "buas_pathtracer_tpu/ops/pallas_packet.py:639"),
         ("shadow", "K2", "buas_pathtracer_tpu/ops/pallas_packet.py:639")),
        {})
    info = {"hero_frame_ms": frame_ms, "hero_rays_per_frame_M": rays / 1e6,
            "hero_pack_s": pack_s, "hero_bounces": shape,
            "hero_launches": launches}
    return records, info, ps, scene


def device_profile(fn):
    """(device ms, launches, walk ms) of one ``fn()`` under torch.profiler:
    all CUDA kernels, and those of the two walks; None when the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, count, walk = 0.0, 0, 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            total += us
            count += e.count
            if "_traverse_" in e.key:
                walk += us
    return (total / 1e3, count, walk / 1e3) if count else None


def run_integrators(cells, dev, card):
    """Phase 23: one 1080p frame of Whitted, Ground Truth Iterative,
    Normals and Distances on the bench scene (finite, timed), and the
    32x32 goldens of Whitted and Normals."""
    from dataclasses import replace

    from buas_pathtracer_tpu_torch.models.scene import SceneSettings
    from buas_pathtracer_tpu_torch.runtime import film
    from buas_pathtracer_tpu_torch.runtime.render import render
    ps, sc = cells["bench"]
    out = {}
    for name in ("Whitted", "Ground Truth Iterative", "Normals",
                 "Distances"):
        st = replace(sc.settings, integrator=name)
        time_frames(ps, sc, dev, 1, 0, settings=st)  # warm-up
        ms, rays, acc = time_frames(ps, sc, dev, 1, 1, settings=st)
        hdr = film.resolve(acc)
        finite = bool(hdr.isfinite().all())
        log(f"[23] {name} 1920x1080 bench frame: frame_ms {ms:.3f}, rays "
            f"{rays / 1e6:.4f} M, finite {finite}, mean hdr "
            f"{float(hdr.mean()):.4f} ({card})")
        if not finite:
            raise AssertionError(f"{name}: frame not finite")
        out[name] = ms
    for gname, build, integ, frames in (
            ("spheres_whitted", "spheres_advanced", "Whitted", 4),
            ("mesh_normals", "mesh_advanced", "Normals", 1)):
        ref = np.load(os.path.join(HERE, "tests", "goldens",
                                   f"{gname}.npz"))["hdr"]
        g = golden_scene(build)
        g.settings = SceneSettings(samples_per_pixel=1, max_bounce_count=4,
                                   integrator=integ)
        img, _, _ = render(g, 32, 32, frames=frames, device=dev)
        close = bool(np.allclose(img, ref, rtol=2e-3, atol=2e-3))
        log(f"[23] golden {gname} 32x32x{frames}: max |diff| "
            f"{float(np.abs(img - ref).max()):.3g}, within rtol = atol = "
            f"2e-3 {close}")
        if not np.isfinite(img).all() or not close:
            raise AssertionError(f"golden {gname} disagrees")
    return out


def run_blue_noise(cells, dev, card):
    """Phase 24: the sampler's blue-noise shifts and first-bounce bases
    built on the card equal the CPU's bit for bit, and one 1080p bench
    frame with the blue-noise strategy."""
    import torch
    from dataclasses import replace

    from buas_pathtracer_tpu_torch.core import sampler as smp
    from buas_pathtracer_tpu_torch.runtime import film
    from buas_pathtracer_tpu_torch.runtime.render import _tiled
    py_, px_ = torch.meshgrid(torch.arange(1080), torch.arange(1920),
                              indexing="ij")
    px, py = _tiled(px_), _tiled(py_)
    t0 = time.perf_counter()
    on_card = smp.make_sampler(px.to(dev), py.to(dev), 5,
                               strategy=smp.Strategy.BLUE_NOISE)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    on_cpu = smp.make_sampler(px, py, 5, strategy=smp.Strategy.BLUE_NOISE)
    same = [bool(torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)))
            for f in ("bn", "pre", "state")]
    log(f"[24] blue-noise sampler for 1920x1080 (made in {card_s:.2f} s, "
        f"masks included): card vs CPU equal (bn, pre, state) {same}")
    if not all(same):
        raise AssertionError("blue-noise sampler differs between card and CPU")
    ps, sc = cells["bench"]
    st = replace(sc.settings, sampling_strategy=smp.Strategy.BLUE_NOISE)
    time_frames(ps, sc, dev, 1, 0, settings=st)
    ms, rays, acc = time_frames(ps, sc, dev, 1, 1, settings=st)
    hdr = film.resolve(acc)
    finite = bool(hdr.isfinite().all())
    log(f"[24] bench frame with the blue-noise sampler: frame_ms {ms:.3f}, "
        f"finite {finite}, mean hdr {float(hdr.mean()):.4f} ({card})")
    if not finite:
        raise AssertionError("blue-noise bench frame not finite")
    return ms


# ---------------------------------------------------------------------------
# the session layer: built-in scenes, progressive rendering, CLI, viewer
# ---------------------------------------------------------------------------

# the synthetic assets on the card: the mesh at the stress scene's mesh
# size (327,680 triangles), the skies at the real files' 2048x1024
CARD_ASSET_SUBDIVISIONS = 7
CARD_ASSET_SKY = (1024, 2048)
# the frames of [26] and [27] (16:9, the 64x36 gate's aspect) and the
# viewer's in [29]
SESSION_SIZE = (1920, 1080)
VIEWER_SIZE = (1024, 576)
SESSION_FRAMES = 3
# the scenes whose recorded waves are held to the plain walk in [26]
WAVE_SCENES = ("Week 7", "Nested Dielectrics", "Dragon")
# the scenes profiled for device time in [26] (scene, asset mode)
PROFILED = (("Week 7", "no assets"), ("Dragon", "synthetic assets"))


def launch_key(name):
    """The launch counter of a kernel record's instantiation."""
    if name.startswith("post_rgba8"):
        return "post_rgba8"
    if name.startswith("tristream"):
        return "tristream_closest"
    if name.startswith("shade_"):
        return name.split()[0]
    if name.startswith("hit_record"):
        return "hit_record"
    if name.startswith("nee_sample"):
        return "nee_sample"
    mode = "occlusion" if "occlusion" in name else "closest"
    return ("split_" if name.startswith("split") else "") + mode


@contextlib.contextmanager
def plain_walks():
    """Both traversal walks replaced by their plain versions."""
    from buas_pathtracer_tpu_torch.ops import packet
    real = packet.wide_traverse, packet.split_traverse
    packet.wide_traverse = packet.wide_traverse_plain
    packet.split_traverse = packet.split_traverse_plain
    try:
        yield
    finally:
        packet.wide_traverse, packet.split_traverse = real


def small_frames_equal(r, sc, dev):
    """A 64x36 frame (the 1080p frame's aspect, so the same camera) of the
    renderer's packed scene with the scene's own settings, through the
    kernels and through the plain versions: bit-identical, as [12]."""
    import torch
    from buas_pathtracer_tpu_torch.runtime import film
    from buas_pathtracer_tpu_torch.runtime.render import render_frame

    def img():
        acc = film.new_accumulation_buffer(36, 64, dev)
        acc, _ = render_frame(r.ps, sc.settings, sc.camera, acc, 0, h=36,
                              w=64, n_lights=sc.n_lights,
                              filter_name=sc.filter_name,
                              has_medium=sc.has_medium, device=dev)
        return film.resolve(acc)

    img_k = img()
    with plain_walks():
        img_p = img()
    same = bool(torch.equal(img_k, img_p))
    return same and bool(img_k.isfinite().all()), same


def hold_waves(r, tag, card):
    """The bounce-1 and shadow-0 waves of one progressive frame, recorded,
    held to the plain walk (outputs and stats) and timed."""
    from buas_pathtracer_tpu_torch.ops import packet
    split = r.ps.v4_res is not None
    walk = "split_traverse" if split else "wide_traverse"
    table = ((r.ps.v4_res, r.ps.v4_leaf, r.ps.wide_depth) if split
             else (r.ps.wide_rows, r.ps.wide_depth))
    waves = record_waves(packet, walk, r.render_one_frame)
    out = {}
    for wave, k in (("bounce", "K4" if split else "K2"),
                    ("shadow", "K4" if split else "K2")):
        if wave not in waves:
            raise AssertionError(f"{tag}: no {wave} wave was recorded")
        o, d, t0_, ign, occ = waves[wave]
        args = (*table, o, d, t0_, ign, occ)
        kernel = getattr(packet, walk)
        compare_hits(kernel(*args), getattr(packet, walk + "_plain")(*args),
                     f"{tag} {wave} wave ({k}, {walk})")
        ms = cuda_ms(lambda: kernel(*args), KERNEL_REPS)
        n, live = int(t0_.shape[0]), int((t0_ >= 0).sum())
        log(f"{tag} {walk} {wave} wave: {n} rays ({live} live), kernel "
            f"{ms:.4f} ms ({card})")
        out[wave] = dict(k=k, walk=walk, rays=n, live=live, ms=ms)
    return out


def scene_run(name, mode, dev, card):
    """Phase 26 for one scene in one asset mode: pack through
    ``ProgressiveRenderer(device=None)``, the first frame and 3 more
    progressive frames at SESSION_SIZE with the scene's own settings, the
    display image, the 64x36 kernels = plain gate, and for the scenes of
    WAVE_SCENES / PROFILED the recorded waves and a profiled frame."""
    import torch
    from buas_pathtracer_tpu_torch.models.scenes import load_scene
    from buas_pathtracer_tpu_torch.runtime import film
    from buas_pathtracer_tpu_torch.runtime.progressive import \
        ProgressiveRenderer
    W, H = SESSION_SIZE
    tag = f"[26] {name} ({mode}):"
    t0 = time.perf_counter()
    sc = load_scene(name, W, H)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = ProgressiveRenderer(sc, W, H)  # device=None: the card
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    ps = r.ps
    split = ps.v4_res is not None
    tables = ((ps.v4_res, ps.v4_leaf) if split else (ps.wide_rows,))
    mb = sum(t.numel() * 4 for t in tables) / 1e6
    tris = sum(m.triangle_count for m in sc.meshes)
    if ps.wide_rows.device.type != "cuda":
        raise AssertionError(f"{tag} packed on {ps.wide_rows.device}")

    reset_launches()
    t0 = time.perf_counter()
    r.render_one_frame()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(SESSION_FRAMES):
        t0 = time.perf_counter()
        r.render_one_frame()  # reads its stats: ends synchronised
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rays = float(r.last_stats[0])
    img = r.display_rgba8()
    torch.cuda.synchronize()
    launches = read_launches()
    hdr = film.resolve(r.accum)
    finite = bool(hdr.isfinite().all())
    frame_ms = float(np.median(times))
    frames = 1 + SESSION_FRAMES
    walk = "split_closest" if split else "closest"
    other = "closest" if split else "split_closest"
    per_frame = {k: v / frames for k, v in launches.items()
                 if k != "post_rgba8"}
    small_ok, small_same = small_frames_equal(r, sc, dev)
    log(f"{tag} {sc.settings.integrator}, {sc.settings.max_bounce_count} "
        f"bounces, {sc.filter_name}, env {sc.env_map is not None}, "
        f"{len(sc.prims)} prims, {len(sc.planes)} planes, {tris} triangles; "
        f"built in {build_s:.2f} s, packed in {pack_s:.2f} s: rows "
        f"{ps.wide_rows.shape[0]}, depth {ps.wide_depth}, "
        f"{'split' if split else 'resident'} {mb:.2f} MB ({card})")
    log(f"{tag} first frame {first_ms:.3f} ms, frame_ms {frame_ms:.3f} "
        f"(median of {SESSION_FRAMES}: "
        f"{', '.join(f'{t:.3f}' for t in times)}), rays {rays / 1e6:.4f} M, "
        f"Mrays/s {rays / frame_ms / 1e3:.3f}; launches over {frames} frames "
        f"+ display {launches}; image {img.shape} {img.dtype}, hdr finite "
        f"{finite}, mean hdr {float(hdr.mean()):.4f}; 64x36 kernels vs "
        f"plain identical {small_same} ({card})")
    if not (launches[walk] > 0 and launches[other] == 0
            and launches["post_rgba8"] == 1):
        raise AssertionError(f"{tag} the path's kernels did not run as "
                             f"expected: {launches}")
    if not finite or img.shape != (H, W, 4) or not small_ok:
        raise AssertionError(f"{tag} frame not finite / misshaped, or the "
                             "64x36 kernels and plain versions differ")
    rec = dict(scene=name, assets=mode, integrator=sc.settings.integrator,
               bounces=sc.settings.max_bounce_count, prims=len(sc.prims),
               triangles=tris, env=sc.env_map is not None, build_s=build_s,
               pack_s=pack_s, rows=int(ps.wide_rows.shape[0]), mb=mb,
               split=split, first_ms=first_ms, frame_ms=frame_ms,
               frames_ms=times, rays=rays, mrays_s=rays / frame_ms / 1e3,
               launches=launches, launches_per_frame=per_frame)
    if (name, mode) in PROFILED:
        prof = device_profile(r.render_one_frame)
        if prof is None:
            log(f"{tag} profiler: no device time recorded (not measured)")
        else:
            dev_ms, n, walk_ms = prof
            log(f"{tag} profiled frame: device time {dev_ms:.3f} ms in {n} "
                f"launches (walks {walk_ms:.3f} ms); against frame_ms "
                f"{frame_ms:.3f}: busy {dev_ms / frame_ms * 100:.2f}% "
                f"({card})")
            rec.update(device_ms=dev_ms, device_launches=n, walk_ms=walk_ms,
                       busy=dev_ms / frame_ms)
    if name in WAVE_SCENES and (name != "Dragon"
                                or mode == "synthetic assets"):
        rec["waves"] = hold_waves(r, tag, card)
    return rec


def run_builtin_scenes(dev, card, tmp):
    """Phase 26: the 12 built-in scenes through ``load_scene`` and
    ``ProgressiveRenderer(device=None)`` at 1920x1080, without their asset
    files and with synthetic ones in a temporary ``DATA_DIR``.  Returns the
    per-scene records and the launch counts summed over the scene runs."""
    from buas_pathtracer_tpu_torch.models import scenes
    none_dir = os.path.join(tmp, "no_assets")
    asset_dir = os.path.join(tmp, "synthetic_assets")
    t0 = time.perf_counter()
    n_tri = write_synthetic_assets(asset_dir, CARD_ASSET_SUBDIVISIONS,
                                   *CARD_ASSET_SKY)
    log(f"[26] synthetic assets written in {time.perf_counter() - t0:.2f} s: "
        f"{ASSET_MESH} {n_tri} triangles with vertex normals, "
        f"{len(ASSET_SKIES)} skies {CARD_ASSET_SKY[1]}x{CARD_ASSET_SKY[0]}")
    saved = scenes.DATA_DIR
    records, totals = [], {}
    try:
        for mode, data in (("no assets", none_dir),
                           ("synthetic assets", asset_dir)):
            scenes.DATA_DIR = data
            for desc in scenes.SCENES:
                rec = scene_run(desc.name, mode, dev, card)
                records.append(rec)
                for k, v in rec["launches"].items():
                    totals[k] = totals.get(k, 0) + v
    finally:
        scenes.DATA_DIR = saved
    if not all(totals[k] for k in ("closest", "occlusion", "post_rgba8")):
        raise AssertionError(f"[26] a kernel of the scenes' path never ran: "
                             f"{totals}")
    log(f"[26] launches over the {len(records)} scene runs: {totals}")
    return records, totals


def run_progressive(dev, card, tmp):
    """Phase 27: progressive rendering and checkpoints at 1920x1080 on
    Cornell Box: take_picture(16, checkpoint_every=4) stopped after 8 spp
    and resumed in a fresh renderer equals an uninterrupted 16 spp render
    bit for bit (accumulation and PNG); a settings change between passes
    aborts the frame; split passes equal the fused render_frame."""
    from dataclasses import replace

    import torch
    from buas_pathtracer_tpu_torch.models.scenes import load_scene
    from buas_pathtracer_tpu_torch.runtime import checkpoint, film
    from buas_pathtracer_tpu_torch.runtime import progressive as prog
    from buas_pathtracer_tpu_torch.runtime.render import render_frame
    (W, H), name = SESSION_SIZE, "Cornell Box"
    ck = os.path.join(tmp, "cornell.ckpt.npz")
    paths = [os.path.join(tmp, f"cornell_{k}.png") for k in "abc"]

    class Stop(Exception):
        pass

    def stop_after_8(done, total):
        if done > 8:
            raise Stop

    r1 = prog.ProgressiveRenderer(load_scene(name, W, H), W, H)
    try:
        r1.take_picture(16, paths[0], progress=stop_after_8,
                        checkpoint_every=4, checkpoint_path=ck)
        raise AssertionError("[27] take_picture was not stopped")
    except Stop:
        pass
    saved_spp = checkpoint.load_checkpoint(ck)[1]
    r2 = prog.ProgressiveRenderer(load_scene(name, W, H), W, H)
    resumed_s = r2.take_picture(16, paths[1], checkpoint_every=4,
                                checkpoint_path=ck)
    r3 = prog.ProgressiveRenderer(load_scene(name, W, H), W, H)
    straight_s = r3.take_picture(16, paths[2])
    same_accum = bool(torch.equal(r2.accum, r3.accum))
    with open(paths[1], "rb") as f1, open(paths[2], "rb") as f2:
        same_png = f1.read() == f2.read()
    log(f"[27] {name} {W}x{H} take_picture(16, checkpoint_every=4): stopped "
        f"at 9 spp with the checkpoint at {saved_spp} spp; resumed to 16 in "
        f"{resumed_s:.3f} s; uninterrupted 16 spp in {straight_s:.3f} s "
        f"({straight_s / 16 * 1e3:.3f} ms a spp); accumulation identical "
        f"{same_accum}, PNG identical {same_png} ({card})")
    if saved_spp != 8 or r2.frame_count != 16 or not (same_accum
                                                       and same_png):
        raise AssertionError("[27] the resumed render differs from the "
                             "uninterrupted one")

    sc4 = load_scene(name, W, H)
    sc4.settings = replace(sc4.settings, samples_per_pixel=4)
    r4 = prog.ProgressiveRenderer(sc4, W, H)
    passes = []
    real_pass = prog.ProgressiveRenderer._render_pass

    def spy(self, settings):
        passes.append(int(settings.samples_per_pixel))
        if len(passes) == 2:  # the "UI thread" edits mid-frame
            self.new_settings = replace(self.new_settings,
                                        max_bounce_count=6)
        return real_pass(self, settings)

    prog.ProgressiveRenderer._render_pass = spy
    try:
        r4.render_one_frame()
    finally:
        prog.ProgressiveRenderer._render_pass = real_pass
    aborted = (passes == [1, 1] and r4.frame_count == 2)
    r4.render_one_frame()
    committed = (r4.settings.max_bounce_count == 6 and r4.frame_count == 4)
    log(f"[27] settings change after pass 2 of 4: passes run {passes}, "
        f"frame aborted at {2 if aborted else '?'} spp {aborted}; next frame "
        f"committed and reset {committed}")
    if not (aborted and committed):
        raise AssertionError("[27] the per-pass cancel failed")

    r5 = prog.ProgressiveRenderer(sc4, W, H)
    r5.render_one_frame()
    acc = film.new_accumulation_buffer(H, W, dev)
    acc, stats = render_frame(r5.ps, sc4.settings, sc4.camera, acc, 0, h=H,
                              w=W, n_lights=sc4.n_lights,
                              filter_name=sc4.filter_name,
                              has_medium=sc4.has_medium)
    split_same = bool(torch.equal(r5.accum, acc))
    log(f"[27] 4 passes of 1 spp vs the fused 4 spp render_frame: "
        f"identical {split_same}, rays {r5.last_stats[0]:.0f} vs "
        f"{float(stats[0]):.0f}")
    if not split_same or r5.last_stats[0] != float(stats[0]):
        raise AssertionError("[27] split passes differ from the fused frame")
    return dict(resumed_s=resumed_s, straight_16spp_s=straight_s,
                checkpoint_spp=saved_spp)


def run_cli_phase(dev, card, tmp):
    """Phase 28: the port's CLI in a subprocess at its defaults (Nested
    Dielectrics, 1024x576, 4 spp) on the card; its PNG equals, byte for
    byte, the in-process render of the same scene."""
    from buas_pathtracer_tpu_torch.models import scenes
    from buas_pathtracer_tpu_torch.runtime.progressive import \
        ProgressiveRenderer
    none_dir = os.path.join(tmp, "no_assets")
    out = os.path.join(tmp, "cli.png")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "buas_pathtracer_tpu_torch.cli", "--out", out],
        cwd=HERE, env=dict(os.environ, BUAS_TPU_DATA=none_dir),
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    last = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    m = re.fullmatch(r"Took 1024x576 4spp image in ([0-9.]+) seconds -> "
                     + re.escape(out), last)
    log(f"[28] CLI at its defaults: exit {res.returncode} in {wall:.2f} s "
        f"(process included); its line: {last!r}")
    if res.returncode != 0 or m is None:
        raise AssertionError(f"[28] the CLI failed: {res.stderr[-2000:]}")
    saved = scenes.DATA_DIR
    scenes.DATA_DIR = none_dir
    try:
        sc = scenes.load_scene("Nested Dielectrics", 1024, 576)
    finally:
        scenes.DATA_DIR = saved
    in_process = os.path.join(tmp, "in_process.png")
    in_s = ProgressiveRenderer(sc, 1024, 576).take_picture(4, in_process)
    with open(out, "rb") as f1, open(in_process, "rb") as f2:
        same = f1.read() == f2.read()
    log(f"[28] CLI PNG equal to the in-process render's (in {in_s:.3f} s): "
        f"{same} ({card})")
    if not same:
        raise AssertionError("[28] the CLI's PNG differs from the in-process "
                             "render")
    return dict(cli_wall_s=wall, cli_render_s=float(m.group(1)),
                in_process_s=in_s)


def png_complete(path):
    """True once ``path`` holds a whole PNG (signature to IEND chunk): a
    file the render thread is still writing reads as incomplete."""
    if not os.path.exists(path):
        return False
    with open(path, "rb") as f:
        data = f.read()
    return data[:8] == b"\x89PNG\r\n\x1a\n" and data[-8:-4] == b"IEND"


def run_viewer_phase(dev, card, tmp):
    """Phase 29: the viewer in-process on an ephemeral port, 1024x576,
    Cornell Box on the card: the page, state, frame and sampler images; the
    keys, look, walk (the one-ray floor query) and focus controls, the
    picked focus distance equal to the plain walk's t for that ray; a
    setting commit and take picture.  Its frame_ms and the PNG encode's
    share of it.  (Both threads launch kernels: no launch counts here.)"""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch
    from buas_pathtracer_tpu_torch.app.viewer import ViewerState, make_handler
    from buas_pathtracer_tpu_torch.models import scenes
    from buas_pathtracer_tpu_torch.ops import packet
    from buas_pathtracer_tpu_torch.ops.traverse import BIG_T, _intersect_planes
    W, H = VIEWER_SIZE
    saved = scenes.DATA_DIR
    scenes.DATA_DIR = os.path.join(tmp, "no_assets")
    try:
        state = ViewerState("Cornell Box", W, H)  # device=None: the card
    finally:
        scenes.DATA_DIR = saved
    render = threading.Thread(target=state.render_loop, daemon=True)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    serve = threading.Thread(target=server.serve_forever, daemon=True)
    render.start()
    serve.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=120) as r:
            return r.status, r.read()

    def post(msg):
        req = urllib.request.Request(base + "/control", method="POST",
                                     data=json.dumps(msg).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status

    def wait_for(pred, what, timeout=120.0):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            if pred():
                return
            time.sleep(0.05)
        raise AssertionError(f"[29] timed out waiting for {what}")

    def state_json():
        return json.loads(get("/state")[1])

    try:
        code, page = get("/")
        if code != 200 or b"buas-pathtracer-tpu" not in page:
            raise AssertionError("[29] the page did not load")
        wait_for(lambda: state_json()["spp"] >= 2, "two progressive frames")
        code, png = get("/frame.png")
        if code != 200 or png[:8] != b"\x89PNG\r\n\x1a\n" or len(png) < 1000:
            raise AssertionError("[29] /frame.png is not a rendered PNG")
        for kind in ("scatter", "hist", "noise"):
            code, body = get(f"/sampler.png?kind={kind}&strategy=2")
            if code != 200 or body[:8] != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"[29] /sampler.png {kind} failed")
        samples = []
        for _ in range(12):  # the render loop's own frame and encode times
            s = state_json()
            samples.append((s["frame_ms"], s["encode_ms"], s["spp"]))
            time.sleep(0.25)
        frame_ms = float(np.median([a for a, _, _ in samples]))
        encode_ms = float(np.median([b for _, b, _ in samples]))

        cam = state.renderer.new_camera
        p0 = (cam.p.x, cam.p.z)
        post({"type": "keys", "keys": ["w"], "fast": True})
        wait_for(lambda: (state.renderer.new_camera.p.x,
                          state.renderer.new_camera.p.z) != p0, "a move")
        post({"type": "keys", "keys": [], "fast": False})
        aim0 = state.renderer.new_camera.z.x
        post({"type": "look", "dx": 60, "dy": 10})
        if state.renderer.new_camera.z.x == aim0:
            raise AssertionError("[29] look did not turn the camera")
        post({"type": "walk"})
        wait_for(lambda: abs(state.renderer.new_camera.p.y - 1.7) < 1e-3,
                 "walk mode to stand the eye 1.7 above the floor")
        post({"type": "walk"})
        picks = []
        for px, py in ((W // 2, H // 2), (W // 3, 2 * H // 3)):
            with state.lock:  # the camera as the pick will see it
                rays = state.pick_ray(px, py)
            o, d = rays.o, rays.d
            t_pl, _ = _intersect_planes(state.renderer.ps, o, d,
                                        torch.full((1,), BIG_T, device=dev))
            ref = packet.wide_traverse_plain(
                state.renderer.ps.wide_rows, state.renderer.ps.wide_depth,
                o, d, t_pl, torch.full((1,), -1, dtype=torch.int32,
                                       device=dev), False)
            post({"type": "focus", "x": px, "y": py})
            got = state.renderer.new_camera.focus_distance
            picks.append((px, py, got, float(ref[0][0]), int(ref[1][0])))
            if got != float(ref[0][0]):
                raise AssertionError(f"[29] focus pick at ({px}, {py}): "
                                     f"{got} != the plain walk's t "
                                     f"{float(ref[0][0])}")
        post({"type": "setting", "field": "max_bounce_count", "value": 6})
        wait_for(lambda: state.renderer.settings.max_bounce_count == 6
                 and state.renderer.frame_count >= 1, "the setting commit")
        pic = os.path.join(tmp, "viewer_picture.png")
        post({"type": "picture", "spp": 4, "path": pic})
        wait_for(lambda: png_complete(pic), "take picture's PNG")
        s = state_json()
    finally:
        state.running = False
        render.join(timeout=300)
        server.shutdown()
        server.server_close()
    if render.is_alive():
        raise AssertionError("[29] the render thread did not stop")
    log(f"[29] viewer {W}x{H} Cornell Box: endpoints answered; frame_ms "
        f"{frame_ms:.1f} (median of the render loop's last frame, sampled "
        f"12 times), PNG encode {encode_ms:.1f} ms = "
        f"{encode_ms / frame_ms * 100:.1f}% of it; focus picks (x, y, "
        f"focus_distance, plain walk t, prim) {picks}; after the setting "
        f"commit {s['spp']} spp, {s['title']} ({card})")
    return dict(viewer_frame_ms=frame_ms, viewer_encode_ms=encode_ms,
                viewer_encode_share=encode_ms / frame_ms, focus_picks=picks)


# ---------------------------------------------------------------------------
# 30-32. row-sharded rendering and the host code
# ---------------------------------------------------------------------------

# the frame of [30] and of [31]'s full-size cases
SHARDED_SIZE = (1920, 1080)
# the cases of [31]: name -> (ranks, scene builder, width, height, filter;
# None: the scene's own); tests/test_scenes_sharded.py:109-122's cases at
# full size, the Lanczos-12 case at 8 rows a rank (its halo spans 3 ranks)
SHARDED_CASES = {
    "bench": (2, "bench", *SHARDED_SIZE, None),
    "bench_lanczos12": (4, "bench", 1920, 32, "Lanczos 12"),
    "hero": (2, "hero", *SHARDED_SIZE, None),
    "stress": (2, "stress", *SHARDED_SIZE, None),
}
SHARDED_FRAMES = 3
WORLD_OF_ONE_FRAMES = 4  # [30]: one frame alone, three timed back to back
THREADED_SIZE = 64


def sharded_scene(builder, w, h):
    from buas_pathtracer_tpu_torch.models import scenes
    return getattr(scenes, f"build_{builder}_scene")(w, h)


def sharded_rank(mesh, cases, frames):
    """[31] on one rank (started by ``parallel.mesh.spawn_ranks``): each
    case's scene built and packed on this rank, ``frames`` frames with the
    halo exchange timed, and the launches of each case's render."""
    from buas_pathtracer_tpu_torch.parallel.mesh import render_frames
    out = {}
    for name, (_, b, w, h, f) in cases.items():
        sc = sharded_scene(b, w, h)
        reset_launches()
        out[name] = render_frames(mesh, sc, w, h, frames, filter_name=f,
                                  time_exchange=True)
        out[name]["launches"] = read_launches()
    return out


def single_frames(ps, sc, dev, w, h, frames, filter_name):
    """The single-device accumulation of ``frames`` frames (CPU copy)."""
    from buas_pathtracer_tpu_torch.runtime import film
    from buas_pathtracer_tpu_torch.runtime.render import render_frame
    accum = film.new_accumulation_buffer(h, w, dev)
    for f_i in range(frames):
        accum, stats = render_frame(
            ps, sc.settings, sc.camera, accum, f_i, h=h, w=w,
            n_lights=sc.n_lights, filter_name=filter_name,
            has_medium=sc.has_medium, device=dev)
    return accum.cpu(), stats.cpu()


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def run_world_of_one(dev, card, ps, scene, bench_ms):
    """Phase 30: the bench frame through ``ShardedRenderer`` on a world of
    one rank over NCCL on cuda:0, against ``render_frame`` on the card."""
    import torch
    import torch.distributed as dist
    from buas_pathtracer_tpu_torch.parallel.mesh import ShardedRenderer
    from buas_pathtracer_tpu_torch.runtime import film, post
    W, H = SHARDED_SIZE
    with tempfile.TemporaryDirectory() as store:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            store, "store"), rank=0, world_size=1)
        try:
            r = ShardedRenderer(scene, W, H, device=dev)
            reset_launches()
            # a first frame alone, then the rest back to back with one sync
            # at the end, as [6] times its frames
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.step()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(WORLD_OF_ONE_FRAMES - 1):
                stats = r.step()
            torch.cuda.synchronize()
            first_ms = (t1 - t0) * 1e3
            frame_ms = ((time.perf_counter() - t1)
                        / (WORLD_OF_ONE_FRAMES - 1) * 1e3)
            accum = r.gather_accum()
            image = post.post_process(accum, scene.post_settings, device=dev)
            torch.cuda.synchronize()
            launches = read_launches()
            backend = r.mesh.backend
        finally:
            dist.destroy_process_group()
    ref, ref_stats = single_frames(ps, scene, dev, W, H, WORLD_OF_ONE_FRAMES,
                                   scene.filter_name)
    same = bool(torch.equal(accum.cpu(), ref))
    finite = bool(torch.isfinite(film.resolve(accum)).all())
    log(f"[30] world of 1 ({backend}, cuda:0): bench {W}x{H}, "
        f"{WORLD_OF_ONE_FRAMES} frames: first {first_ms:.3f} ms, then "
        f"frame_ms {frame_ms:.3f} ([6]: {bench_ms:.3f}); resolved image "
        f"bit-equal to "
        f"render_frame {same}; stats [rays, visits, tests] "
        f"{stats.cpu().tolist()} vs {ref_stats.tolist()}; launches "
        f"{launches} ({card})")
    stats_ok = (float(stats[0]) == float(ref_stats[0])
                and np.allclose(stats.cpu().numpy(), ref_stats.numpy(),
                                rtol=1e-6, atol=0.0))
    if not (same and stats_ok and finite
            and tuple(image.shape) == (H, W, 4)):
        raise AssertionError("[30] the world-of-one frame or its stats "
                             "differ from render_frame")
    if not (launches["closest"] and launches["occlusion"]
            and launches["post_rgba8"]):
        raise AssertionError(f"[30] a kernel never ran: {launches}")
    return dict(backend=backend, first_ms=first_ms, frame_ms=frame_ms,
                bench_frame_ms=bench_ms, launches=launches)


def run_sharded(dev, card, cells, bench_ms):
    """Phases 30 and 31.  Returns the numbers and the launches summed over
    [30] and every rank of [31]."""
    import torch
    from buas_pathtracer_tpu_torch.parallel.mesh import spawn_ranks
    if SHARDED_SIZE == (1920, 1080):  # the cells are 1080p frames
        ps, scene = cells["bench"]
    else:
        scene = sharded_scene("bench", *SHARDED_SIZE)
        ps = scene.pack(device=dev)
    totals = {}
    one = run_world_of_one(dev, card, ps, scene, bench_ms)
    add_launches(totals, one["launches"])
    out = {"world_of_one": one}
    for world in sorted({c[0] for c in SHARDED_CASES.values()}):
        cases = {n: c for n, c in SHARDED_CASES.items() if c[0] == world}
        t0 = time.perf_counter()
        res = spawn_ranks(sharded_rank, ["cuda:0"] * world, "gloo",
                          (cases, SHARDED_FRAMES))
        wall = time.perf_counter() - t0
        log(f"[31] {world} ranks sharing cuda:0 over gloo: "
            f"{list(cases)} in {wall:.1f} s (process start, packs and "
            f"frames)")
        for name, (_, builder, w, h, filt) in cases.items():
            if builder in cells and (w, h) == (1920, 1080):
                rps, rsc = cells[builder]
            else:
                rsc = sharded_scene(builder, w, h)
                rps = rsc.pack(device=dev)
            filt = filt or rsc.filter_name
            ref, ref_stats = single_frames(rps, rsc, dev, w, h,
                                           SHARDED_FRAMES, filt)
            got = res[0][name]
            same = bool(torch.equal(got["accum"], ref))
            ranks = []
            for part in (rr[name] for rr in res):
                add_launches(totals, part["launches"])
                walks = part["launches"]
                ex_ms = part["exchange_s"] / max(1, part["exchanges"]) * 1e3
                ranks.append(dict(
                    rank=part["rank"], rows=part["rows"],
                    pack_s=part["pack_s"], split=part["split_tables"],
                    frame_ms=[x * 1e3 for x in part["frame_s"]],
                    exchange_ms_per_pass=ex_ms, launches=walks))
                log(f"[31] {name} rank {part['rank']} rows {part['rows']}: "
                    f"pack {part['pack_s']:.2f} s (split tables "
                    f"{part['split_tables']}), frame_ms "
                    f"{[round(x * 1e3, 3) for x in part['frame_s']]}, halo "
                    f"exchange {ex_ms:.3f} ms a pass "
                    f"({part['exchanges']} passes), launches {walks} "
                    f"({card})")
                key = "split_" if part["split_tables"] else ""
                if not (walks[key + "closest"] and walks[key + "occlusion"]):
                    raise AssertionError(f"[31] {name} rank {part['rank']}: "
                                         f"a walk never ran: {walks}")
            if (builder == "stress") != ranks[0]["split"]:
                raise AssertionError(f"[31] {name}: split tables "
                                     f"{ranks[0]['split']}")
            log(f"[31] {name} {w}x{h} over {world} ranks ({filt}): gathered "
                f"image bit-equal to the single-device frame {same}; stats "
                f"[rays, visits, tests] {got['stats'].tolist()} vs "
                f"{ref_stats.tolist()}")
            stats_ok = (float(got["stats"][0]) == float(ref_stats[0])
                        and np.allclose(got["stats"].numpy(),
                                        ref_stats.numpy(), rtol=1e-6,
                                        atol=0.0))
            if not (same and stats_ok):
                raise AssertionError(f"[31] {name}: the sharded frame or its "
                                     "stats differ from the single-device "
                                     f"one: {got['stats']} vs {ref_stats}")
            out[name] = dict(ranks=world, size=(w, h), filter=filt,
                             bit_equal=same, per_rank=ranks)
    log(f"[31] launches over [30] and the ranks of [31]: {totals}")
    return out, totals


def run_host_code(dev, card, tmp):
    """Phase 32: the native OBJ parser and HDR decoder against the Python
    ones on [26]'s synthetic assets, and a small bench frame through the
    threaded oracle walk against the kernel frame."""
    from dataclasses import replace

    import torch
    from buas_pathtracer_tpu_torch import native
    from buas_pathtracer_tpu_torch.models.scenes import build_bench_scene
    from buas_pathtracer_tpu_torch.runtime.render import render
    from buas_pathtracer_tpu_torch.utils import assets
    asset_dir = os.path.join(tmp, "synthetic_assets")
    with open(os.path.join(asset_dir, ASSET_MESH)) as f:
        text = f.read()
    t0 = time.perf_counter()
    nat = assets.parse_obj(text)
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = assets._parse_obj_py(text)
    py_s = time.perf_counter() - t0
    same_obj = all(
        getattr(nat, k) is None and getattr(py, k) is None
        or getattr(nat, k).tobytes() == getattr(py, k).tobytes()
        for k in ("triangles", "normals", "texcoords"))
    log(f"[32] OBJ {ASSET_MESH} ({len(text) / 1e6:.1f} MB, "
        f"{nat.triangle_count} triangles): native {nat_s:.3f} s, Python "
        f"{py_s:.3f} s, meshes byte-equal {same_obj}")
    sky = os.path.join(asset_dir, next(iter(ASSET_SKIES)))
    with open(sky, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    hdr_nat = assets.parse_hdr(data)
    hdr_nat_s = time.perf_counter() - t0
    pos = data.index(b"\n", data.index(b"\n-Y ") + 1) + 1
    h, w = hdr_nat.shape[:2]
    t0 = time.perf_counter()
    hdr_np = assets._decode_rgbe(assets._decode_scanlines(
        np.frombuffer(data, np.uint8, offset=pos), w, h))
    hdr_np_s = time.perf_counter() - t0
    same_hdr = hdr_nat.tobytes() == hdr_np.tobytes()
    log(f"[32] HDR {w}x{h}: native {hdr_nat_s:.3f} s, numpy "
        f"{hdr_np_s:.3f} s, equal {same_hdr}; native library "
        f"{native.available()}")
    if not (native.available() and same_obj and same_hdr):
        raise AssertionError("[32] the native host code differs")

    n = THREADED_SIZE
    sc = build_bench_scene(n, n)
    sc.settings = replace(sc.settings, max_bounce_count=4)
    img_k, _, st_k = render(sc, n, n, frames=1, device=dev)
    with env_vars(BUAS_TRAVERSAL="threaded"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img_t, _, st_t = render(sc, n, n, frames=1, device=dev)
        torch.cuda.synchronize()
        thr_ms = (time.perf_counter() - t0) * 1e3
    frac, rel = image_agreement(img_t, img_k)
    log(f"[32] {n}x{n} bench frame, 4 bounces, BUAS_TRAVERSAL=threaded "
        f"(plain PyTorch walk, pack included): {thr_ms:.1f} ms; against "
        f"the kernel frame: pixels outside 2e-3 {frac * 100:.2f}%, mean rel "
        f"err {rel:.3g}, rays {float(st_t[0]):.0f} vs {float(st_k[0]):.0f}"
        f" ({card})")
    if not np.isfinite(img_t).all() or frac > 0.01 or rel > 1e-3:
        raise AssertionError("[32] the threaded frame disagrees")
    return dict(obj_native_s=nat_s, obj_python_s=py_s,
                obj_triangles=nat.triangle_count, hdr_native_s=hdr_nat_s,
                hdr_numpy_s=hdr_np_s, hdr_size=(w, h),
                threaded_frame_ms=thr_ms, threaded_outside=frac,
                threaded_rel_err=rel)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv):
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
                  "post_rgba8_kernel", "shade_hit_kernel",
                  "shade_next_kernel", "nee_sample_kernel",
                  "hit_record_kernel"):
        ptxas_fields(report, kname)  # fails when the report lacks one
    sass = sass_report()
    log(f"[2] cuobjdump -sass: "
        f"{'%d kernels' % len(sass) if sass else 'not available'}")
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("native builders unavailable (g++)")
    log(f"[2] native builders built+loaded in {time.perf_counter() - t0:.2f} s")
    if "--hit" in argv:
        from buas_pathtracer_tpu_torch.models.scenes import build_stress_scene
        cells = []
        for name, build in (("bench", build_bench_scene),
                            ("stress", build_stress_scene)):
            sc = build(1920, 1080)
            cells.append((name, sc.pack(device=dev), sc))
        hit = run_hit(cells, dev, card, report)
        print(json.dumps({"kernels": hit, "card": card}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--nee" in argv:
        from buas_pathtracer_tpu_torch.models.scenes import (
            build_hero_scene, build_stress_scene)
        cells = []
        for name, build in (("bench", build_bench_scene),
                            ("stress", build_stress_scene),
                            ("hero", build_hero_scene)):
            sc = build(1920, 1080)
            cells.append((name, sc.pack(device=dev), sc))
        nee = run_nee(cells, dev, card, report)
        hero_ps, hero_sc = cells[2][1], cells[2][2]
        frame_equal_plain(hero_ps, hero_sc, dev, 1920, 1080, 5,
                          "[16n] hero frame")
        log("[16n] hero frame (index 5): the kernels' accumulation and "
            "stats equal the plain shading and NEE's bit for bit")
        print(json.dumps({"kernels": nee, "card": card}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--shade" in argv:
        bench = build_bench_scene(1920, 1080)
        shade = run_shade(bench.pack(device=dev), bench, dev, card, report)
        print(json.dumps({"kernels": shade, "card": card}), flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

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

    # ---- 16. the shading kernels at the bench frame's shapes ----
    records += run_shade(ps, scene, dev, card, report)

    # ---- 8. where the bench frame's time goes ----
    frame_breakdown(lambda: render_frame(
        ps, settings, scene.camera, accum, 99, h=H, w=W,
        n_lights=scene.n_lights, device=dev), packet, "wide_traverse", card,
        frame_s * 1e3, "[8]")

    # ---- 10-14. the stress frame through the split tables ----
    stress_records, stress, stress_ps, stress_scene = run_stress(dev, card,
                                                                 report)
    records += stress_records
    records += run_hit([("bench", ps, scene),
                        ("stress", stress_ps, stress_scene)], dev, card,
                       report)

    # ---- 15. the dense triangle stream on the bench scene ----
    records.append(run_tristream(ps, sets, card, report, sass))

    # ---- 18-19. the hero frame ----
    hero_records, hero, hero_ps, hero_scene = run_hero(dev, card, report)
    records += hero_records

    # ---- 16n. NEE on the bench, stress and hero frames' bounces ----
    records += run_nee([("bench", ps, scene), ("stress", stress_ps,
                                                stress_scene),
                        ("hero", hero_ps, hero_scene)], dev, card, report)
    for r in records:  # the hero path's launches beside the bench path's
        if r["k"] in ("K1", "K2", "K7"):
            mode = "occlusion" if "occlusion" in r["name"] else "closest"
            r["launches_hero"] = hero["hero_launches"][mode]
        elif r["k"] == "K3":
            r["launches_hero"] = hero["hero_launches"]["post_rgba8"]
    cells = {"bench": (ps, scene), "stress": (stress_ps, stress_scene),
             "hero": (hero_ps, hero_scene)}

    # ---- 23-24. the other integrators, the blue-noise sampler ----
    others = run_integrators(cells, dev, card)
    bn_ms = run_blue_noise(cells, dev, card)

    # ---- 26-29. the session layer: the 12 built-in scenes, progressive
    # rendering with checkpoints, the CLI and the viewer ----
    with tempfile.TemporaryDirectory() as tmp:
        scene_records, scene_launches = run_builtin_scenes(dev, card, tmp)
        session = dict(scenes=scene_records, scene_launches=scene_launches,
                       **run_progressive(dev, card, tmp),
                       **run_cli_phase(dev, card, tmp),
                       **run_viewer_phase(dev, card, tmp))
        # ---- 30-32. row-sharded rendering (a world of one over NCCL,
        # ranks sharing the card over gloo) and the native host code with
        # the threaded oracle walk ----
        sharded, sharded_launches = run_sharded(dev, card, cells,
                                                frame_s * 1e3)
        host_code = run_host_code(dev, card, tmp)
    for r in records:  # the scene runs' and the sharded runs' launches
        key = launch_key(r["name"])
        r["launches_scenes"] = scene_launches.get(key, 0)
        r["launches_sharded"] = sharded_launches.get(key, 0)

    # ---- 25. records ----
    records.sort(key=lambda r: r["k"])
    log(f"[25] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records, "frame_ms": frame_s * 1e3,
                      "rays_per_frame_M": rays / 1e6, **stress, **hero,
                      "integrators_ms": others,
                      "blue_noise_frame_ms": bn_ms, "session": session,
                      "sharded": sharded, "host_code": host_code,
                      "card": card}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
