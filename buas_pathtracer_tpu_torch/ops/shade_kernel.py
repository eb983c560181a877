"""The kernels of the Advanced Pathtracer's bounce (``csrc/shade.cu``,
``csrc/nee.cu``).

``shade_hit`` runs after the closest-hit walk, ``nee_sample`` after it
(next-event estimation's samples and the shadow wave), and ``shade_next``
after the occlusion walk of that wave.  Their plain version is
``integrators/advanced.py``'s ``_shade_hit_plain``, ``_nee_plain`` and
``_shade_next_plain``, which the integrator runs for CPU tensors; these
wrappers are the card's path and raise for any other device.  The kernels
update the loop's own state (``advanced._State``) and ``stats`` in place
and return nothing but the scratch between them: ``shade_hit``'s, a (15,
N) float32 pack (the oriented normal, the diffuse BRDF, the specular ray
and its tint), a (2, N) uint8 pack (the branch code, and the lanes NEE
serves as a bool row) and the hit point; ``nee_sample``'s, a ``Nee``.
All three launch on PyTorch's current stream and never synchronise.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core.vec import Vec3
from ..core.sampler import Strategy
from ..utils import trace
from . import cuda_lib
from .cuda_lib import (check_lanes as _lanes, check_table as _table,
                       vec_lanes as _vec, vec_ptrs as _ptrs)

STACK_DEPTH = 8  # csrc/shade.cuh STACK_DEPTH, integrators/advanced.py's
SF_ROWS = 15  # csrc/shade.cuh SF_ROWS: N 0-2, brdf 3-5, o 6-8, d 9-11, tint
SF_N = 0
SI_ROWS = 2  # SI_CODE 0, SI_NEE 1
SI_NEE = 1
NF_ROWS = 10  # csrc/shade.cuh NF_ROWS: the light's terms 0-4, the env's 5-9
WF_ROWS = 6  # WF_ROWS: o 0-2, d 3-5
WB_FACING, WB_PLANE = 1, 2  # a wave lane's flags
_P, _I = ctypes.c_void_p, ctypes.c_int64


class ShadeArgs(ctypes.Structure):
    """``shade::Args`` of csrc/shade.cuh, field for field."""

    _fields_ = [(name, _I) for name in (
        "n", "bounce", "strategy", "nee", "env_nee", "use_mis", "is_lights",
        "is_diffuse", "rr", "caustics", "ref_mis", "has_env", "n_lights",
        "env_h", "env_w", "n_planes")] + [
        ("mat16", _P), ("light_prim", _P), ("light16", _P),
        ("prim_fwd", _P), ("prim_mat", _P), ("prim_r", _P),
        ("prim_type", _P), ("mat_emission", _P * 3), ("sky_bot", _P * 3),
        ("sky_top", _P * 3), ("env_pixels", _P), ("env_pdf_num", _P),
        ("env_alias_prob", _P), ("env_alias_idx", _P), ("plane_n", _P * 3),
        ("plane_d", _P),
        ("alive", _P), ("is_spec", _P), ("o", _P * 3), ("d", _P * 3),
        ("tp", _P * 3), ("total", _P * 3), ("prev_n", _P * 3), ("rng", _P),
        ("stack", _P), ("stack_stride", _I), ("stack_at", _P), ("pre", _P),
        ("pre_stride", _I), ("hit_id", _P), ("mat_id", _P), ("t", _P),
        ("p", _P * 3), ("n_hit", _P * 3), ("node_visits", _P),
        ("tri_tests", _P), ("stats", _P), ("counters", _P), ("sf", _P),
        ("si", _P), ("nf", _P), ("nslot", _P), ("wf", _P), ("w_t", _P),
        ("w_ign", _P), ("w_flags", _P), ("w_prim", _P)]


class Nee(NamedTuple):
    """``nee_sample``'s scratch, which ``shade_next`` reads after the walk:
    the samples' terms (``NF_ROWS``, N) float32, the picked light slot (N,)
    int32, and the shadow wave of w = N a sample kind (the light's queries
    in lanes [0, N), the environment's after them): its rays (``WF_ROWS``,
    w) float32 (unwritten where t0 < 0), its t0 (w,) float32 (max_t
    shortened by the planes; a tensor of its own, so a caller that keeps it
    keeps 4 B a query), its ignored prims (w,) int32, its flags (w,) uint8
    (``WB_FACING``, ``WB_PLANE``), and the occlusion walk's prim (w,) int32,
    None until the walk."""

    terms: torch.Tensor
    slot: torch.Tensor
    wave: torch.Tensor
    t0: torch.Tensor
    ign: torch.Tensor
    flags: torch.Tensor
    prim: Optional[torch.Tensor]

    def rays(self):
        """The wave as the walk takes it: (o, d, t0, ignored prim)."""
        w = self.wave
        return Vec3(w[0], w[1], w[2]), Vec3(w[3], w[4], w[5]), self.t0, \
            self.ign


_ARGS_CHECKED = False
# (device index, stream) -> the (3,) int64 counters of the kernels' block
# counts: made zero once, and each launch's last block zeroes them again,
# so launches in stream order share them
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}

F32, I64, BOOL, U8 = torch.float32, torch.int64, torch.bool, torch.uint8
I32 = torch.int32


def _scene(ps, dev) -> dict:
    """The scene tables' ShadeArgs fields, checked."""
    L = int(ps.light_prim.shape[0])
    M, K = int(ps.mat16.shape[0]), int(ps.prim_type.shape[0])
    P = int(ps.plane_d.shape[0])
    for name, x, dt, shape in (
            ("mat16", ps.mat16, F32, (None, 16)),
            ("light_prim", ps.light_prim, I64, (L,)),
            ("light16", ps.light16, F32, (L, 16)),
            ("prim_fwd", ps.prim_fwd, F32, (K, 12)),
            ("prim_mat", ps.prim_mat, I64, (K,)),
            ("prim_r", ps.prim_r, F32, (K,)),
            ("prim_type", ps.prim_type, I64, (K,)),
            ("env_pixels", ps.env_pixels, F32, (None, None, 3)),
            ("env_pdf_num", ps.env_pdf_num, F32, (None,)),
            ("env_alias_prob", ps.env_alias_prob, F32, (None,)),
            ("env_alias_idx", ps.env_alias_idx, I64, (None,)),
            ("plane_d", ps.plane_d, F32, (P,))):
        _table(name, x, dt, shape, dev)
    for name, v, shape in (("mat_emission", ps.mat_emission, (M,)),
                           ("sky_bot", ps.sky_bot, ()),
                           ("sky_top", ps.sky_top, ()),
                           ("plane_n", ps.plane_n, (P,))):
        for c, x in zip("xyz", v):
            _table(f"{name}.{c}", x, F32, shape, dev)
    he, we, _ = ps.env_pixels.shape
    for name in ("env_pdf_num", "env_alias_prob", "env_alias_idx"):
        if int(getattr(ps, name).shape[0]) != he * we:
            raise ValueError(f"{name} must hold one value a texel")
    return dict(
        has_env=he > 1 or we > 1, n_lights=L, env_h=he, env_w=we, n_planes=P,
        mat16=ps.mat16.data_ptr(), light_prim=ps.light_prim.data_ptr(),
        light16=ps.light16.data_ptr(), prim_fwd=ps.prim_fwd.data_ptr(),
        prim_mat=ps.prim_mat.data_ptr(), prim_r=ps.prim_r.data_ptr(),
        prim_type=ps.prim_type.data_ptr(),
        mat_emission=_ptrs(ps.mat_emission), sky_bot=_ptrs(ps.sky_bot),
        sky_top=_ptrs(ps.sky_top), env_pixels=ps.env_pixels.data_ptr(),
        env_pdf_num=ps.env_pdf_num.data_ptr(),
        env_alias_prob=ps.env_alias_prob.data_ptr(),
        env_alias_idx=ps.env_alias_idx.data_ptr(), plane_n=_ptrs(ps.plane_n),
        plane_d=ps.plane_d.data_ptr())


def _common(ps, f, st, bounce: int) -> ShadeArgs:
    """The checks and arguments the three kernels share: flags, scene
    tables, the state."""
    n = st.alive.shape[0]
    dev = st.alive.device
    s = st.s
    if (bounce == 0 and f.strategy in (Strategy.STRATIFIED,
                                       Strategy.BLUE_NOISE)
            and s.pre.shape[0] == 0):
        raise ValueError(
            "bounce kernels: the first bounce of a stratified or blue-noise "
            "sampler needs the pass's first-bounce bases (a per-ray sample "
            "index has none); no frame path builds such a sampler")
    _lanes(n, dev, [("alive", st.alive, BOOL), ("is_spec", st.is_spec, BOOL),
                    ("rng", s.state, I64), ("stack_at", st.stack_at, I64)]
           + _vec("o", st.o) + _vec("d", st.d) + _vec("tp", st.tp)
           + _vec("total", st.total) + _vec("prev_n", st.prev_n))
    stack = st.stack
    if stack.dtype != I64 or stack.device != dev \
            or stack.shape != (STACK_DEPTH, n) or stack.stride(1) != 1:
        raise ValueError(f"stack must be ({STACK_DEPTH}, {n}) int64 rows on "
                         f"{dev}, got {stack.dtype} {tuple(stack.shape)}")
    pre = s.pre
    if pre.shape[0] and (pre.dtype != F32 or pre.device != dev
                         or pre.shape[1] != n or pre.stride(1) != 1
                         or pre.shape[0] < 16):
        raise ValueError(f"sampler bases must be (16, {n}) float32 rows on "
                         f"{dev}, got {pre.dtype} {tuple(pre.shape)}")
    return ShadeArgs(
        n=n, bounce=bounce, strategy=f.strategy, nee=f.nee,
        env_nee=f.env_nee, use_mis=f.use_mis, is_lights=f.is_lights,
        is_diffuse=f.is_diffuse, rr=f.rr, caustics=f.caustics,
        ref_mis=f.ref_mis, **_scene(ps, dev),
        alive=st.alive.data_ptr(), is_spec=st.is_spec.data_ptr(),
        o=_ptrs(st.o), d=_ptrs(st.d), tp=_ptrs(st.tp),
        total=_ptrs(st.total), prev_n=_ptrs(st.prev_n),
        rng=s.state.data_ptr(), stack=stack.data_ptr(),
        stack_stride=stack.stride(0), stack_at=st.stack_at.data_ptr(),
        pre=pre.data_ptr() if pre.shape[0] else None,
        pre_stride=pre.stride(0) if pre.shape[0] else 0)


def _stats(stats, dev) -> None:
    if stats.dtype != F32 or stats.shape != (3,) or stats.device != dev \
            or not stats.is_contiguous():
        raise ValueError(f"stats must be a contiguous (3,) float32 tensor on "
                         f"{dev}")


def _lib():
    """The kernel library, its ``shade::Args`` checked against
    ``ShadeArgs`` once."""
    global _ARGS_CHECKED
    lib = cuda_lib.load()
    if not _ARGS_CHECKED:
        size = lib.shade_args_size()
        if size != ctypes.sizeof(ShadeArgs):
            raise RuntimeError(f"shade::Args is {size} bytes, ShadeArgs "
                               f"{ctypes.sizeof(ShadeArgs)}")
        _ARGS_CHECKED = True
    return lib


def _launch(name: str, args: ShadeArgs, dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no {name} for device {dev}: the plain version "
                         f"(integrators/advanced.py) serves the CPU")
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        key = (dev.index, stream)
        counters = _COUNTERS.get(key)
        if counters is None:
            counters = _COUNTERS[key] = torch.zeros(3, dtype=I64, device=dev)
        args.counters = counters.data_ptr()
        rc = getattr(lib, name + "_launch")(ctypes.addressof(args), stream)
    cuda_lib.check(rc, name)
    trace.launch(name)


def hit_args(ps, f, st, hit, stats, bounce: int):
    """``shade_hit``'s checked arguments and the scratch it leaves for
    ``shade_next``: (sf (15, N) float32 and si (2, N) uint8, both new, and
    the hit point)."""
    args = _common(ps, f, st, bounce)
    n, dev = args.n, st.alive.device
    _lanes(n, dev, [("hit.hit_id", hit.hit_id, I64),
                    ("hit.mat_id", hit.mat_id, I64), ("hit.t", hit.t, F32)]
           + _vec("hit.p", hit.p) + _vec("hit.n", hit.n))
    for name, x in (("hit.node_visits", hit.node_visits),
                    ("hit.tri_tests", hit.tri_tests)):
        _table(name, x, I64, (), dev)
    _stats(stats, dev)
    sf = torch.empty((SF_ROWS, n), dtype=F32, device=dev)
    si = torch.empty((SI_ROWS, n), dtype=U8, device=dev)
    args.hit_id, args.mat_id = hit.hit_id.data_ptr(), hit.mat_id.data_ptr()
    args.t = hit.t.data_ptr()
    args.p, args.n_hit = _ptrs(hit.p), _ptrs(hit.n)
    args.node_visits = hit.node_visits.data_ptr()
    args.tri_tests = hit.tri_tests.data_ptr()
    args.stats, args.sf, args.si = (stats.data_ptr(), sf.data_ptr(),
                                    si.data_ptr())
    return args, (sf, si, hit.p)


def shade_hit(ps, f, st, hit, stats, bounce: int):
    """The shading after the closest hit ``hit`` (a ``traverse.Hit``) of
    the lanes of ``st``: updates ``st``'s throughput, total, stack, stack
    index and RNG state and ``stats`` in place.  Returns the scratch
    (sf, si, hit point) for NEE and ``shade_next``."""
    args, scratch = hit_args(ps, f, st, hit, stats, bounce)
    _launch("shade_hit", args, st.alive.device)
    return scratch


def normal(scratch) -> Vec3:
    """The oriented normal of the lanes ``shade_hit`` found a hit for."""
    sf = scratch[0]
    return Vec3(sf[SF_N], sf[SF_N + 1], sf[SF_N + 2])


def nee_lanes(scratch) -> torch.Tensor:
    """The lanes NEE serves (found, not emissive, diffuse), as bools."""
    return scratch[1][SI_NEE].view(torch.bool)


def _scratch(n: int, dev, scratch):
    """Check ``shade_hit``'s scratch; returns its hit point."""
    sf, si, p = scratch
    _table("sf", sf, F32, (SF_ROWS, n), dev)
    _table("si", si, U8, (SI_ROWS, n), dev)
    _lanes(n, dev, _vec("hit.p", p))
    return p


def nee_args(ps, f, st, scratch, bounce: int):
    """``nee_sample``'s checked arguments and its new scratch (a ``Nee``
    without the walk's prim)."""
    args = _common(ps, f, st, bounce)
    n, dev = args.n, st.alive.device
    waves = int(bool(f.nee)) + int(bool(f.env_nee))
    if not waves:
        raise ValueError("nee_sample: next-event estimation is off")
    p = _scratch(n, dev, scratch)
    w = waves * n
    floats = torch.empty(NF_ROWS * n + WF_ROWS * w, dtype=F32, device=dev)
    ints = torch.empty(n + w, dtype=I32, device=dev)
    nee = Nee(terms=floats[:NF_ROWS * n].view(NF_ROWS, n), slot=ints[:n],
              wave=floats[NF_ROWS * n:].view(WF_ROWS, w),
              t0=torch.empty(w, dtype=F32, device=dev), ign=ints[n:],
              flags=torch.empty(w, dtype=U8, device=dev), prim=None)
    args.p = _ptrs(p)
    args.sf, args.si = scratch[0].data_ptr(), scratch[1].data_ptr()
    args.nf, args.nslot = nee.terms.data_ptr(), nee.slot.data_ptr()
    args.wf, args.w_t = nee.wave.data_ptr(), nee.t0.data_ptr()
    args.w_ign = nee.ign.data_ptr()
    args.w_flags = nee.flags.data_ptr()
    return args, nee


def nee_sample(ps, f, st, scratch, bounce: int) -> Nee:
    """Next-event estimation's samples (light, then environment, as the
    flags ask) for the lanes ``shade_hit``'s ``scratch`` marks, and their
    shadow wave with the plane pass done: draws from ``st``'s RNG state in
    place.  Returns the ``Nee`` for the walk and ``shade_next``."""
    args, nee = nee_args(ps, f, st, scratch, bounce)
    _launch("nee_sample", args, st.alive.device)
    return nee


def next_args(ps, f, st, scratch, nee, stats, bounce: int):
    """``shade_next``'s checked arguments."""
    args = _common(ps, f, st, bounce)
    n, dev = args.n, st.alive.device
    args.p = _ptrs(_scratch(n, dev, scratch))
    _stats(stats, dev)
    waves = int(bool(f.nee)) + int(bool(f.env_nee))
    if (nee is None) != (waves == 0) or (nee is not None
                                         and nee.prim is None):
        raise ValueError("shade_next: NEE's samples and their walk must "
                         "follow the flags")
    if nee is not None:
        w = waves * n
        _table("nee.terms", nee.terms, F32, (NF_ROWS, n), dev)
        _lanes(w, dev, [("nee.flags", nee.flags, U8),
                        ("nee.prim", nee.prim, I32)])
        _lanes(n, dev, [("nee.slot", nee.slot, I32)])
        args.nf, args.nslot = nee.terms.data_ptr(), nee.slot.data_ptr()
        args.w_flags, args.w_prim = (nee.flags.data_ptr(),
                                     nee.prim.data_ptr())
    args.stats, args.sf, args.si = (stats.data_ptr(), scratch[0].data_ptr(),
                                    scratch[1].data_ptr())
    return args


def shade_next(ps, f, st, scratch, nee, stats, bounce: int) -> None:
    """The shading after the occlusion walk, from ``shade_hit``'s scratch
    and ``nee_sample``'s ``nee`` with the walk's prim (None when NEE is
    off); ``st.s`` holds the RNG state NEE left.  Updates ``st`` and
    ``stats`` in place."""
    _launch("shade_next",
            next_args(ps, f, st, scratch, nee, stats, bounce),
            st.alive.device)
