"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
into an object; the objects are linked into one shared library with a plain
C interface, loaded through ``ctypes``.  Pointers and the CUDA stream pass
as ``c_void_p``; each launch function returns ``cudaGetLastError()`` and the
wrappers raise when it is not 0.

The library lands in ``csrc/_build/`` (listed in ``.gitignore``) under a
name keyed by every ``csrc/*.cu`` and ``*.cuh`` and the flags, so a checkout
builds at first use and reuses the library afterwards.  ``nvcc`` runs with
``-Xptxas -v``; its report (registers, spill stores and loads, stack frame
and shared memory of every kernel) is kept beside the library and read back
by ``build_report``.  Nothing here runs at import: the CPU tests import
every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

import torch

from ..utils import trace

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_BUILD = os.path.join(_CSRC, "_build")
SOURCES = ("wide_traverse.cu", "split_traverse.cu", "tristream.cu",
           "post.cu", "shade.cu", "hit.cu")
# -fmad=false: no fused multiply-add, so the kernels round like the unfused
# PyTorch ops of their plain versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _key() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                       + glob.glob(os.path.join(_CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(so: str) -> None:
    """Compile ``SOURCES`` (one nvcc each, all started together), link them
    into ``so`` and write nvcc's report (the ``-Xptxas -v`` lines) to
    ``so + ".ptxas.txt"``."""
    nvcc = _nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_BUILD)
    try:
        objs, procs = [], []
        for s in SOURCES:
            obj = os.path.join(tmp, s.replace(".cu", ".o"))
            objs.append(obj)
            procs.append((s, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", os.path.join(_CSRC, s), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors, report = [], []
        for s, p in procs:
            out, _ = p.communicate()
            text = out.decode(errors="replace")
            if p.returncode != 0:
                errors.append(f"{s}:\n{text}")
            report.append(f"== {s}\n{text}")
        if errors:
            raise RuntimeError("nvcc failed\n" + "\n".join(errors))
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp_so, *objs], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n"
                               + link.stdout.decode(errors="replace"))
        with open(so + ".ptxas.txt", "w") as f:
            f.write("\n".join(report))
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _kernel_name(mangled: str) -> str:
    """The function name inside an Itanium-mangled name (``_Z21foo...``,
    ``_ZN12_GLOBAL__N_13fooE...``); the mangled name when it is not one."""
    if not mangled.startswith("_Z"):
        return mangled
    i = 3 if mangled.startswith("_ZN") else 2
    names = []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        size = int(mangled[i:j])
        names.append(mangled[j:j + size])
        i = j + size
        if not mangled.startswith("_ZN"):
            break
    names = [x for x in names if not x.startswith("_GLOBAL__N")]
    return names[-1] if names else mangled


def parse_ptxas(text: str) -> dict:
    """Per kernel, from nvcc's ``-Xptxas -v`` report: registers, spill
    stores and loads (bytes), stack frame (bytes) and static shared memory
    (bytes)."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), {
                "registers": 0, "spill_stores": 0, "spill_loads": 0,
                "stack_frame": 0, "smem": 0})
            continue
        if cur is None:
            continue
        for key, pat in (("stack_frame", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                cur[key] = int(m.group(1))
    return out


def _so_path() -> str:
    return os.path.join(_BUILD, f"libbuas_torch_kernels_{_key()}.so")


def load():
    """The loaded kernel library; builds it first if needed (the set-up
    phase ``kernel_load``).  Raises when the build fails: no caller falls
    back to a plain version."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        with trace.phase("kernel_load"):
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.wide_traverse_launch.restype = ci
        lib.wide_traverse_launch.argtypes = [
            vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, ci,
            vp, vp, vp, vp, vp, vp, vp, vp, ci, vp]
        lib.split_traverse_launch.restype = ci
        lib.split_traverse_launch.argtypes = [
            vp, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, ci,
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, vp]
        for name in ("wide_traverse", "split_traverse"):
            getattr(lib, f"{name}_max_stack").restype = ci
            getattr(lib, f"{name}_max_stack").argtypes = []
            getattr(lib, f"{name}_blocks").restype = ci
            getattr(lib, f"{name}_blocks").argtypes = [ci]
        lib.split_traverse_counted_blocks.restype = ci
        lib.split_traverse_counted_blocks.argtypes = [ci]
        lib.tristream_closest_launch.restype = ci
        lib.tristream_closest_launch.argtypes = [
            vp, ci, ci, vp, vp, vp, vp, vp, vp, vp, ci, vp, vp, vp, vp, vp]
        lib.tristream_blocks.restype = ci
        lib.tristream_blocks.argtypes = []
        lib.post_rgba8_launch.restype = ci
        lib.post_rgba8_launch.argtypes = [
            vp, vp, vp, ci, ci, cf, cf, cf, cf, cf, cf, ci, ci, ci, ci, ci,
            vp]
        for name in ("shade_hit", "shade_next", "hit_record"):
            getattr(lib, f"{name}_launch").restype = ci
            getattr(lib, f"{name}_launch").argtypes = [vp, vp]
        for name in ("shade_args_size", "hit_args_size"):
            getattr(lib, name).restype = ci
            getattr(lib, name).argtypes = []
        _lib = lib
        return _lib


def build_report() -> dict:
    """``parse_ptxas`` of the loaded library's build (``load`` first)."""
    path = _so_path() + ".ptxas.txt"
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return parse_ptxas(f.read())


def check_lanes(n: int, dev, items) -> None:
    """Each (name, tensor, dtype) is an (n,) tensor of that dtype on
    ``dev`` with unit stride."""
    for name, x, dt in items:
        if not isinstance(x, torch.Tensor) or x.dtype != dt \
                or x.shape != (n,) or x.stride() != (1,) or x.device != dev:
            got = (f"{x.dtype} {tuple(x.shape)} stride {x.stride()} on "
                   f"{x.device}" if isinstance(x, torch.Tensor)
                   else type(x).__name__)
            raise ValueError(f"{name} must be a unit-stride ({n},) {dt} "
                             f"tensor on {dev}, got {got}")


def check_table(name: str, x, dt, shape, dev) -> None:
    """``x`` is a contiguous tensor of dtype ``dt`` on ``dev`` whose shape
    matches ``shape`` (None matches any size)."""
    if x.dtype != dt or x.device != dev or not x.is_contiguous() or any(
            want is not None and got != want
            for got, want in zip(x.shape, shape)) or x.dim() != len(shape):
        raise ValueError(f"{name} must be a contiguous {dt} tensor of shape "
                         f"{shape} on {dev}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def vec_lanes(name: str, v, dt=torch.float32):
    """``check_lanes`` items of a ``Vec3``'s three components."""
    return [(f"{name}.{c}", x, dt) for c, x in zip("xyz", v)]


def vec_ptrs(v):
    """A ``Vec3``'s three data pointers, as a ctypes array."""
    return (ctypes.c_void_p * 3)(*(x.data_ptr() for x in v))


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
