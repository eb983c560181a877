"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
into an object; the objects are linked into one shared library with a plain
C interface, loaded through ``ctypes``.  Pointers and the CUDA stream pass
as ``c_void_p``; each launch function returns ``cudaGetLastError()`` and the
wrappers raise when it is not 0.

The library lands in ``csrc/_build/`` (listed in ``.gitignore``) under a
name keyed by the sources and flags, so a checkout builds at first use and
reuses the library afterwards.  Nothing here runs at import: the CPU tests
import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_BUILD = os.path.join(_CSRC, "_build")
SOURCES = ("wide_traverse.cu", "split_traverse.cu", "tristream.cu",
           "post.cu")
# -fmad=false: no fused multiply-add, so the kernels round like the unfused
# PyTorch ops of their plain versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

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
    for s in SOURCES:
        with open(os.path.join(_CSRC, s), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(so: str) -> None:
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
        errors = []
        for s, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{s}:\n{out.decode(errors='replace')}")
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
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load():
    """The loaded kernel library; builds it first if needed.  Raises when
    the build fails: no caller falls back to a plain version."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = os.path.join(_BUILD, f"libbuas_torch_kernels_{_key()}.so")
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.wide_traverse_launch.restype = ci
        lib.wide_traverse_launch.argtypes = [
            vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, ci,
            vp, vp, vp, vp, vp, vp, vp]
        lib.wide_traverse_max_stack.restype = ci
        lib.wide_traverse_max_stack.argtypes = []
        lib.split_traverse_launch.restype = ci
        lib.split_traverse_launch.argtypes = [
            vp, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, ci,
            vp, vp, vp, vp, vp, vp, vp]
        lib.split_traverse_max_stack.restype = ci
        lib.split_traverse_max_stack.argtypes = []
        lib.tristream_closest_launch.restype = ci
        lib.tristream_closest_launch.argtypes = [
            vp, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.post_rgba8_launch.restype = ci
        lib.post_rgba8_launch.argtypes = [
            vp, vp, vp, ci, ci, cf, cf, cf, cf, cf, cf, ci, ci, ci, ci, ci,
            vp]
        _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
