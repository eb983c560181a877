"""Native host code in C++, bound through ctypes: the binned-SAH BVH build,
the threaded subtree flattener, the wide-BVH collapse, the OBJ parser and
the Radiance HDR RLE decoder.

Counterpart of ``buas_pathtracer_tpu/native/__init__.py``, with the port's
own copies of ``bvh_builder.cpp``, ``obj_parser.cpp`` and
``wide_collapse.cpp`` under ``src/``.
The shared library is built with g++ at first use into ``_build/`` (listed
in ``.gitignore``), keyed by a fingerprint of the sources, the host and the
compiler, and written through a temporary file so concurrent test workers
never load a half-written library.  The flags equal the JAX package's, so
both packages build identical tables on one machine.  Without a toolchain
(or with ``BUAS_NO_NATIVE=1``) the numpy builders in ``ops/`` and the
Python parsers in ``utils/assets.py`` take over; the builders give valid
but different trees.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform as _platform
import subprocess
import tempfile
import threading

import numpy as np

from ..utils import trace

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_BUILD = os.path.join(_DIR, "_build")
_SOURCES = ["bvh_builder.cpp", "obj_parser.cpp", "wide_collapse.cpp"]
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False


def _fingerprint(srcs) -> str:
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(_platform.machine().encode())
    h.update(_platform.processor().encode())
    try:  # -march=native code must not load on another CPU model
        with open("/proc/cpuinfo", "rb") as f:
            h.update(b"".join(ln for ln in f if ln.startswith(
                (b"model name", b"flags")))[:4096])
    except OSError:
        pass
    try:
        h.update(subprocess.run(["g++", "--version"], capture_output=True,
                                timeout=10).stdout)
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        pass
    return h.hexdigest()[:16]


def _build():
    """Path of the built library, or None without a working g++."""
    srcs = [os.path.join(_SRC, s) for s in _SOURCES]
    so = os.path.join(_BUILD, f"libbuas_torch_native_{_fingerprint(srcs)}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++"] + _FLAGS + ["-o", tmp] + srcs, check=True,
                       capture_output=True, timeout=180)
        os.replace(tmp, so)
        return so
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("BUAS_NO_NATIVE"):
            return None
        with trace.phase("kernel_load"):  # built or loaded
            so = _build()
            lib = None if so is None else ctypes.CDLL(so)
        if lib is None:
            return None

        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

        lib.bvh_build.restype = ctypes.c_void_p
        lib.bvh_build.argtypes = [f32p, f32p, ctypes.c_int32, ctypes.c_int32,
                                  ctypes.POINTER(ctypes.c_int32)]
        lib.bvh_fetch.restype = None
        lib.bvh_fetch.argtypes = [ctypes.c_void_p, f32p, f32p, i32p, i32p,
                                  i8p, i32p]
        lib.bvh_release.restype = None
        lib.bvh_release.argtypes = [ctypes.c_void_p]
        lib.bvh_flatten_subtree.restype = None
        lib.bvh_flatten_subtree.argtypes = [
            f32p, f32p, i32p, i32p, ctypes.c_int32, f32p, ctypes.c_float,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, f32p, f32p, i32p, i8p, i32p, i32p, i32p]
        lib.obj_parse.restype = ctypes.c_void_p
        lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_int32,
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.POINTER(ctypes.c_int32)]
        lib.obj_fetch.restype = None
        lib.obj_fetch.argtypes = [ctypes.c_void_p, f32p, ctypes.c_void_p,
                                  ctypes.c_void_p]
        lib.obj_release.restype = None
        lib.obj_release.argtypes = [ctypes.c_void_p]
        lib.hdr_decode.restype = ctypes.c_int32
        lib.hdr_decode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32,
                                   ctypes.c_int32, u8p]
        lib.wide_collapse.restype = ctypes.c_void_p
        lib.wide_collapse.argtypes = [
            f32p, f32p, i32p, i32p, ctypes.c_int32, ctypes.c_int32,
            f32p, f32p, f32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.wide_fetch.restype = None
        lib.wide_fetch.argtypes = [ctypes.c_void_p, f32p]
        lib.wide_release.restype = None
        lib.wide_release.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_bvh_native(lo: np.ndarray, hi: np.ndarray, max_leaf_size: int):
    """C++ binned-SAH build. Returns ops.bvh.BuildNodes or None."""
    lib = _load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    m = lo.shape[0]
    n_nodes = ctypes.c_int32(0)
    h = lib.bvh_build(lo, hi, m, int(max_leaf_size), ctypes.byref(n_nodes))
    if not h:
        return None
    n = n_nodes.value
    out_lo = np.empty((n, 3), np.float32)
    out_hi = np.empty((n, 3), np.float32)
    left = np.empty(n, np.int32)
    count = np.empty(n, np.int32)
    axis = np.empty(n, np.int8)
    order = np.empty(m, np.int32)
    lib.bvh_fetch(h, out_lo, out_hi, left, count, axis, order)
    lib.bvh_release(h)
    from ..ops.bvh import BuildNodes
    return BuildNodes(out_lo, out_hi, left, count, axis, order)


def flatten_subtree_native(bnodes, fwd: np.ndarray, pad: float,
                           tri_base: int, inst: int, base: int,
                           kind_internal: int, kind_leaf: int,
                           out_lo, out_hi, out_miss, out_kind, out_first,
                           out_count, out_inst) -> bool:
    """Emit a threaded subtree into the preallocated arrays, node ``base``
    first.  False without the native library."""
    lib = _load()
    if lib is None:
        return False
    lib.bvh_flatten_subtree(
        np.ascontiguousarray(bnodes.lo, np.float32),
        np.ascontiguousarray(bnodes.hi, np.float32),
        np.ascontiguousarray(bnodes.left_first, np.int32),
        np.ascontiguousarray(bnodes.count, np.int32),
        int(bnodes.count.shape[0]),
        np.ascontiguousarray(fwd, np.float32).reshape(-1),
        float(pad), int(tri_base), int(inst), int(base),
        int(kind_internal), int(kind_leaf),
        out_lo, out_hi, out_miss, out_kind, out_first, out_count, out_inst)
    return True


def parse_obj_native(text: bytes, flip: bool):
    """C++ OBJ parse.  Returns (tri, nrm or None, tex or None), None when
    the text is rejected, or False without the native library."""
    lib = _load()
    if lib is None:
        return False
    n_tris = ctypes.c_int32(0)
    has_n = ctypes.c_int32(0)
    has_t = ctypes.c_int32(0)
    h = lib.obj_parse(text, len(text), 1 if flip else 0,
                      ctypes.byref(n_tris), ctypes.byref(has_n),
                      ctypes.byref(has_t))
    if not h:
        return None
    t = n_tris.value
    tri = np.empty((t, 3, 3), np.float32)
    nrm = np.empty((t, 3, 3), np.float32) if has_n.value else None
    tex = np.empty((t, 3, 2), np.float32) if has_t.value else None
    lib.obj_fetch(
        h, tri,
        nrm.ctypes.data_as(ctypes.c_void_p) if nrm is not None else None,
        tex.ctypes.data_as(ctypes.c_void_p) if tex is not None else None)
    lib.obj_release(h)
    return tri, nrm, tex


def hdr_decode_native(payload: bytes, w: int, h: int):
    """C++ RLE decode -> (h, w, 4) uint8 RGBE; None on a decode error or
    without the native library (``available()`` tells them apart)."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(payload, np.uint8)
    out = np.zeros((h, w, 4), np.uint8)
    rc = lib.hdr_decode(np.ascontiguousarray(buf), len(buf), w, h, out)
    return out if rc == 0 else None


def wide_collapse_native(world_lo, world_hi, left_first, count, root: int,
                         tri_a, tri_e1, tri_e2, tri_base: int, inst: int,
                         row_base: int, pad: float, wide: int = 8,
                         row_w: int = 64):
    """C++ wide-BVH subtree collapse.  Returns ((n_rows, row_w) float32 rows,
    depth) with the subtree root at local row 0 and child links pre-offset by
    ``row_base``, or None without the native library."""
    lib = _load()
    if lib is None:
        return None
    n_rows = ctypes.c_int32(0)
    depth = ctypes.c_int32(0)
    h = lib.wide_collapse(
        np.ascontiguousarray(world_lo, np.float32),
        np.ascontiguousarray(world_hi, np.float32),
        np.ascontiguousarray(left_first, np.int32),
        np.ascontiguousarray(count, np.int32),
        int(len(count)), int(root),
        np.ascontiguousarray(tri_a, np.float32),
        np.ascontiguousarray(tri_e1, np.float32),
        np.ascontiguousarray(tri_e2, np.float32),
        int(tri_base), int(inst), int(row_base), float(pad),
        int(wide), int(row_w),
        ctypes.byref(n_rows), ctypes.byref(depth))
    rows = np.empty((n_rows.value, row_w), np.float32)
    lib.wide_fetch(h, rows)
    lib.wide_release(h)
    return rows, depth.value
