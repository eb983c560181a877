"""Asset IO: OBJ meshes and Radiance .HDR environment maps.

Counterpart of ``buas_pathtracer_tpu/utils/assets.py``, with the reference's
tolerance rules (assets.cpp:187-665).

OBJ (``parse_obj`` :29, ``_parse_obj_py`` :42, ``load_mesh`` :106): v/vt/vn
records, faces with '/'-separated indices, negative (relative) indices,
n-gon fans, an optional winding flip, and texcoord/normal triangle arrays
that must match the triangle count or the mesh is rejected.

Radiance HDR (``_decode_rgbe`` :119, ``parse_hdr`` :131,
``load_environment_map`` :191): the header's FORMAT check, the ``-Y h +X w``
resolution string, adaptive-RLE or flat scanlines, and the RGBE decode with
the reference's ``exp > 9`` cutoff.

Both go native first (``native/src/obj_parser.cpp``), as the JAX package
does: when the native library loads, its verdict is final.  The Python OBJ
parser and the numpy scanline decoder run only without the library (no
g++, or ``BUAS_NO_NATIVE=1``).  On a malformed ``v`` line the two parsers
differ, as the JAX package's do: the Python one zeroes the bad field, the
native one the rest of the line.

A missing file gives None: the scenes then skip the mesh or fall back to
the gradient sky, as the reference does.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..models.mesh import Mesh


def parse_obj(text: str, winding: str = "ccw") -> Optional[Mesh]:
    """The OBJ text as a ``Mesh``, or None when it is rejected: the native
    parser's verdict, or ``_parse_obj_py``'s without the native library."""
    from ..native import parse_obj_native
    res = parse_obj_native(text.encode("utf-8", errors="replace"),
                           winding == "cw")
    if res is False:  # no native library
        return _parse_obj_py(text, winding)
    if res is None:
        return None
    tri, nrm, tex = res
    return Mesh(triangles=tri, normals=nrm, texcoords=tex)


def _parse_obj_py(text: str, winding: str = "ccw") -> Optional[Mesh]:
    vertices = [(0.0, 0.0, 0.0)]  # NULL entries: OBJ indices are 1-based
    texcoords = [(0.0, 0.0, 0.0)]
    normals = [(0.0, 0.0, 0.0)]
    tri_v, tri_t, tri_n = [], [], []
    flip = winding == "cw"

    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        tag = parts[0]
        if tag in ("v", "vn", "vt"):
            target = (vertices if tag == "v"
                      else normals if tag == "vn" else texcoords)
            vals = [0.0, 0.0, 0.0]
            for i, p in enumerate(parts[1:4]):
                try:
                    vals[i] = float(p)
                except ValueError:
                    pass
            target.append(tuple(vals))
        elif tag == "f":
            faces = ([], [], [])  # vertex, texcoord, normal indices
            counts = (len(vertices), len(texcoords), len(normals))
            for corner in parts[1:]:
                comps = corner.split("/")
                for fi in range(min(3, len(comps))):
                    if comps[fi] == "":
                        continue
                    idx = int(comps[fi])
                    if idx < 0:
                        idx = counts[fi] + idx
                    faces[fi].append(idx)
            if len(faces[0]) > 32:
                return None  # "Too many vertices for face"
            if len(faces[0]) < 3:
                return None  # "Not enough vertices to make a face"
            a, b, c = (2, 1, 0) if flip else (0, 1, 2)
            for fan, src, dst in zip(faces, (vertices, texcoords, normals),
                                     (tri_v, tri_t, tri_n)):
                for i in range(1, len(fan) - 1):
                    tri = [None, None, None]
                    tri[a] = src[fan[0]]
                    tri[b] = src[fan[i]]
                    tri[c] = src[fan[i + 1]]
                    dst.append(tri)

    if not tri_v:
        return None
    if tri_t and len(tri_t) != len(tri_v):
        return None
    if tri_n and len(tri_n) != len(tri_v):
        return None
    return Mesh(
        triangles=np.asarray(tri_v, np.float32),
        normals=np.asarray(tri_n, np.float32) if tri_n else None,
        texcoords=np.asarray(tri_t, np.float32)[..., :2] if tri_t else None,
    )


def load_mesh(path: str, winding: str = "ccw") -> Optional[Mesh]:
    """load_mesh (raytracer.cpp:148-158): a missing file gives None and the
    scene skips the mesh."""
    if not os.path.exists(path):
        return None
    with open(path, "r", errors="replace") as f:
        return parse_obj(f.read(), winding)


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 -> (..., 3) float32; an exponent byte <= 9 decodes to
    black (decode_radiance_color)."""
    e = rgbe[..., 3].astype(np.int32)
    valid = e > 9
    # float_from_bits((exp-9)<<23) == 2^(exp-9-127)
    scale = np.where(valid, np.exp2((e - 9 - 127).astype(np.float64)), 0.0)
    rgb = (rgbe[..., :3].astype(np.float32) + 0.5) \
        * scale[..., None].astype(np.float32)
    return rgb.astype(np.float32)


def _decode_scanlines(buf: np.ndarray, w: int, h: int) -> Optional[np.ndarray]:
    out = np.zeros((h, w, 4), np.uint8)
    at = 0
    for y in range(h):
        if at + 4 > len(buf):
            return None
        if 8 <= w < 32768 and buf[at] == 2 and buf[at + 1] == 2 and \
                (int(buf[at + 2]) << 8 | int(buf[at + 3])) == w:
            # adaptive RLE: four separated component streams
            at += 4
            for comp in range(4):
                x = 0
                while x < w:
                    count = int(buf[at])
                    at += 1
                    if count > 128:  # run
                        out[y, x:x + count - 128, comp] = buf[at]
                        at += 1
                        x += count - 128
                    else:  # literal
                        out[y, x:x + count, comp] = buf[at:at + count]
                        at += count
                        x += count
        else:
            # flat scanline (old RLE is not produced by modern tools)
            need = w * 4
            out[y] = buf[at:at + need].reshape(w, 4)
            at += need
    return out


def parse_hdr(data: bytes) -> Optional[np.ndarray]:
    """Returns (H, W, 3) float32, or None for a file it cannot read."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        return None
    pos = 0
    while True:  # header lines until the blank one
        nl = data.find(b"\n", pos)
        if nl < 0:
            return None
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.find(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        return None  # only the common orientation, like the reference
    h, w = int(res[1]), int(res[3])
    from .. import native
    if native.available():  # the native verdict is final
        rgbe = native.hdr_decode_native(data[pos:], w, h)
    else:
        rgbe = _decode_scanlines(np.frombuffer(data, np.uint8, offset=pos),
                                 w, h)
    return None if rgbe is None else _decode_rgbe(rgbe)


def load_environment_map(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) float32 equirect map, or None when the file is missing or
    unreadable (the reference's gradient-sky fallback; callers that need
    the map raise on None)."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return parse_hdr(f.read())
