"""Radiance .HDR environment maps.

Counterpart of the HDR half of ``buas_pathtracer_tpu/utils/assets.py``
(``_decode_rgbe`` :119, ``parse_hdr`` :131, ``load_environment_map`` :191;
reference assets.cpp:406-665): the header's FORMAT check, the ``-Y h +X w``
resolution string, adaptive-RLE or flat scanlines, and the RGBE decode with
the reference's ``exp > 9`` cutoff.  The decode is numpy only; its output is
value-equal to the JAX package's (``tests/test_torch_envmap.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


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
    rgbe = _decode_scanlines(np.frombuffer(data, np.uint8, offset=pos), w, h)
    return None if rgbe is None else _decode_rgbe(rgbe)


def load_environment_map(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) float32 equirect map, or None when the file is missing or
    unreadable (the reference's gradient-sky fallback; callers that need
    the map raise on None)."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return parse_hdr(f.read())
