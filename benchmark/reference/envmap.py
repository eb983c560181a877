"""The equirect environment map: its RGBE decoding, its sampling tables,
the lookup on a miss, the solid-angle pdf and the alias sample of env
next-event estimation.

Everything is worked out here from the map's file: the Radiance ``.hdr``
decoder (flat and adaptive-RLE scanlines, the ``-Y h +X w`` orientation),
and a Walker alias table over the sin-weighted texel luminance with the
per-texel solid-angle pdf numerator.  The table is built with the same
arithmetic and the same order of pops as the renderer's, so a sample maps
to the same texel; the lookup truncates toward zero and wraps by floor
modulo (integrators.cpp:274-288); the sample jitters inside its texel by a
hash of the sample's own numbers.  Pixels and tables are float32 (alias
indices int64), and so is every direction, pdf and radiance below.

Departures: an exponent byte of 9 or less decodes to black (the renderer's
``decode_radiance_color``); a file this decoder cannot read raises, where
the renderer's loader returns nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rng
from .vec import PI, TAU, Vec3

# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def _scanlines(buf: np.ndarray, w: int, h: int) -> np.ndarray:
    """(h, w, 4) uint8 RGBE from the scanline bytes ``buf``."""
    out = np.zeros((h, w, 4), np.uint8)
    at = 0
    for y in range(h):
        if at + 4 > len(buf):
            raise ValueError("the map's scanlines end early")
        rle = (8 <= w < 32768 and buf[at] == 2 and buf[at + 1] == 2
               and (int(buf[at + 2]) << 8 | int(buf[at + 3])) == w)
        if not rle:  # a flat scanline
            out[y] = buf[at:at + 4 * w].reshape(w, 4)
            at += 4 * w
            continue
        at += 4
        for comp in range(4):  # four component streams, each runs or literals
            x = 0
            while x < w:
                count = int(buf[at])
                at += 1
                if count > 128:
                    out[y, x:x + count - 128, comp] = buf[at]
                    at += 1
                    x += count - 128
                else:
                    out[y, x:x + count, comp] = buf[at:at + count]
                    at += count
                    x += count
    return out


def decode_hdr(data: bytes) -> np.ndarray:
    """(H, W, 3) float32 radiance of a Radiance ``.hdr`` file's bytes."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance .hdr file")
    end = data.find(b"\n\n")
    if end < 0:
        raise ValueError("the .hdr header does not end")
    nl = data.find(b"\n", end + 2)
    res = data[end + 2:nl].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError("only the -Y h +X w orientation is read")
    h, w = int(res[1]), int(res[3])
    rgbe = _scanlines(np.frombuffer(data, np.uint8, offset=nl + 1), w, h)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 9, np.exp2((e - 136).astype(np.float64)), 0.0)
    return ((rgbe[..., :3].astype(np.float32) + 0.5)
            * scale[..., None].astype(np.float32)).astype(np.float32)


def load(path: str) -> np.ndarray:
    """The map in the file ``path``."""
    with open(path, "rb") as f:
        return decode_hdr(f.read())


# ---------------------------------------------------------------------------
# the alias table
# ---------------------------------------------------------------------------

def alias_table(env: np.ndarray):
    """(prob (K,) float32, alias (K,) int64, pdf_num (K,) float32), K = H*W:
    Walker's table over the texels' luminance times the sine of their
    latitude's polar angle; a direction's solid-angle pdf is its texel's
    ``pdf_num`` over the cosine of its latitude."""
    h, w, _ = env.shape
    luma = (0.2126 * env[..., 0] + 0.7152 * env[..., 1]
            + 0.0722 * env[..., 2])
    theta = (np.arange(h) + 0.5) / h * np.pi
    weighted = (np.maximum(luma, 0.0) * np.sin(theta)[:, None]).reshape(-1)
    k = weighted.size
    total = weighted.sum()
    p = (np.full(k, 1.0 / k, np.float64) if total <= 0.0
         else weighted.astype(np.float64) / total)
    scaled = p * k
    prob = np.ones(k, np.float32)
    alias = np.arange(k, dtype=np.int64)
    small = [i for i in range(k) if scaled[i] < 1.0]
    large = [i for i in range(k) if scaled[i] >= 1.0]
    while small and large:
        s, g = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    return prob, alias, (p * k / (TAU * PI)).astype(np.float32)


class EnvMap(NamedTuple):
    pixels: torch.Tensor  # (H, W, 3) float32
    prob: torch.Tensor  # (K,) float32
    alias: torch.Tensor  # (K,) int64
    pdf_num: torch.Tensor  # (K,) float32


def build(path: str, device) -> EnvMap:
    env = load(path)
    prob, alias, pdf_num = alias_table(env)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return EnvMap(t(env), t(prob), t(alias), t(pdf_num))


# ---------------------------------------------------------------------------
# lookup, pdf and sample
# ---------------------------------------------------------------------------

def _texel(env: EnvMap, pix) -> Vec3:
    flat = env.pixels.reshape(-1, 3)
    return Vec3(flat[pix, 0], flat[pix, 1], flat[pix, 2])


def _angles(d: Vec3):
    """(u, v, theta): the direction's equirect coordinates."""
    phi = torch.atan2(d.z, d.x)
    theta = torch.asin(torch.clamp(d.y, -1.0, 1.0))
    return 0.5 + 0.5 / PI * phi, 0.5 + 1.0 / PI * theta, theta


def lookup(env: EnvMap, d: Vec3) -> Vec3:
    """The radiance the map sends along ``d``: its nearest texel, the
    coordinates truncated toward zero, then wrapped."""
    h, w, _ = env.pixels.shape
    u, v, _ = _angles(d)
    x = torch.remainder((u * w).to(torch.int64), w)
    y = torch.remainder((v * h).to(torch.int64), h)
    return _texel(env, y * w + x)


def pdf(env: EnvMap, d: Vec3):
    """The solid-angle pdf with which ``sample`` draws ``d``."""
    h, w, _ = env.pixels.shape
    u, v, theta = _angles(d)
    row = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    col = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    return env.pdf_num[row * w + col] / torch.clamp(torch.cos(theta),
                                                    min=1e-8)


def _hash01(x):
    """A uniform in [0, 1) from the float32 bits of ``x``."""
    b = x.to(torch.float32).view(torch.int32).to(torch.int64) & rng.M32
    b = rng.mul32(b ^ (b >> 16), 0x7FEB352D)
    b = rng.mul32(b ^ (b >> 15), 0x846CA68B)
    b = b ^ (b >> 16)
    return b.to(torch.float32) * (1.0 / 4294967296.0)


def sample(env: EnvMap, u, v):
    """(direction, solid-angle pdf, radiance) of the uniforms ``u``, ``v``:
    a texel from the alias table, a point inside it from a hash of the
    two."""
    h, w, _ = env.pixels.shape
    k = h * w
    first = torch.clamp((u * k).to(torch.int64), 0, k - 1)
    idx = torch.where(v < env.prob[first], first, env.alias[first])
    row = idx // w
    col = idx - row * w
    du = _hash01(u * 7193.17 + v)
    dv = _hash01(v * 4021.73 - u)
    phi = ((col.to(torch.float32) + du) / w - 0.5) * TAU
    theta = ((row.to(torch.float32) + dv) / h - 0.5) * PI
    cos_t = torch.cos(theta)
    d = Vec3(cos_t * torch.cos(phi), torch.sin(theta), cos_t * torch.sin(phi))
    return (d, env.pdf_num[idx] / torch.clamp(cos_t, min=1e-8),
            _texel(env, idx))
