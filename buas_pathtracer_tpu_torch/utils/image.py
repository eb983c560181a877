"""Image output: BMP, PNG and Radiance .HDR, and a procedural HDR sky.

Counterpart of ``buas_pathtracer_tpu/utils/image.py``: ``write_bmp`` (:16)
is the reference's 32bpp top-down writer (assets.cpp:671-724, used by "Take
picture"), ``write_png`` (:33) a minimal stdlib-zlib PNG encoder,
``write_hdr`` (:56) and ``procedural_sky_hdr`` (:80).  numpy only; the
files are byte-equal to the JAX package's (``tests/test_torch_image.py``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_bmp(path: str, rgba: np.ndarray) -> None:
    """rgba: (H, W, 4) uint8.  Stored BGRA, top-down (negative height)."""
    h, w, _ = rgba.shape
    pixel_bytes = rgba[..., [2, 1, 0, 3]].astype(np.uint8).tobytes()
    # BITMAPFILEHEADER (14) + BITMAPINFOHEADER (40)
    file_header = struct.pack("<2sIHHI", b"BM", 14 + 40 + len(pixel_bytes),
                              0, 0, 14 + 40)
    info_header = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 32, 0,
                              len(pixel_bytes), 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(file_header)
        f.write(info_header)
        f.write(pixel_bytes)


def png_bytes(rgb: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W, 4) image -> PNG file bytes (8-bit, filter 0,
    zlib level 6); values outside uint8 are clipped."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    h, w, channels = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if channels == 4 else 2, 0, 0,
                       0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """rgb: (H, W, 3) or (H, W, 4) uint8."""
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write a Radiance .HDR (RGBE, flat scanlines, -Y +X orientation) that
    ``utils.assets.parse_hdr`` reads back."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    maxc = rgb.max(axis=-1)
    e = np.where(maxc > 1e-32,
                 np.ceil(np.log2(np.maximum(maxc, 1e-32))) + 1, 0)
    scale = np.where(maxc > 1e-32, 2.0 ** (8.0 - e), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def procedural_sky_hdr(h: int = 128, w: int = 256, sun_dir=(0.4, 0.6, 0.2),
                       sun_intensity: float = 400.0) -> np.ndarray:
    """(h, w, 3) equirect HDR sky: gradient, sun disk and horizon glow."""
    sd = np.asarray(sun_dir, np.float64)
    sd = sd / np.linalg.norm(sd)
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = (v - 0.5) * np.pi  # [-pi/2, pi/2], +y up
    phi = (u - 0.5) * 2 * np.pi
    y = np.sin(theta)[:, None] * np.ones(w)[None, :]
    cx = np.cos(theta)[:, None] * np.sin(phi)[None, :]
    cz = np.cos(theta)[:, None] * -np.cos(phi)[None, :]
    sky = np.zeros((h, w, 3), np.float32)
    ty = np.clip(y, 0, 1)
    sky[..., 0] = 0.25 + 0.15 * (1 - ty)
    sky[..., 1] = 0.38 + 0.22 * (1 - ty)
    sky[..., 2] = 0.65 + 0.15 * ty
    sky[y < 0] = np.array([0.25, 0.22, 0.2], np.float32)
    glow = np.exp(-np.abs(y) * 8.0).astype(np.float32)
    sky += glow[..., None] * np.array([0.5, 0.4, 0.25], np.float32)
    cosang = cx * sd[0] + y * sd[1] + cz * sd[2]
    disk = (cosang > 0.9995).astype(np.float32)
    halo = np.clip(cosang, 0, 1) ** 64
    sky += disk[..., None] * sun_intensity * np.array([1.0, 0.95, 0.85],
                                                      np.float32)
    sky += halo[..., None] * 2.0 * np.array([1.0, 0.9, 0.7], np.float32)
    return sky.astype(np.float32)
