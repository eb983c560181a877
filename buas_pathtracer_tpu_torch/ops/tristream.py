"""Dense triangle-stream closest hit: every ray against every triangle.

Counterpart of ``buas_pathtracer_tpu/ops/pallas_tristream.py``
(``intersect_tristream`` :86, ``pack_tris`` :130).  ``intersect_tristream``
launches ``csrc/tristream.cu`` (its core: ``csrc/tristream.cuh``) for CUDA
tensors and runs ``intersect_tristream_plain`` for CPU tensors; there is no
fallback from one to the other.  It is an entry point of its own, as in the
JAX package: the renderer walks the BVH instead.

The stream is a (T, 10) float32 table of rows [a.xyz, e1.xyz, e2.xyz, id]
with world-space triangles; a row whose id is negative is padding and never
hits.  Per ray the result is (t, tri_id, u, v): the nearest hit with
t >= TRI_EPS, the first triangle in stream order winning a tie; a miss
returns t = BIG_T (3e38), id -1 and u = v = 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.vec import Vec3
from ..utils import trace
from . import cuda_lib
from .wide_bvh import KIND_TRIS, WIDE_LEAF

TRI_EPS = 1e-9
BIG_T = 3.0e38
TRI_W = 10
# rays of one stream block of the kernel (csrc/tristream.cuh THREADS x RAYS)
BLOCK_RAYS = 512
# blockIdx.y bounds the stream's splits
MAX_SPLITS = 65535
# the grid holds this many waves of the blocks resident on the card: with
# one wave, the blocks that finish first leave their SMs idle (65,536 rays
# x 61,440 triangles on an H100 80GB HBM3 at 700 W: 6.49 ms with 7 splits,
# 5.68 ms with 115; PERF.md, the triangle stream's steps)
SPLIT_WAVES = 16
# the plain version tests rays against triangles in chunks of at most this
# many (ray, triangle) pairs, so the CPU never holds N x T
PLAIN_CHUNK_PAIRS = 1 << 22


def pack_tris(tri_a: np.ndarray, tri_e1: np.ndarray, tri_e2: np.ndarray
              ) -> np.ndarray:
    """(T,3)x3 world-space triangle arrays -> (T, 10) stream layout."""
    t = tri_a.shape[0]
    out = np.empty((t, TRI_W), np.float32)
    out[:, 0:3] = tri_a
    out[:, 3:6] = tri_e1
    out[:, 6:9] = tri_e2
    out[:, 9] = np.arange(t, dtype=np.float32)
    return out


def tris_from_rows(rows: torch.Tensor) -> torch.Tensor:
    """The (T, 10) stream of a unified row table's triangle leaves, in row
    and slot order; a triangle's id is its leaf's lane 2 + k, the id the
    traversal reports."""
    leaf = rows[rows[:, 0] == KIND_TRIS]
    count = leaf[:, 1].to(torch.int64)
    k = torch.arange(WIDE_LEAF, device=rows.device)
    slots = leaf[:, 8:8 + 9 * WIDE_LEAF].reshape(-1, WIDE_LEAF, 9)
    ids = leaf[:, 2][:, None] + k.to(torch.float32)
    used = k[None, :] < count[:, None]
    return torch.cat([slots[used], ids[used][:, None]], dim=1).contiguous()


def stream_splits(n: int, n_tris: int, resident_blocks: int) -> int:
    """Splits of the stream for ``n`` rays: as many as make the grid of
    (ray tiles) x (splits) SPLIT_WAVES waves of the blocks resident on the
    card, at least 1 and at most one per triangle."""
    if resident_blocks < 1:
        raise RuntimeError("the card's occupancy query returned no blocks")
    tiles = max(1, -(-n // BLOCK_RAYS))
    return max(1, min(SPLIT_WAVES * resident_blocks // tiles, n_tris,
                      MAX_SPLITS))


def _check(ray_o: Vec3, ray_d: Vec3, tris):
    if tris.dtype != torch.float32 or tris.dim() != 2 \
            or tris.shape[1] != TRI_W:
        raise ValueError(f"tris must be float32 (T, {TRI_W}), got "
                         f"{tris.dtype} {tuple(tris.shape)}")
    n = ray_o.x.shape[0]
    named = [("tris", tris), ("o.x", ray_o.x), ("o.y", ray_o.y),
             ("o.z", ray_o.z), ("d.x", ray_d.x), ("d.y", ray_d.y),
             ("d.z", ray_d.z)]
    for name, x in named:
        if x.device != tris.device:
            raise ValueError(f"{name} on {x.device}, tris on {tris.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "tris" and (x.dtype != torch.float32
                               or tuple(x.shape) != (n,)):
            raise ValueError(f"{name} must be float32 ({n},), got "
                             f"{x.dtype} {tuple(x.shape)}")


def intersect_tristream(ray_o: Vec3, ray_d: Vec3, tris):
    """Closest hit of N rays against the T-triangle stream ``tris``.

    ray_o, ray_d: Vec3 of (N,) float32.  Returns (t float32, tri_id int32,
    u float32, v float32), each (N,)."""
    _check(ray_o, ray_d, tris)
    if tris.device.type == "cpu":
        return intersect_tristream_plain(ray_o, ray_d, tris)
    if tris.device.type != "cuda":
        raise ValueError(f"no intersect_tristream for device {tris.device}")
    lib = cuda_lib.load()
    n = ray_o.x.shape[0]
    n_tris = tris.shape[0]
    dev = tris.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tid = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    # per ray the merged key of the splits' hits, set by the launch
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        splits = stream_splits(n, n_tris, lib.tristream_blocks())
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tristream_closest_launch(
            tris.data_ptr(), n_tris, n, ray_o.x.data_ptr(),
            ray_o.y.data_ptr(), ray_o.z.data_ptr(), ray_d.x.data_ptr(),
            ray_d.y.data_ptr(), ray_d.z.data_ptr(), keys.data_ptr(), splits,
            t.data_ptr(), tid.data_ptr(), u.data_ptr(), v.data_ptr(),
            stream)
    cuda_lib.check(rc, "tristream_closest")
    trace.launch("tristream_closest")
    return t, tid, u, v


def first_half(o: Vec3, d: Vec3, q):
    """The test up to the exact u test, as the kernel's ``first_half``:
    rays ``o``, ``d`` (Vec3 of (N, 1)) against triangle columns ``q``
    ((10, 1, C) rows [a.xyz, e1.xyz, e2.xyz, id]).  Returns tvec (tx, ty,
    tz), the reciprocal of det, u and ok: det outside +-TRI_EPS and u in
    [0, 1], each (N, C)."""
    px = d.y * q[8] - d.z * q[7]
    py = d.z * q[6] - d.x * q[8]
    pz = d.x * q[7] - d.y * q[6]
    det = q[3] * px + q[4] * py + q[5] * pz
    ok = (det <= -TRI_EPS) | (det >= TRI_EPS)
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tx, ty, tz = o.x - q[0], o.y - q[1], o.z - q[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0)
    return tx, ty, tz, inv_det, u, ok


def intersect_tristream_plain(ray_o: Vec3, ray_d: Vec3, tris):
    """Plain PyTorch version of the kernel.  Within a chunk of triangles the
    nearest valid hit and the first triangle reaching it win; a chunk's
    winner replaces the running best only when strictly nearer.  That is
    the kernel's triangle-by-triangle rule (``tt < best_t``) in chunks."""
    n = ray_o.x.shape[0]
    dev = tris.device
    best_t = torch.full((n,), BIG_T, dtype=torch.float32, device=dev)
    best_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    o = Vec3(ray_o.x[:, None], ray_o.y[:, None], ray_o.z[:, None])
    d = Vec3(ray_d.x[:, None], ray_d.y[:, None], ray_d.z[:, None])
    chunk = max(1, PLAIN_CHUNK_PAIRS // max(n, 1))
    rows = torch.arange(n, device=dev)
    for c0 in range(0, tris.shape[0], chunk):
        q = tris[c0:c0 + chunk].T[:, None, :]  # (10, 1, C)
        e1x, e1y, e1z = q[3], q[4], q[5]
        e2x, e2y, e2z = q[6], q[7], q[8]
        tid = q[9]
        tx, ty, tz, inv_det, u, ok = first_half(o, d, q)
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        w = (d.x * qx + d.y * qy + d.z * qz) * inv_det
        ok = ok & (w >= 0.0) & (u + w <= 1.0)
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = ok & (tt >= TRI_EPS) & (tid >= 0.0)
        tt = torch.where(ok, tt, float("inf"))
        m = tt.min(dim=1).values
        col = torch.arange(tt.shape[1], device=dev)
        first = torch.where(tt == m[:, None], col, tt.shape[1]).min(dim=1)
        j = first.values.clamp(max=tt.shape[1] - 1)
        win = m < best_t
        best_t = torch.where(win, m, best_t)
        best_id = torch.where(win, tid[0, j].to(torch.int32), best_id)
        best_u = torch.where(win, u[rows, j], best_u)
        best_v = torch.where(win, w[rows, j], best_v)
    return best_t, best_id, best_u, best_v
