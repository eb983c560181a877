"""Per-(pixel, sample, dimension, bounce) decorrelated sample streams.

Counterpart of ``buas_pathtracer_tpu/core/sampler.py``, bit-exact for all
three strategies (samplers.cpp:18-138 contract): the first bounce draws a
low-discrepancy value, deeper bounces white noise from the per-ray xorshift
chain.  Stratified draws a permuted stratum plus jitter; blue noise rotates
one shared Owen-scrambled Sobol' sequence (Burley 2020 hash scrambling) by
per-pixel void-and-cluster shifts (Georgiev & Fajardo 2016), one mask
channel per sample dimension, gathered once per pass in ``make_sampler``.

uint32 values live in int64 tensors (core/rng.py), or in Python ints for
the scalar Sobol' base point; every product and shift masks back to 32
bits before the next right shift.  ``sample_index`` may be
a Python int (one sample index per pass: the first-bounce bases are then
precomputed once in ``make_sampler``) or a per-ray tensor.
"""

from __future__ import annotations

from enum import IntEnum
import hashlib
import os
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..utils import trace
from . import rng


class SampleDimension(IntEnum):  # samplers.h:129-138
    DIRECT_LIGHTING = 0
    INDIRECT_LIGHTING = 1
    LIGHT_SELECTION = 2
    REFLECTANCE = 3
    DOF = 4
    AA = 5
    ROULETTE = 6
    ENV_LIGHTING = 7


class Strategy(IntEnum):  # samplers.h:110-115
    UNIFORM = 0
    BLUE_NOISE = 1
    STRATIFIED = 2


STRATA_X = 8
STRATA_Y = 8
STRATA_COUNT = STRATA_X * STRATA_Y


def _make_permutation_sets() -> np.ndarray:
    """256 seeded permutations of 0..63 (the JAX package's own data)."""
    r = np.random.RandomState(0x5EED5)
    perms = np.stack([r.permutation(STRATA_COUNT) for _ in range(256)])
    return perms.astype(np.uint8)


_PERM_SETS = _make_permutation_sets()  # (256, 64) uint8

# One (256, 64, D) table serves every dimension: the row a pixel reads for
# dimension d is (73856093*d ^ pixel_hash) & 255 == K_d ^ (pixel_hash & 255).
_N_DIMS = len(SampleDimension)
_DIM_ROW_KEYS = [(73856093 * d) & 255 for d in range(_N_DIMS)]
_MERGED_PERMS = np.stack(
    [_PERM_SETS[np.arange(256) ^ k] for k in _DIM_ROW_KEYS],
    axis=-1).astype(np.float32)  # (256, 64, D)


# ---------------------------------------------------------------------------
# Hash-based Owen-scrambled Sobol' (Burley 2020)
# ---------------------------------------------------------------------------

def _reverse_bits32(x):
    x = ((x >> 16) | ((x << 16) & rng.M32))
    x = (((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8))
    x = (((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4))
    x = (((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2))
    return (((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1))


def _laine_karras_permutation(x, seed):
    x = (x + seed) & rng.M32
    x = x ^ rng.mul32(x, 0x6C50B47C)
    x = x ^ rng.mul32(x, 0xB82F1E52)
    x = x ^ rng.mul32(x, 0xC7AFE638)
    return x ^ rng.mul32(x, 0x8D22F6E6)


def _nested_uniform_scramble(x, seed):
    """Owen scramble of a radical-inverse value (bits reversed in/out)."""
    return _reverse_bits32(_laine_karras_permutation(_reverse_bits32(x), seed))


def _sobol_dim1_directions():
    """Direction numbers of the second Sobol' dimension (primitive
    polynomial x+1): v[0] = 1<<31, v[i] = v[i-1] ^ (v[i-1] >> 1)."""
    v = [1 << 31]
    for _ in range(1, 32):
        v.append(v[-1] ^ (v[-1] >> 1))
    return v


_SOBOL_V1 = _sobol_dim1_directions()


def _sobol_2d(index):
    """(x, y) uint32 Sobol' points: dim 0 van der Corput, dim 1 poly x+1."""
    x = _reverse_bits32(index)
    y = index * 0
    for i in range(32):
        y = y ^ (((index >> i) & 1) * _SOBOL_V1[i])
    return x, y


def _u32_to_unit_float(x):
    """Top 24 bits -> [0, 1) (exact in float32)."""
    if isinstance(x, torch.Tensor):
        return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return float(x >> 8) * (1.0 / (1 << 24))


def _dim_key(dimension: int) -> int:
    return (0x9E3779B9 * (2 * dimension + 1)) & rng.M32


def _owen_point(sample_index, seed):
    shuffled = _nested_uniform_scramble(sample_index,
                                        rng.hash_u32(seed, 0xA511E9B3))
    sx, sy = _sobol_2d(shuffled)
    sx = _nested_uniform_scramble(sx, rng.hash_u32(seed, 0x63D83595))
    sy = _nested_uniform_scramble(sy, rng.hash_u32(seed, 0x9C8FB2A7))
    return _u32_to_unit_float(sx), _u32_to_unit_float(sy)


def sobol_owen_2d(sample_index, pixel_hash, dimension: int):
    """Owen-scrambled, Owen-shuffled 2-D Sobol' point for a pixel/dim pair."""
    return _owen_point(sample_index,
                       rng.hash_u32(pixel_hash, _dim_key(dimension)))


def _sobol_base_2d(sample_index, dimension: int):
    """The shared (pixel-independent) Owen-Sobol' point of a dimension, the
    sequence that the per-pixel blue-noise shifts rotate.  A Python int
    sample index gives Python floats (exact float32 values)."""
    return _owen_point(sample_index, _dim_key(dimension))


# ---------------------------------------------------------------------------
# Blue-noise shift masks (Georgiev & Fajardo 2016 toroidal dithering)
# ---------------------------------------------------------------------------

BN_TILE = 64
N_BN_CHANNELS = 2 * len(SampleDimension)  # (u, v) per sample dimension

_bn_masks_cache: Optional[np.ndarray] = None


def _bn_cache_paths():
    """Disk cache beside this module: void-and-cluster takes ~8 s a
    process, so it runs once per checkout."""
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"_bn_masks_{BN_TILE}x{N_BN_CHANNELS}.npy")
    return base, base + ".fp"


def _bn_fingerprint() -> str:
    """The generator's source and parameters: a cache built by another
    construction is never loaded."""
    from ..utils import bluenoise
    h = hashlib.sha256()
    with open(bluenoise.__file__, "rb") as f:
        h.update(f.read())
    h.update(f"{BN_TILE}|{N_BN_CHANNELS}|0xB1E|7919".encode())
    return h.hexdigest()


def _bn_masks() -> np.ndarray:
    """(BN_TILE, BN_TILE, N_BN_CHANNELS) float32 shifts in [0, 1): one
    void-and-cluster threshold matrix per (dimension, axis), value-equal to
    the JAX package's.  Generated once per checkout (disk cache) and once
    per process (memory cache)."""
    global _bn_masks_cache
    if _bn_masks_cache is not None:
        return _bn_masks_cache
    path, fp_path = _bn_cache_paths()
    fp = _bn_fingerprint()
    if os.path.exists(path) and os.path.exists(fp_path):
        try:
            with open(fp_path) as f:
                if f.read().strip() == fp:
                    m = np.load(path)
                    if m.shape == (BN_TILE, BN_TILE, N_BN_CHANNELS):
                        _bn_masks_cache = np.ascontiguousarray(
                            m.astype(np.float32))
                        return _bn_masks_cache
        except (OSError, ValueError):
            pass
    from ..utils.bluenoise import void_and_cluster
    _bn_masks_cache = np.stack(
        [void_and_cluster(BN_TILE, seed=0xB1E + 7919 * k).astype(np.float32)
         / (BN_TILE * BN_TILE) for k in range(N_BN_CHANNELS)], axis=-1)
    try:
        # each file replaced whole, the mask first: a process that finds
        # the fingerprint finds a complete mask
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.save(f, _bn_masks_cache)
        os.replace(tmp, path)
        with open(tmp, "w") as f:
            f.write(fp)
        os.replace(tmp, fp_path)
    except OSError:
        pass  # read-only checkout: regenerate per process
    return _bn_masks_cache


# ---------------------------------------------------------------------------
# Sampler context
# ---------------------------------------------------------------------------

class Sampler(NamedTuple):
    """Batched sampler state (one lane per ray).

    ``x``/``y`` pixel coordinates and ``state`` (the xorshift chain) are
    int64 tensors of uint32 values; ``sample_index`` is a Python int or a
    per-ray tensor; ``bn`` the (N_BN_CHANNELS, N) per-pixel blue-noise
    shifts for BLUE_NOISE, else (0, N); ``pre`` holds the (2*D, N)
    first-bounce bases (stratum corners, or the rotated Sobol' values) when
    ``sample_index`` is a Python int, else it is (0, N)."""

    x: torch.Tensor
    y: torch.Tensor
    sample_index: Union[int, torch.Tensor]
    state: torch.Tensor
    bn: torch.Tensor
    pre: torch.Tensor


def make_sampler(x, y, sample_index, *, strategy: int,
                 frame_entropy: int = 0) -> Sampler:
    x = rng.u32(x)
    y = rng.u32(y)
    if isinstance(sample_index, torch.Tensor):
        sample_index = rng.u32(sample_index)
    else:
        sample_index = int(sample_index) & rng.M32
    seed = rng.hash_u32(rng.hash_coordinate_2d(x, y), sample_index,
                        int(frame_entropy) & rng.M32)
    if strategy == Strategy.BLUE_NOISE:
        masks = trace.wait("sampler_tables", torch.from_numpy(
            _bn_masks()).to, x.device)  # (T, T, K)
        bn = masks[y & (BN_TILE - 1), x & (BN_TILE - 1)].T.contiguous()
    else:
        bn = torch.zeros((0,) + tuple(x.shape), dtype=torch.float32,
                         device=x.device)
    pre = _first_bounce_bases(x, y, sample_index, strategy, bn)
    return Sampler(x, y, sample_index, rng.seed_state(seed), bn, pre)


def _first_bounce_bases(x, y, sample_index, strategy: int,
                        bn) -> torch.Tensor:
    """(2*D, N) first-bounce bases for every dimension, or (0, N) for
    Uniform or a per-ray sample index.  Stratified: the stratum corners
    (qx/8, qy/8); blue noise: the shared Sobol' point (scalar math) rotated
    by the pixel's shifts."""
    if (strategy not in (Strategy.STRATIFIED, Strategy.BLUE_NOISE)
            or isinstance(sample_index, torch.Tensor)):
        return torch.zeros((0,) + tuple(x.shape), dtype=torch.float32,
                           device=x.device)
    if strategy == Strategy.BLUE_NOISE:
        rows = []
        for d in range(_N_DIMS):
            bu, bv = _sobol_base_2d(sample_index, d)
            rows.append(torch.remainder(bu + bn[2 * d], 1.0))
            rows.append(torch.remainder(bv + bn[2 * d + 1], 1.0))
        return torch.stack(rows)
    col = sample_index % STRATA_COUNT
    t_pass = trace.wait("sampler_tables", torch.from_numpy(
        _MERGED_PERMS[:, col, :].copy()).to, x.device)
    r = rng.hash_coordinate_2d(x, y) & 255
    g = t_pass[r]  # (N, D) exact small-int float values
    rows = []
    for d in range(_N_DIMS):
        si = g[:, d]
        rows.append(torch.remainder(si, float(STRATA_X)) * (1.0 / STRATA_X))
        rows.append(torch.floor(si * (1.0 / STRATA_X)) * (1.0 / STRATA_Y))
    return torch.stack(rows)


def _stratum_index(s: Sampler, dim: int):
    index_offset = (73856093 * int(dim)) ^ rng.hash_coordinate_2d(s.x, s.y)
    row = index_offset & 255
    col = s.sample_index % STRATA_COUNT
    perm = trace.wait("sampler_tables", torch.from_numpy(
        _PERM_SETS.astype(np.int64)).to, s.x.device)
    return perm[row, col]


def _stratified_2d(s: Sampler, dim: int, u_jit, v_jit):
    """samplers.cpp:48-80: permuted stratum + jitter inside it."""
    si = _stratum_index(s, dim)
    strata_x = (si % STRATA_X).to(torch.float32) * (1.0 / STRATA_X)
    strata_y = (si // STRATA_X).to(torch.float32) * (1.0 / STRATA_Y)
    return (strata_x + u_jit * (1.0 / STRATA_X),
            strata_y + v_jit * (1.0 / STRATA_Y))


def _stratified_1d(s: Sampler, dim: int, u_jit):
    """samplers.cpp:119-135: 1-D uses the flat 64-stratum index."""
    si = _stratum_index(s, dim).to(torch.float32)
    return si * (1.0 / STRATA_COUNT) + u_jit * (1.0 / STRATA_COUNT)


def _blue_noise_2d(s: Sampler, dim: int):
    """Cranley-Patterson rotation of the shared sequence by the pixel's
    shift; per-pixel hashed Owen-Sobol' for a sampler built without shifts
    or a dimension beyond the mask channels."""
    if 2 * dim + 1 < s.bn.shape[0]:
        bu, bv = _sobol_base_2d(s.sample_index, dim)
        return (torch.remainder(bu + s.bn[2 * dim], 1.0),
                torch.remainder(bv + s.bn[2 * dim + 1], 1.0))
    return sobol_owen_2d(s.sample_index, rng.hash_coordinate_2d(s.x, s.y),
                         dim)


def sample_2d(s: Sampler, strategy: int, dim: int, bounce: int):
    """Returns (sampler, u, v).  Only bounce 0 is low-discrepancy."""
    state, ju, jv = rng.next_unilateral_2(s.state)
    s = s._replace(state=state)
    if strategy == Strategy.UNIFORM or bounce != 0:
        return s, ju, jv
    if s.pre.shape[0]:
        if strategy == Strategy.BLUE_NOISE:
            return s, s.pre[2 * int(dim)], s.pre[2 * int(dim) + 1]
        return (s, s.pre[2 * int(dim)] + ju * (1.0 / STRATA_X),
                s.pre[2 * int(dim) + 1] + jv * (1.0 / STRATA_Y))
    if strategy == Strategy.BLUE_NOISE:
        u0, v0 = _blue_noise_2d(s, int(dim))
        return s, u0, v0
    u0, v0 = _stratified_2d(s, dim, ju, jv)
    return s, u0, v0


def sample_1d(s: Sampler, strategy: int, dim: int, bounce: int):
    """Returns (sampler, u).  Only bounce 0 is low-discrepancy."""
    state, ju = rng.next_unilateral(s.state)
    s = s._replace(state=state)
    if strategy == Strategy.UNIFORM or bounce != 0:
        return s, ju
    if s.pre.shape[0] and strategy == Strategy.BLUE_NOISE:
        return s, s.pre[2 * int(dim)]
    if strategy == Strategy.BLUE_NOISE:
        return s, _blue_noise_2d(s, int(dim))[0]
    if s.pre.shape[0]:
        # flat base si/64 == qx/64 + qy/8, rebuilt exactly from the corners
        return s, ((s.pre[2 * int(dim)] * (1.0 / STRATA_X)
                    + s.pre[2 * int(dim) + 1]) + ju * (1.0 / STRATA_COUNT))
    return s, _stratified_1d(s, dim, ju)
