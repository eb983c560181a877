"""Per-(pixel, sample, dimension, bounce) decorrelated sample streams.

Counterpart of ``buas_pathtracer_tpu/core/sampler.py``, bit-exact for the
Uniform and Stratified strategies (samplers.cpp:18-138 contract): the first
bounce draws a permuted stratum plus jitter, deeper bounces draw white noise
from the per-ray xorshift chain.  The blue-noise strategy is not ported yet
(ROADMAP.md, queue 1) and raises.

uint32 values live in int64 tensors (core/rng.py).  ``sample_index`` may be
a Python int (one sample index per pass: the first-bounce bases are then
precomputed once in ``make_sampler``) or a per-ray tensor.
"""

from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple, Union

import numpy as np
import torch

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


class Sampler(NamedTuple):
    """Batched sampler state (one lane per ray).

    ``x``/``y`` pixel coordinates and ``state`` (the xorshift chain) are
    int64 tensors of uint32 values; ``sample_index`` is a Python int or a
    per-ray tensor; ``pre`` holds the (2*D, N) first-bounce stratum corners
    when ``sample_index`` is a Python int, else it is (0, N)."""

    x: torch.Tensor
    y: torch.Tensor
    sample_index: Union[int, torch.Tensor]
    state: torch.Tensor
    pre: torch.Tensor


def _blue_noise_unported():
    return NotImplementedError(
        "the blue-noise sampler is not ported yet (ROADMAP.md, queue 1)")


def make_sampler(x, y, sample_index, *, strategy: int,
                 frame_entropy: int = 0) -> Sampler:
    if strategy == Strategy.BLUE_NOISE:
        raise _blue_noise_unported()
    x = rng.u32(x)
    y = rng.u32(y)
    if isinstance(sample_index, torch.Tensor):
        sample_index = rng.u32(sample_index)
    else:
        sample_index = int(sample_index) & rng.M32
    seed = rng.hash_u32(rng.hash_coordinate_2d(x, y), sample_index,
                        int(frame_entropy) & rng.M32)
    pre = _first_bounce_bases(x, y, sample_index, strategy)
    return Sampler(x, y, sample_index, rng.seed_state(seed), pre)


def _first_bounce_bases(x, y, sample_index, strategy: int) -> torch.Tensor:
    """(2*D, N) stratum corners (qx/8, qy/8) for every dimension, or (0, N)
    for Uniform or a per-ray sample index."""
    if strategy != Strategy.STRATIFIED or isinstance(sample_index,
                                                      torch.Tensor):
        return torch.zeros((0,) + tuple(x.shape), dtype=torch.float32,
                           device=x.device)
    col = sample_index % STRATA_COUNT
    t_pass = torch.from_numpy(_MERGED_PERMS[:, col, :].copy()).to(x.device)
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
    perm = torch.from_numpy(_PERM_SETS.astype(np.int64)).to(s.x.device)
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


def sample_2d(s: Sampler, strategy: int, dim: int, bounce: int):
    """Returns (sampler, u, v).  Only bounce 0 is low-discrepancy."""
    state, ju, jv = rng.next_unilateral_2(s.state)
    s = s._replace(state=state)
    if strategy == Strategy.UNIFORM or bounce != 0:
        return s, ju, jv
    if strategy == Strategy.BLUE_NOISE:
        raise _blue_noise_unported()
    if s.pre.shape[0]:
        return (s, s.pre[2 * int(dim)] + ju * (1.0 / STRATA_X),
                s.pre[2 * int(dim) + 1] + jv * (1.0 / STRATA_Y))
    u0, v0 = _stratified_2d(s, dim, ju, jv)
    return s, u0, v0


def sample_1d(s: Sampler, strategy: int, dim: int, bounce: int):
    """Returns (sampler, u).  Only bounce 0 is low-discrepancy."""
    state, ju = rng.next_unilateral(s.state)
    s = s._replace(state=state)
    if strategy == Strategy.UNIFORM or bounce != 0:
        return s, ju
    if strategy == Strategy.BLUE_NOISE:
        raise _blue_noise_unported()
    if s.pre.shape[0]:
        # flat base si/64 == qx/64 + qy/8, rebuilt exactly from the corners
        return s, ((s.pre[2 * int(dim)] * (1.0 / STRATA_X)
                    + s.pre[2 * int(dim) + 1]) + ju * (1.0 / STRATA_COUNT))
    return s, _stratified_1d(s, dim, ju)
