"""The stratified sampler (samplers.cpp:18-138), one sample index a ray.

The first bounce draws a permuted stratum of an 8 x 8 grid plus a jitter
inside it; deeper bounces draw white noise from the ray's xorshift chain.
The stratum permutations are 256 permutations of 0..63 from the seeded
stream ``RandomState(0x5EED5)``; the row a pixel reads for a dimension is
keyed by a hash of the pixel and the dimension, the column by the sample
index.  uint32 values live in int64 tensors (``rng``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rng

# sample dimensions (samplers.h:129-138)
DIRECT_LIGHTING = 0
INDIRECT_LIGHTING = 1
LIGHT_SELECTION = 2
REFLECTANCE = 3
DOF = 4
AA = 5
ROULETTE = 6
ENV_LIGHTING = 7  # the environment map's next-event estimation

STRATA = 8
STRATA_COUNT = STRATA * STRATA


def _permutations() -> np.ndarray:
    r = np.random.RandomState(0x5EED5)
    return np.stack([r.permutation(STRATA_COUNT) for _ in range(256)]
                    ).astype(np.int64)


_PERMS = _permutations()  # (256, 64)


class Sampler(NamedTuple):
    x: torch.Tensor  # pixel coordinates, uint32 in int64
    y: torch.Tensor
    sample_index: torch.Tensor  # one a ray, uint32 in int64
    state: torch.Tensor  # the xorshift chain
    perms: torch.Tensor  # (256, 64) on the rays' device


def make_sampler(x, y, sample_index) -> Sampler:
    x, y = rng.u32(x), rng.u32(y)
    si = rng.u32(sample_index)
    seed = rng.hash_u32(rng.hash_coordinate_2d(x, y), si, 0)
    return Sampler(x, y, si, rng.seed_state(seed),
                   torch.from_numpy(_PERMS).to(x.device))


def _stratum(s: Sampler, dim: int):
    row = ((73856093 * int(dim)) ^ rng.hash_coordinate_2d(s.x, s.y)) & 255
    return s.perms[row, s.sample_index % STRATA_COUNT]


def sample_2d(s: Sampler, dim: int, bounce: int):
    state, ju, jv = rng.next_unilateral_2(s.state)
    s = s._replace(state=state)
    if bounce != 0:
        return s, ju, jv
    si = _stratum(s, dim)
    return (s, (si % STRATA).to(torch.float32) * (1.0 / STRATA)
            + ju * (1.0 / STRATA),
            (si // STRATA).to(torch.float32) * (1.0 / STRATA)
            + jv * (1.0 / STRATA))


def sample_1d(s: Sampler, dim: int, bounce: int):
    state, ju = rng.next_unilateral(s.state)
    s = s._replace(state=state)
    if bounce != 0:
        return s, ju
    si = _stratum(s, dim).to(torch.float32)
    return s, si * (1.0 / STRATA_COUNT) + ju * (1.0 / STRATA_COUNT)
