"""The renderer's counter-/state-based uniform RNG, as the source defines
it (samplers.h:3-108: xorshift, wang hash, exponent trick).  PyTorch has
no uint32 add, multiply or shift on every device, so a uint32 value lives in
an int64 tensor (or a Python int) holding ``[0, 2**32)`` and every operation
masks back with ``& 0xFFFFFFFF``.  Products are split into 16-bit halves so
no intermediate leaves the int64 range.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def u32(x, device=None):
    """Python int / tensor -> int64 tensor of uint32 values."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return torch.as_tensor(int(x) & M32, dtype=torch.int64, device=device)


def mul32(a, b):
    """(a * b) mod 2**32 for uint32 values held in int64 (or Python ints).

    ``b`` is split into 16-bit halves so every partial product stays below
    2**48: no signed overflow anywhere."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _not(x):
    return x ^ M32


def wang_hash(key):
    """samplers.h:4-12."""
    key = (key + _not((key << 15) & M32)) & M32
    key = key ^ (key >> 10)
    key = (key + ((key << 3) & M32)) & M32
    key = key ^ (key >> 6)
    key = (key + _not((key << 11) & M32)) & M32
    key = key ^ (key >> 16)
    return key


def hash_coordinate_2d(x, y):
    """samplers.h:20-27 (shadertoy 4tXyWN recipe)."""
    m = 1103515245
    qx = mul32(((x >> 1) ^ y), m)
    qy = mul32(((y >> 1) ^ x), m)
    return mul32(qx ^ (qy >> 3), m)


def hash_coordinate_3d(x, y, z):
    """samplers.h:14-18."""
    return (mul32(x, 73856093) ^ mul32(y, 83492791) ^ mul32(z, 871603259))


def xorshift32(state):
    """One xorshift step (13, 17, 5): the per-lane core of samplers.h:36-45."""
    state = state ^ ((state << 13) & M32)
    state = state ^ (state >> 17)
    state = state ^ ((state << 5) & M32)
    return state


def bits_to_unilateral(bits):
    """uint32 -> [0, 1) float32 via the exponent trick (samplers.h:68-76).

    The or'd pattern is below 2**31, so it fits int32 and bit-casts exactly."""
    pat = (127 << 23) | (bits >> 9)
    return pat.to(torch.int32).view(torch.float32) - 1.0


def seed_state(seed):
    """Well-mixed per-lane state from a uint32 seed (samplers.h:94-108
    intent); 0 is remapped because it is xorshift's fixed point."""
    s = wang_hash(seed)
    s = torch.where(s == 0, 0x9E3779B9, s)
    s = xorshift32(xorshift32(s))
    s = wang_hash(s)
    return torch.where(s == 0, 0x85EBCA6B, s)


def next_unilateral(state):
    """Advance the state; return (new_state, uniform in [0, 1))."""
    state = xorshift32(state)
    return state, bits_to_unilateral(state)


def next_unilateral_2(state):
    state, a = next_unilateral(state)
    state, b = next_unilateral(state)
    return state, a, b


def next_bilateral(state):
    state, u = next_unilateral(state)
    return state, 2.0 * u - 1.0


def hash_u32(*keys):
    """Combine uint32 keys into one well-mixed uint32 (samplers.h:129-150
    decorrelated-stream contract, stateless)."""
    acc = 0x9E3779B9
    for k in keys:
        mix = (k + 0x9E3779B9 + ((acc << 6) & M32) + (acc >> 2)) & M32
        acc = wang_hash(acc ^ mix)
    return acc


def uniform_from_keys(*keys):
    """Stateless uniform [0, 1) from integer keys."""
    return bits_to_unilateral(hash_u32(*keys))
