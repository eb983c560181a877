"""Core math of the PyTorch port against the JAX package: the RNG and the
Uniform / Stratified samplers are bit-exact; vector helpers agree to float
rounding.  Inputs are made with numpy from a seed and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buas_pathtracer_tpu.core import rng as jrng
from buas_pathtracer_tpu.core import sampler as jsmp
from buas_pathtracer_tpu.core import vec as jvec
from buas_pathtracer_tpu_torch.core import rng as trng
from buas_pathtracer_tpu_torch.core import sampler as tsmp
from buas_pathtracer_tpu_torch.core import vec as tvec

SEED = 20261016


def _u32(n=4096, seed=SEED):
    r = np.random.default_rng(seed)
    x = r.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]  # edge values
    return x


def _j(x):
    return jnp.asarray(x, jnp.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))


def _eq_u32(j, t):
    np.testing.assert_array_equal(np.asarray(j, np.uint32),
                                  t.numpy().astype(np.uint32))


def _eq_f32_bits(j, t):
    np.testing.assert_array_equal(np.asarray(j, np.float32).view(np.uint32),
                                  t.numpy().astype(np.float32).view(np.uint32))


@pytest.mark.parametrize("name", ["wang_hash", "xorshift32", "seed_state"])
def test_rng_unary_bit_exact(name):
    x = _u32()
    _eq_u32(getattr(jrng, name)(_j(x)), getattr(trng, name)(_t(x)))


def test_hash_coordinates_bit_exact():
    x, y, z = _u32(seed=1), _u32(seed=2), _u32(seed=3)
    _eq_u32(jrng.hash_coordinate_2d(_j(x), _j(y)),
            trng.hash_coordinate_2d(_t(x), _t(y)))
    _eq_u32(jrng.hash_coordinate_3d(_j(x), _j(y), _j(z)),
            trng.hash_coordinate_3d(_t(x), _t(y), _t(z)))


def test_hash_u32_and_uniform_bit_exact():
    a, b = _u32(seed=4), _u32(seed=5)
    _eq_u32(jrng.hash_u32(_j(a), _j(b), jnp.uint32(77)),
            trng.hash_u32(_t(a), _t(b), 77))
    _eq_f32_bits(jrng.uniform_from_keys(_j(a), _j(b)),
                 trng.uniform_from_keys(_t(a), _t(b)))


def test_bits_to_unilateral_bit_exact():
    x = _u32(seed=6)
    j, t = jrng.bits_to_unilateral(_j(x)), trng.bits_to_unilateral(_t(x))
    _eq_f32_bits(j, t)
    assert t.dtype == torch.float32
    assert float(t.min()) >= 0.0 and float(t.max()) < 1.0


def test_next_unilateral_chain_bit_exact():
    sj, st = _j(_u32(seed=8) | 1), _t(_u32(seed=8) | 1)
    for _ in range(5):
        sj, uj = jrng.next_unilateral(sj)
        st, ut = trng.next_unilateral(st)
        _eq_u32(sj, st)
        _eq_f32_bits(uj, ut)


# 64x64 pixel grid, the draws of one path: first bounce then a deeper one
_DRAWS = [
    ("2d", jsmp.SampleDimension.AA, 0),
    ("2d", jsmp.SampleDimension.DOF, 0),
    ("1d", jsmp.SampleDimension.REFLECTANCE, 0),
    ("1d", jsmp.SampleDimension.LIGHT_SELECTION, 0),
    ("2d", jsmp.SampleDimension.DIRECT_LIGHTING, 0),
    ("2d", jsmp.SampleDimension.INDIRECT_LIGHTING, 0),
    ("1d", jsmp.SampleDimension.ROULETTE, 0),
    ("1d", jsmp.SampleDimension.REFLECTANCE, 1),
    ("2d", jsmp.SampleDimension.DIRECT_LIGHTING, 1),
    ("2d", jsmp.SampleDimension.INDIRECT_LIGHTING, 1),
    ("1d", jsmp.SampleDimension.ROULETTE, 1),
]


def _draw_all(mod, s, strategy):
    outs = []
    for kind, dim, bounce in _DRAWS:
        if kind == "1d":
            s, u = mod.sample_1d(s, strategy, int(dim), bounce)
            outs.append(u)
        else:
            s, u, v = mod.sample_2d(s, strategy, int(dim), bounce)
            outs += [u, v]
    return s, outs


@pytest.mark.parametrize("sample_index", [0, 1, 63, 64])
@pytest.mark.parametrize("strategy", ["UNIFORM", "STRATIFIED"])
@pytest.mark.parametrize("per_ray", [False, True],
                         ids=["pass_index", "per_ray_index"])
def test_sampler_bit_exact(strategy, sample_index, per_ray):
    ys, xs = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    x = xs.reshape(-1).astype(np.uint32)
    y = ys.reshape(-1).astype(np.uint32)
    st = int(getattr(jsmp.Strategy, strategy))
    if per_ray:  # a per-ray index takes the table path, not the precompute
        si = np.full(x.shape, sample_index, np.uint32)
        j_si, t_si = _j(si), _t(si)
    else:
        j_si, t_si = jnp.uint32(sample_index), sample_index
    js = jsmp.make_sampler(_j(x), _j(y), j_si, strategy=st)
    ts = tsmp.make_sampler(_t(x), _t(y), t_si, strategy=st)
    assert ts.pre.shape[0] == js.pre.shape[0]
    _eq_u32(js.state, ts.state)
    js, jo = _draw_all(jsmp, js, st)
    ts, to = _draw_all(tsmp, ts, st)
    for a, b in zip(jo, to):
        _eq_f32_bits(a, b)
    _eq_u32(js.state, ts.state)


def test_blue_noise_not_ported():
    """The blue-noise strategy, once refused, is ported: its sampler holds
    the JAX package's shifts and bases (tests/test_torch_sampler_bn.py has
    the full comparison)."""
    x = torch.arange(4, dtype=torch.int64)
    ts = tsmp.make_sampler(x, x, 0, strategy=tsmp.Strategy.BLUE_NOISE)
    js = jsmp.make_sampler(_j(x.numpy()), _j(x.numpy()), jnp.uint32(0),
                           strategy=jsmp.Strategy.BLUE_NOISE)
    _eq_f32_bits(js.bn, ts.bn)
    _eq_f32_bits(js.pre, ts.pre)


def test_permutation_tables_equal():
    np.testing.assert_array_equal(tsmp._PERM_SETS, jsmp._PERM_SETS)
    np.testing.assert_array_equal(tsmp._MERGED_PERMS, jsmp._MERGED_PERMS)


def _vecs(seed, n=512):
    a = np.random.default_rng(seed).normal(size=(3, n)).astype(np.float32)
    a[:, :3] = 0.0  # degenerate lanes for noz
    return a


@pytest.mark.parametrize("fn", ["noz", "normalize_nonzero", "cross", "reflect",
                                "tangents"])
def test_vec_ops_agree(fn):
    a, b = _vecs(11), _vecs(12)
    ja, jb = jvec.Vec3(*map(jnp.asarray, a)), jvec.Vec3(*map(jnp.asarray, b))
    ta = tvec.Vec3(*map(torch.from_numpy, a))
    tb = tvec.Vec3(*map(torch.from_numpy, b))
    if fn == "noz":
        j, t = jvec.noz(ja), tvec.noz(ta)
    elif fn == "normalize_nonzero":
        j = jvec.normalize(jvec.Vec3(*(c[3:] for c in ja)))
        t = tvec.normalize(tvec.Vec3(*(c[3:] for c in ta)))
    elif fn == "cross":
        j, t = jvec.cross(ja, jb), tvec.cross(ta, tb)
    elif fn == "reflect":
        j, t = jvec.reflect(ja, jvec.noz(jb)), tvec.reflect(ta, tvec.noz(tb))
    else:
        j = jvec.oriented_around_normal(ja, jvec.noz(jb))
        t = tvec.oriented_around_normal(ta, tvec.noz(tb))
    for cj, ct in zip(j, t):
        np.testing.assert_allclose(np.asarray(cj), np.asarray(ct),
                                   rtol=1e-6, atol=1e-6)
