"""The blue-noise sampler of the PyTorch port against the JAX package's:
the void-and-cluster shift masks (value-equal), the Owen-scrambled Sobol'
bits, the sampler's shifts and first-bounce bases, and every draw at
bounce 0 and deeper, bit-exact, on the same seeded pixels.

The masks are generated (or read from each package's disk cache) once per
module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buas_pathtracer_tpu.core import sampler as jsmp
from buas_pathtracer_tpu_torch.core import sampler as tsmp

BN = tsmp.Strategy.BLUE_NOISE
N = 2048


@pytest.fixture(scope="module")
def masks():
    return jsmp._bn_masks(), tsmp._bn_masks()


def _u32(seed, n=N):
    return np.random.RandomState(seed).randint(
        0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq_u32(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


def _eq_bits(j, t):
    j = np.asarray(j, np.float32)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.float32(t)
    np.testing.assert_array_equal(j.view(np.uint32),
                                  np.asarray(t, np.float32).view(np.uint32))


def test_masks_value_equal(masks):
    jm, tm = masks
    assert tm.shape == (tsmp.BN_TILE, tsmp.BN_TILE, tsmp.N_BN_CHANNELS)
    assert tm.dtype == np.float32
    np.testing.assert_array_equal(jm, tm)


@pytest.mark.parametrize("fn", ["_reverse_bits32", "_sobol_2d"])
def test_bit_functions_exact(fn):
    x = _u32(1)
    x[:4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    a = getattr(jsmp, fn)(jnp.asarray(x))
    b = getattr(tsmp, fn)(_t(x))
    for ja, tb in zip(a if isinstance(a, tuple) else (a,),
                      b if isinstance(b, tuple) else (b,)):
        _eq_u32(ja, tb)


@pytest.mark.parametrize("fn", ["_laine_karras_permutation",
                                "_nested_uniform_scramble"])
def test_owen_scramble_exact(fn):
    """The Laine-Karras multiplies wrap past int64's sign in the port's
    uint32-in-int64 form; every bit must survive."""
    x, seed = _u32(2), _u32(3)
    _eq_u32(getattr(jsmp, fn)(jnp.asarray(x), jnp.asarray(seed)),
            getattr(tsmp, fn)(_t(x), _t(seed)))


@pytest.mark.parametrize("dim", range(len(tsmp.SampleDimension)))
def test_sobol_points_exact(dim):
    """The shared base point (scalar sample index, Python-int math in the
    port) and the per-pixel hashed point."""
    for si in (0, 1, 7, 1000, 2 ** 31 + 5):
        ju, jv = jsmp._sobol_base_2d(jnp.uint32(si), dim)
        tu, tv_ = tsmp._sobol_base_2d(si, dim)
        _eq_bits(ju, tu)
        _eq_bits(jv, tv_)
    si, ph = _u32(4, 512), _u32(5, 512)
    ja = jsmp.sobol_owen_2d(jnp.asarray(si), jnp.asarray(ph), dim)
    ta = tsmp.sobol_owen_2d(_t(si), _t(ph), dim)
    _eq_bits(ja[0], ta[0])
    _eq_bits(ja[1], ta[1])


def _pixels(seed):
    r = np.random.RandomState(seed)
    return (r.randint(0, 1920, N).astype(np.uint32),
            r.randint(0, 1080, N).astype(np.uint32))


@pytest.mark.parametrize("sample_index", [0, 3, 77])
def test_make_sampler_equal(masks, sample_index):
    x, y = _pixels(6)
    js = jsmp.make_sampler(jnp.asarray(x), jnp.asarray(y),
                           jnp.uint32(sample_index), strategy=BN)
    ts = tsmp.make_sampler(_t(x), _t(y), sample_index, strategy=BN)
    assert tuple(ts.bn.shape) == (tsmp.N_BN_CHANNELS, N)
    assert tuple(ts.pre.shape) == tuple(js.pre.shape)
    _eq_bits(js.bn, ts.bn)
    _eq_bits(js.pre, ts.pre)
    _eq_u32(js.state, ts.state)


def _draw_all(smp, s, bounce):
    out = []
    for dim in smp.SampleDimension:
        s, u = smp.sample_1d(s, BN, dim, bounce)
        out.append(u)
        s, u, v = smp.sample_2d(s, BN, dim, bounce)
        out += [u, v]
    return s, out


@pytest.mark.parametrize("bounce", [0, 1, 3])
@pytest.mark.parametrize("per_ray", [False, True])
def test_draws_equal(masks, bounce, per_ray):
    """Every dimension's 1-D and 2-D draw: the precomputed bases (one
    sample index) or the per-lane path (a per-ray index), at bounce 0
    (low-discrepancy) and deeper (white noise)."""
    x, y = _pixels(7)
    if per_ray:
        si = _u32(8) % 4096
        js = jsmp.make_sampler(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(si), strategy=BN)
        ts = tsmp.make_sampler(_t(x), _t(y), _t(si), strategy=BN)
        assert ts.pre.shape[0] == 0
    else:
        js = jsmp.make_sampler(jnp.asarray(x), jnp.asarray(y), jnp.uint32(9),
                               strategy=BN)
        ts = tsmp.make_sampler(_t(x), _t(y), 9, strategy=BN)
    js, jo = _draw_all(jsmp, js, bounce)
    ts, to = _draw_all(tsmp, ts, bounce)
    for a, b in zip(jo, to):
        _eq_bits(a, b)
    _eq_u32(js.state, ts.state)


def test_sampler_without_shifts_falls_back(masks):
    """A blue-noise draw from a sampler built for another strategy takes
    the per-pixel hashed Owen-Sobol' point, as in the JAX package."""
    x, y = _pixels(10)
    si = _u32(11) % 64
    js = jsmp.make_sampler(jnp.asarray(x), jnp.asarray(y), jnp.asarray(si),
                           strategy=tsmp.Strategy.UNIFORM)
    ts = tsmp.make_sampler(_t(x), _t(y), _t(si),
                           strategy=tsmp.Strategy.UNIFORM)
    _, jo = _draw_all(jsmp, js, 0)
    _, to = _draw_all(tsmp, ts, 0)
    for a, b in zip(jo, to):
        _eq_bits(a, b)
