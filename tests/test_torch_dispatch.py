"""Wave ordering of the PyTorch port against the JAX package: the three
compact-key layouts, the stage sort key, the root prefilter and the block
coherence on the same seeded rays, and the port's key-sorted route against
its natural route on the unified and the split tables.

Keys and the prefilter mask are held bit-exact (int32 values equal), the
coherence to rtol 1e-6, the routes to equal outputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buas_pathtracer_tpu.core import vec as jvec
from buas_pathtracer_tpu.integrators import advanced as jadv
from buas_pathtracer_tpu.models import camera as jcm
from buas_pathtracer_tpu.models.scene import Scene as JScene
from buas_pathtracer_tpu.ops import pallas_packet as jpp
from buas_pathtracer_tpu.utils.procgen import icosphere as jico
from buas_pathtracer_tpu_torch.core import vec as tvec
from buas_pathtracer_tpu_torch.integrators import advanced as tadv
from buas_pathtracer_tpu_torch.models import camera as tcm
from buas_pathtracer_tpu_torch.models.scene import Scene as TScene
from buas_pathtracer_tpu_torch.ops import dispatch
from buas_pathtracer_tpu_torch.utils.procgen import icosphere as tico
from test_torch_scene import scene_packet

J = (JScene, jvec, jcm, jico)
T = (TScene, tvec, tcm, tico)
N = 4096


@pytest.fixture(scope="module")
def packed():
    return scene_packet(*J).pack(), scene_packet(*T).pack(device="cpu")


def _rays(seed, lo, hi, spread=0.3):
    """Origins over the scene box (widened by ``spread``), unit directions,
    a few exact zeros and axis-aligned directions, 30% dead lanes."""
    r = np.random.RandomState(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    ext = hi - lo
    o = (lo - spread * ext + (1 + 2 * spread) * ext
         * r.rand(N, 3)).astype(np.float32)
    d = r.randn(N, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:16] = np.eye(3, dtype=np.float32)[np.arange(16) % 3]
    d[16:24, 1] = 0.0
    d = d.astype(np.float32)
    t0 = np.where(r.rand(N) < 0.3, -1.0, 3.0e38).astype(np.float32)
    ign = r.randint(-1, 5, N).astype(np.int32)
    return o, d, t0, ign


def _jv(a):
    return jvec.Vec3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _tv(a):
    return tvec.Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                       for k in range(3)))


def _bounds(jps):
    return np.asarray(jps.scene_lo), np.asarray(jps.scene_hi)


@pytest.mark.parametrize("seed", [0, 1])
def test_morton_key_bit_exact(packed, seed):
    jps, tps = packed
    lo, hi = _bounds(jps)
    o, d, _, _ = _rays(seed, lo, hi)
    a = np.asarray(jpp._morton_key(_jv(o), _jv(d), jps.scene_lo,
                                   jps.scene_hi))
    b = dispatch._morton_key(_tv(o), _tv(d), tps.scene_lo, tps.scene_hi)
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_key6d_bit_exact(packed, seed):
    jps, tps = packed
    lo, hi = _bounds(jps)
    o, d, _, _ = _rays(seed, lo, hi)
    a = np.asarray(jpp._key6d(_jv(o), _jv(d), jps.scene_lo, jps.scene_hi))
    b = dispatch._key6d(_tv(o), _tv(d), tps.scene_lo, tps.scene_hi)
    np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("layout", [None, "m6d", "oct_major", "morton"])
@pytest.mark.parametrize("occlusion", [False, True])
def test_compact_key_layouts_bit_exact(packed, monkeypatch, layout,
                                       occlusion):
    """All three BUAS_COMPACT_KEY layouts, and each wave type's default."""
    if layout is None:
        monkeypatch.delenv("BUAS_COMPACT_KEY", raising=False)
    else:
        monkeypatch.setenv("BUAS_COMPACT_KEY", layout)
    jps, tps = packed
    lo, hi = _bounds(jps)
    o, d, _, ign = _rays(2, lo, hi)
    a = np.asarray(jpp._compact_key(_jv(o), _jv(d), jnp.asarray(ign),
                                    jps.scene_lo, jps.scene_hi,
                                    occlusion=occlusion))
    b = dispatch._compact_key(_tv(o), _tv(d), torch.from_numpy(ign),
                              tps.scene_lo, tps.scene_hi, occlusion=occlusion)
    assert b.dtype == torch.int32
    np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("seed", [3, 4])
def test_root_prefilter_equal(packed, seed):
    jps, tps = packed
    lo, hi = _bounds(jps)
    o, d, t0, _ = _rays(seed, lo, hi, spread=1.0)
    a = np.asarray(jpp.root_prefilter(jps.wide_rows, _jv(o), _jv(d),
                                      jnp.asarray(t0)))
    b = dispatch.root_prefilter(tps.wide_rows, _tv(o), _tv(d),
                                torch.from_numpy(t0))
    np.testing.assert_array_equal(a, b.numpy())
    assert 0 < a.sum() < N  # both outcomes occur


def test_stage_sort_key_bit_exact(packed):
    """The staged loop's sort key and prefilter mask (the scene has no
    plane, so the port's plane term adds nothing)."""
    jps, tps = packed
    lo, hi = _bounds(jps)
    o, d, t0, _ = _rays(5, lo, hi, spread=1.0)
    alive = t0 >= 0
    ka, la = jadv._stage_sort_key(jps, _jv(o), _jv(d), jnp.asarray(alive))
    kb, lb = tadv._stage_sort_key(tps, _tv(o), _tv(d),
                                  torch.from_numpy(alive))
    np.testing.assert_array_equal(np.asarray(ka), kb.numpy())
    np.testing.assert_array_equal(np.asarray(la), lb.numpy())
    np.testing.assert_array_equal(
        np.argsort(np.asarray(ka), kind="stable"),
        torch.argsort(kb, stable=True).numpy())


@pytest.mark.parametrize("seed", [6, 7])
def test_block_coherence_close(packed, seed):
    jps, _ = packed
    lo, hi = _bounds(jps)
    _, d, t0, _ = _rays(seed, lo, hi)
    n = N + 300  # a partial tail block is ignored
    d = np.concatenate([d, d[:300]])
    t0 = np.concatenate([t0, t0[:300]])
    d[:1024] = d[0]  # one coherent block
    a = float(jpp.block_coherence(_jv(d), jnp.asarray(t0)))
    b = float(dispatch.block_coherence(_tv(d), torch.from_numpy(t0)))
    assert d.shape[0] == n
    np.testing.assert_allclose(b, a, rtol=1e-6)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("occlusion", [False, True])
def test_sorted_route_gives_natural_hits(packed, occlusion, split):
    """The key-sorted route (prefilter, sort, gather, walk, gather back)
    returns the natural route's outputs for every ray, on the unified and
    on the split tables."""
    tps = scene_packet(*T).pack(device="cpu", split=True) if split \
        else packed[1]
    assert (tps.v4_res is not None) == split
    lo, hi = tps.scene_lo.numpy(), tps.scene_hi.numpy()
    o, d, t0, ign = _rays(8, lo, hi, spread=0.5)
    args = (tps, _tv(o), _tv(d), torch.from_numpy(t0),
            torch.from_numpy(ign), occlusion)
    nat = dispatch.walk(*args)
    srt = dispatch.walk_sorted(*args)
    for a, b in zip(nat[:5], srt[:5]):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert int((nat[1] >= 0).sum()) > 100
