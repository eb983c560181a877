"""The public helpers of the PyTorch port's ``core/vec.py``,
``ops/intersect.py`` (``aabb``, ``aabb_minmax``), ``ops/shading.py``
(``random_in_cone``) and ``utils/procgen.py`` (``torus``) against the JAX
package's, on the same seeded inputs, with tests/test_vec.py's and
tests/test_intersect.py's cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buas_pathtracer_tpu.core import vec as jvec
from buas_pathtracer_tpu.ops import intersect as jint
from buas_pathtracer_tpu.ops import shading as jshade
from buas_pathtracer_tpu.utils import procgen as jproc
from buas_pathtracer_tpu_torch.core import vec as tvec
from buas_pathtracer_tpu_torch.ops import intersect as tint
from buas_pathtracer_tpu_torch.ops import shading as tshade
from buas_pathtracer_tpu_torch.utils import procgen as tproc

BIG = 3.0e38


def pair(a):
    """(3, ...) numpy -> the JAX Vec3 and the port's Vec3."""
    a = np.asarray(a, np.float32)
    return (jvec.Vec3(*(jnp.asarray(c) for c in a)),
            tvec.Vec3(*(torch.from_numpy(c.copy()) for c in a)))


def close(out, ref, rtol=1e-6, atol=1e-6):
    if isinstance(out, tvec.Vec3):
        out, ref = out.stack(0), ref.stack(0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.fixture
def two(nprng):
    return (pair(nprng.randn(3, 64)), pair(nprng.randn(3, 64)))


@pytest.mark.parametrize("fn", ["length", "min3", "max3"])
def test_reductions(two, fn):
    (ja, ta), _ = two
    close(getattr(tvec, fn)(ta), getattr(jvec, fn)(ja))


@pytest.mark.parametrize("fn", ["vmin", "vmax"])
def test_componentwise(two, fn):
    (ja, ta), (jb, tb) = two
    close(getattr(tvec, fn)(ta, tb), getattr(jvec, fn)(ja, jb))
    close(tvec.vabs(ta), jvec.vabs(ja))


def test_saturate_stack_astype_broadcast(nprng):
    x = (nprng.randn(50) * 2).astype(np.float32)
    close(tvec.saturate(torch.from_numpy(x)), jvec.saturate(jnp.asarray(x)))
    ja, ta = pair(nprng.randn(3, 7))
    assert tuple(ta.stack().shape) == (7, 3)
    close(ta.stack(), ja.stack())
    close(tvec.from_stacked(ta.stack()), jvec.from_stacked(ja.stack()))
    t64 = ta.astype(torch.float64)
    assert t64.x.dtype == torch.float64
    close(t64, ja.astype(jnp.float32))
    s = tvec.Vec3(torch.tensor(1.0), torch.tensor(2.0), torch.tensor(3.0))
    b = tvec.broadcast_to(s, (4, 5))
    assert tuple(b.shape) == (4, 5)
    close(b, jvec.broadcast_to(jvec.Vec3(1.0, 2.0, 3.0), (4, 5)))


def test_affine_transforms(nprng):
    """tests/test_vec.py:test_affine_compose_and_inverse and
    test_transform_normal_inverse_transpose on both packages."""
    t = (tvec.translate([1.0, 2.0, 3.0]) @ tvec.rotate_y(0.3)
         @ tvec.rotate_x(-0.7) @ tvec.scale([2.0, 3.0, 4.0]))
    jp, tp = pair(nprng.randn(3, 8))
    for fn, m in (("transform_point", t.fwd), ("transform_vector", t.fwd),
                  ("transform_normal", t.inv)):
        out = getattr(tvec, fn)(m, tp)
        close(out, getattr(jvec, fn)(m, jp), rtol=1e-6, atol=1e-6)
    p = tp.stack(0).numpy()
    close(tvec.transform_point(t.fwd, tp).stack(0),
          t.fwd[:, :3] @ p + t.fwd[:, 3:4], rtol=1e-5, atol=1e-5)
    s = tvec.scale([2.0, 1.0, 1.0])
    n = tvec.transform_normal(s.inv, tvec.Vec3(torch.tensor([1.0]),
                                               torch.tensor([0.0]),
                                               torch.tensor([0.0])))
    assert float(tvec.normalize(n).x[0]) == pytest.approx(1.0, abs=1e-6)


def test_aabb_surface_area(nprng):
    lo = nprng.randn(20, 3).astype(np.float32)
    hi = lo + np.abs(nprng.randn(20, 3)).astype(np.float32)
    hi[3] = lo[3] - 1.0  # an inverted box has zero area
    out = tvec.aabb_surface_area(lo, hi)
    assert out.tobytes() == jvec.aabb_surface_area(lo, hi).tobytes()
    assert out[3] == 0.0


def _v(x, y, z):
    return pair([[x], [y], [z]])


def test_aabb_boolean_cases():
    """tests/test_intersect.py:test_aabb_boolean on both packages."""
    jo, to = _v(0, 0, -5)
    (jd, td) = _v(0.0, 0.0, 1.0)
    jinv, tinv = jint.safe_inv_dir(jd), tint.safe_inv_dir(td)
    jc, tc = _v(0, 0, 0)
    jr, tr = _v(1, 1, 1)
    jl, tl = _v(-1, -1, -1)
    for far, want in ((BIG, True), (1.0, False)):
        out = tint.aabb(to, tinv, tc, tr, torch.tensor(far))
        ref = jint.aabb(jo, jinv, jc, jr, jnp.float32(far))
        assert bool(out[0]) == bool(ref[0]) == want
    out = tint.aabb_minmax(to, tinv, tl, tr, torch.tensor(BIG))
    assert bool(out[0]) and bool(jint.aabb_minmax(jo, jinv, jl, jr, BIG)[0])


def test_aabb_random_rays(nprng):
    """Random rays against random boxes: both forms equal the JAX ones."""
    n = 4096
    o, c = nprng.randn(3, n) * 3, nprng.randn(3, n)
    jo, to = pair(o)
    jc, tc = pair(c)
    jd, td = pair(c - o + nprng.randn(3, n))  # aimed near the box
    jd, td = jvec.normalize(jd), tvec.normalize(td)
    jr, tr = pair(np.abs(nprng.randn(3, n)) + 0.1)
    far = (nprng.rand(n) * 8).astype(np.float32)
    jinv, tinv = jint.safe_inv_dir(jd), tint.safe_inv_dir(td)
    out = tint.aabb(to, tinv, tc, tr, torch.from_numpy(far))
    ref = jint.aabb(jo, jinv, jc, jr, jnp.asarray(far))
    assert np.array_equal(out.numpy(), np.asarray(ref))
    out = tint.aabb_minmax(to, tinv, tc - tr, tc + tr, torch.from_numpy(far))
    ref = jint.aabb_minmax(jo, jinv, jc - jr, jc + jr, jnp.asarray(far))
    assert np.array_equal(out.numpy(), np.asarray(ref))
    assert 0.05 < out.float().mean() < 0.95


def test_random_in_cone(nprng):
    n = 512
    jn, tn = pair(nprng.randn(3, n))
    jn, tn = jvec.normalize(jn), tvec.normalize(tn)
    u, v = nprng.rand(2, n).astype(np.float32)
    for angle in (0.0, 0.3, 1.2):
        out = tshade.random_in_cone(tn, angle, torch.from_numpy(u),
                                    torch.from_numpy(v))
        ref = jshade.random_in_cone(jn, angle, jnp.asarray(u),
                                    jnp.asarray(v))
        close(out, ref, rtol=1e-5, atol=1e-5)
        cos = tvec.dot(out, tn)
        assert bool((cos >= np.cos(angle) - 1e-5).all())


@pytest.mark.parametrize("args", [(), (2.0, 0.5, 12, 6)])
def test_torus(args):
    out, ref = tproc.torus(*args), jproc.torus(*args)
    assert out.triangles.tobytes() == ref.triangles.tobytes()
    assert out.normals.tobytes() == ref.normals.tobytes()
    su, sv = (args[2], args[3]) if args else (48, 24)
    assert out.triangle_count == 2 * su * sv
