"""Environment maps in the PyTorch port against the JAX package: the HDR
reader and writer, the procedural sky, the CDF and alias tables and their
packing, the lookups and the alias sampler on the same seeded inputs, the
alias sampler against the CDF oracle, and a 32x32 render with env NEE.

Tolerances: parsed maps, tables and packed tables byte-equal (alias
indices value-equal: int64 here, exact floats there); the hash bit-exact;
``lookup_env``, ``env_pdf_table`` and ``sample_env_alias`` go through
``atan2`` / ``asin`` / ``cos`` / ``sin``, which XLA and torch round
differently by an ulp, so texel indices are equal except for directions
within a few ulps of a texel edge (counted, at most 0.2% of the rays), and
pdfs and directions agree to rtol 1e-5.  The render: the goldens'
rtol = atol = 2e-3, against the JAX package's ops run one by one
(``jax.disable_jit``): under jit, XLA on the CPU contracts the alias
sampler's hash input ``u * 7193.17 + v`` into one fused multiply-add, which
moves the intra-texel jitter of about a quarter of the env samples; the
port, like the JAX package's own ops, rounds the product first."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buas_pathtracer_tpu.core import vec as jvec
from buas_pathtracer_tpu.models import camera as jcm
from buas_pathtracer_tpu.models.scene import Scene as JScene
from buas_pathtracer_tpu.models.scene import SceneSettings as JSettings
from buas_pathtracer_tpu.ops import envmap as jenv
from buas_pathtracer_tpu.runtime.render import render as jrender
from buas_pathtracer_tpu.utils import assets as jassets
from buas_pathtracer_tpu.utils import image as jimage
from buas_pathtracer_tpu.utils.procgen import icosphere as jico
from buas_pathtracer_tpu_torch.core import vec as tvec
from buas_pathtracer_tpu_torch.models import camera as tcm
from buas_pathtracer_tpu_torch.models.scene import Scene as TScene
from buas_pathtracer_tpu_torch.models.scene import SceneSettings as TSettings
from buas_pathtracer_tpu_torch.ops import envmap as tenv
from buas_pathtracer_tpu_torch.runtime.render import render as trender
from buas_pathtracer_tpu_torch.utils import assets as tassets
from buas_pathtracer_tpu_torch.utils import image as timage
from buas_pathtracer_tpu_torch.utils.procgen import icosphere as tico
from test_torch_render import assert_image_close
from test_torch_scene import ENV_TABLES_PACKED as ENV_TABLES
from test_torch_scene import scene_spheres

HERO_SKY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "gallery", "hero_sky.hdr")
J = (JScene, jvec, jcm, jico)
T = (TScene, tvec, tcm, tico)


def _env(seed, h=16, w=32):
    r = np.random.RandomState(seed)
    env = (r.rand(h, w, 3) ** 3 * 4.0).astype(np.float32)
    env[h // 3, w // 5] = 300.0  # a sun texel
    return env


def _dirs(seed, n=8192):
    r = np.random.RandomState(seed)
    d = r.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:6] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1],
             [0, 0, -1]]
    return d.astype(np.float32)


def _jv(a):
    return jvec.Vec3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _tv(a):
    return tvec.Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                       for k in range(3)))


def test_parse_hero_sky_equal():
    with open(HERO_SKY, "rb") as f:
        data = f.read()
    a, b = jassets.parse_hdr(data), tassets.parse_hdr(data)
    assert b.shape == (256, 512, 3) and b.dtype == np.float32
    assert a.tobytes() == b.tobytes()
    assert tassets.load_environment_map(HERO_SKY).tobytes() == b.tobytes()
    assert tassets.load_environment_map(HERO_SKY + ".missing") is None
    assert tassets.parse_hdr(b"P6\n") is None


def test_write_hdr_round_trip(tmp_path):
    sky = timage.procedural_sky_hdr(24, 48)
    pj, pt = str(tmp_path / "j.hdr"), str(tmp_path / "t.hdr")
    jimage.write_hdr(pj, sky)
    timage.write_hdr(pt, sky)
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()
    back = tassets.load_environment_map(pt)
    assert back.tobytes() == jassets.load_environment_map(pj).tobytes()
    # RGBE keeps 8 mantissa bits of the largest component
    np.testing.assert_allclose(back, sky, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("args", [{}, dict(h=32, w=64, sun_dir=(0.1, 0.9, 0.3),
                                           sun_intensity=50.0)])
def test_procedural_sky_equal(args):
    assert (jimage.procedural_sky_hdr(**args).tobytes()
            == timage.procedural_sky_hdr(**args).tobytes())


@pytest.mark.parametrize("which", ["random", "sky", "black"])
def test_tables_byte_equal(which):
    env = {"random": _env(1), "sky": timage.procedural_sky_hdr(16, 32),
           "black": np.zeros((4, 8, 3), np.float32)}[which]
    jm, jc = jenv.build_env_cdf(env)
    tm, tc = tenv.build_env_cdf(env)
    assert jm.tobytes() == tm.tobytes() and jc.tobytes() == tc.tobytes()
    jp, ja, jn = jenv.build_env_alias(env)
    tp, ta, tn = tenv.build_env_alias(env)
    assert jp.tobytes() == tp.tobytes() and jn.tobytes() == tn.tobytes()
    assert ta.dtype == np.int64
    np.testing.assert_array_equal(ja.astype(np.int64), ta)


def test_packed_env_tables_byte_equal():
    env = _env(2)
    jsc, tsc = scene_spheres(*J), scene_spheres(*T)
    jsc.env_map, tsc.env_map = env, env
    jps, tps = jsc.pack(), tsc.pack(device="cpu")
    for name in ENV_TABLES:
        a = np.ascontiguousarray(np.asarray(getattr(jps, name)))
        b = getattr(tps, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    np.testing.assert_array_equal(np.asarray(jps.env_alias_idx).astype(
        np.int64), tps.env_alias_idx.numpy())
    # no map: the (1, 1, 3) placeholder and (1,)-sized tables
    jps, tps = scene_spheres(*J).pack(), scene_spheres(*T).pack(device="cpu")
    for name in ENV_TABLES:
        assert (np.ascontiguousarray(np.asarray(getattr(jps, name))).tobytes()
                == getattr(tps, name).numpy().tobytes()), name


def _edge_ulps(d, h, w):
    """Distance (in float32 ulps of the scaled coordinate) from each
    direction's texel coordinates to the nearest texel edge."""
    d64 = d.astype(np.float64)
    u = 0.5 + np.arctan2(d64[:, 2], d64[:, 0]) / (2 * np.pi)
    v = 0.5 + np.arcsin(np.clip(d64[:, 1], -1, 1)) / np.pi
    out = []
    for c, m in ((u * w, w), (v * h, h)):
        ulp = np.spacing(np.float32(max(m, 1)))
        out.append(np.abs(c - np.round(c)) / ulp)
    return np.minimum(*out)


def test_lookup_env_texels():
    """Texel of each direction, read through a map whose texels hold their
    own index."""
    h, w = 64, 128
    idx = np.arange(h * w, dtype=np.float32).reshape(h, w)
    env = np.stack([idx, idx * 0, idx * 0 + 1], axis=-1).astype(np.float32)
    d = _dirs(3)
    a = np.asarray(jenv.lookup_env(jnp.asarray(env), _jv(d)).x)
    b = tenv.lookup_env(torch.from_numpy(env), _tv(d)).x.numpy()
    bad = a != b
    assert bad.mean() <= 0.002, bad.mean()
    assert (_edge_ulps(d[bad], h, w) < 8).all()


def test_env_pdf_table_close():
    env = _env(4, 32, 64)
    _, _, pn = tenv.build_env_alias(env)
    d = _dirs(5)
    a = np.asarray(jenv.env_pdf_table(jnp.asarray(pn), 32, 64, _jv(d)))
    b = tenv.env_pdf_table(torch.from_numpy(pn), 32, 64, _tv(d)).numpy()
    far = ~np.isclose(a, b, rtol=1e-5, atol=0)
    assert far.mean() <= 0.002, far.mean()
    assert (_edge_ulps(d[far], 32, 64) < 8).all()


def test_hash01_bit_exact():
    x = np.random.RandomState(6).randn(4096).astype(np.float32)
    x[:3] = [0.0, -0.0, 1.0]
    a = np.asarray(jenv._hash01(jnp.asarray(x)))
    b = tenv._hash01(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_sample_env_alias_close():
    env = _env(7, 32, 64)
    p, a_, pn = tenv.build_env_alias(env)
    r = np.random.RandomState(8)
    u = r.rand(8192).astype(np.float32)
    v = r.rand(8192).astype(np.float32)
    jd, jp, jr = jenv.sample_env_alias(
        jnp.asarray(p), jnp.asarray(a_.astype(np.float32)), jnp.asarray(pn),
        jnp.asarray(env), jnp.asarray(u), jnp.asarray(v))
    td, tp, tr = tenv.sample_env_alias(
        torch.from_numpy(p), torch.from_numpy(a_), torch.from_numpy(pn),
        torch.from_numpy(env), torch.from_numpy(u), torch.from_numpy(v))
    for k in range(3):  # the texel is chosen exactly
        np.testing.assert_array_equal(np.asarray(jr[k]), tr[k].numpy())
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)


def test_cdf_oracle_close():
    """The CDF sampler and its pdf, kept as the alias sampler's oracle."""
    env = _env(9, 16, 32)
    m, c = tenv.build_env_cdf(env)
    r = np.random.RandomState(10)
    u = r.rand(4096).astype(np.float32)
    v = r.rand(4096).astype(np.float32)
    jd, jp, jr = jenv.sample_env_direction(jnp.asarray(m), jnp.asarray(c),
                                           jnp.asarray(env), jnp.asarray(u),
                                           jnp.asarray(v))
    td, tp, tr = tenv.sample_env_direction(
        torch.from_numpy(m), torch.from_numpy(c), torch.from_numpy(env),
        torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(np.asarray(jr.x), tr.x.numpy())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
    np.testing.assert_allclose(td.y.numpy(), np.asarray(jd.y), rtol=1e-5,
                               atol=1e-6)
    d = _dirs(11)
    a = np.asarray(jenv.env_pdf(jnp.asarray(m), jnp.asarray(c),
                                jnp.asarray(env), _jv(d)))
    b = tenv.env_pdf(torch.from_numpy(m), torch.from_numpy(c),
                     torch.from_numpy(env), _tv(d)).numpy()
    assert (~np.isclose(a, b, rtol=1e-5, atol=0)).mean() <= 0.002


def _alias(env):
    p, a, pn = tenv.build_env_alias(env)
    return torch.from_numpy(p), torch.from_numpy(a), torch.from_numpy(pn)


def test_alias_matches_cdf_texel_distribution():
    """The alias sampler picks texels with the CDF sampler's probabilities
    (tests/test_filters_post_envmap.py's check, on the port)."""
    rng = np.random.default_rng(3)
    env = rng.uniform(0.0, 3.0, (8, 16, 3)).astype(np.float32)
    env[2, 5] = 40.0
    m, c = tenv.build_env_cdf(env)
    n = 200000
    u = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
    v = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
    et = torch.from_numpy(env)
    _, _, rad_c = tenv.sample_env_direction(torch.from_numpy(m),
                                            torch.from_numpy(c), et, u, v)
    _, _, rad_a = tenv.sample_env_alias(*_alias(env), et, u, v)
    hc, _ = np.histogram(rad_c.x.numpy(), bins=32, range=(0, 41))
    ha, _ = np.histogram(rad_a.x.numpy(), bins=32, range=(0, 41))
    assert 0.5 * np.abs(hc / n - ha / n).sum() < 0.02


@pytest.mark.parametrize("sampler", ["alias", "cdf"])
def test_pdf_integrates_to_one(sampler):
    """E[1/pdf] over the sampler's own draws is the sphere's 4 pi."""
    rng = np.random.default_rng(7)
    env = rng.uniform(0.1, 2.0, (16, 32, 3)).astype(np.float32)
    n = 65536
    u = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
    v = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
    et = torch.from_numpy(env)
    if sampler == "alias":
        d, pdf, _ = tenv.sample_env_alias(*_alias(env), et, u, v)
    else:
        m, c = tenv.build_env_cdf(env)
        d, pdf, _ = tenv.sample_env_direction(torch.from_numpy(m),
                                              torch.from_numpy(c), et, u, v)
    est = float((1.0 / pdf).mean())
    assert abs(est - 4 * np.pi) / (4 * np.pi) < 0.05, est
    lens = torch.sqrt(d.x ** 2 + d.y ** 2 + d.z ** 2).numpy()
    np.testing.assert_allclose(lens, 1.0, atol=1e-4)


def test_alias_pdf_table_matches_sample_pdf():
    """Both sides of the MIS weight use one distribution: env_pdf_table of
    a sampled direction is the pdf the sample came with, away from texel
    edges."""
    rng = np.random.default_rng(11)
    env = rng.uniform(0.1, 2.0, (8, 16, 3)).astype(np.float32)
    u = torch.from_numpy(rng.uniform(size=8192).astype(np.float32))
    v = torch.from_numpy(rng.uniform(size=8192).astype(np.float32))
    p, a, pn = _alias(env)
    d, pdf, _ = tenv.sample_env_alias(p, a, pn, torch.from_numpy(env), u, v)
    pdf2 = tenv.env_pdf_table(pn, 8, 16, d)
    assert np.isclose(pdf2.numpy(), pdf.numpy(), rtol=2e-3).mean() > 0.995


def _env_scene(pkg):
    sc = scene_spheres(*pkg)
    sc.env_map = _env(12, 16, 32)
    sc.settings = (JSettings if pkg is J else TSettings)(
        samples_per_pixel=1, max_bounce_count=4)
    return sc


def test_hash_input_rounding():
    """The jitter's hash reads the bits of u * 7193.17 + v rounded twice
    (the product, then the sum): the port's value equals the JAX
    package's un-jitted ops bit for bit."""
    r = np.random.RandomState(13)
    u = r.rand(4096).astype(np.float32)
    v = r.rand(4096).astype(np.float32)
    with jax.disable_jit():
        a = np.asarray(jenv._hash01(jnp.asarray(u) * 7193.17
                                    + jnp.asarray(v)))
    b = tenv._hash01(torch.from_numpy(u) * 7193.17
                     + torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_env_nee_render_matches_jax():
    """A 32x32 Advanced frame with env NEE (the light and env shadow
    queries in one wave) against the JAX package, op by op (~15 s)."""
    with jax.disable_jit():
        ref, _, jstats = jrender(_env_scene(J), 32, 32, frames=1)
    img, _, tstats = trender(_env_scene(T), 32, 32, frames=1, device="cpu")
    assert_image_close(img, np.asarray(ref))
    assert float(tstats[0]) == float(np.asarray(jstats)[0])
