"""Row-sharded rendering of the PyTorch port (``parallel/mesh.py``) against
its single-device frame and the JAX package.

One 4-rank gloo world on the CPU runs every case: the halo exchange for r
in {0, 2, 12} and hl in {8, 16}, bit for bit against the JAX
``_exchange_halo`` under ``shard_map`` on 4 of the 8 CPU devices, and the
cases of tests/test_scenes_sharded.py:109-122 (Cornell Box 24 wide, 8 rows
a rank, 3 bounces, two frames: Mitchell, Lanczos 12 with its halo over
three ranks, an env map with env NEE, split tables with an icosphere), each
gathered image bit-equal to the port's ``render_frame``.  The Mitchell case
also holds to the JAX frame within the goldens' tolerance.  The CLI's
``--devices 2`` PNG equals its ``--devices 1`` PNG."""

import os
import subprocess
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from buas_pathtracer_tpu.models import scenes as jscenes
from buas_pathtracer_tpu.parallel import mesh as jmesh
from buas_pathtracer_tpu.runtime import film as jfilm
from buas_pathtracer_tpu.runtime.render import render as jrender
from buas_pathtracer_tpu_torch.core import vec as tvec
from buas_pathtracer_tpu_torch.models import scenes as tscenes
from buas_pathtracer_tpu_torch.ops import filters as tfilters
from buas_pathtracer_tpu_torch.parallel import mesh as tmesh
from buas_pathtracer_tpu_torch.runtime import film as tfilm
from buas_pathtracer_tpu_torch.runtime.render import render_frame
from buas_pathtracer_tpu_torch.utils import trace
from buas_pathtracer_tpu_torch.utils.procgen import icosphere
from buas_pathtracer_tpu.ops import filters as jfilters
from test_torch_render import assert_image_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
W, H = 24, 8 * RANKS  # 8 rows a rank: a Lanczos-12 halo spans 3 ranks
FRAMES = 2
HALOS = [(r, hl) for r in (0, 2, 12) for hl in (8, 16)]
CASES = {  # name: (filter, env map, split tables with an icosphere)
    "mitchell": ("Mitchell Netravali", False, False),
    "lanczos12": ("Lanczos 12", False, False),
    "env_nee": ("Mitchell Netravali", True, False),
    "split": ("Mitchell Netravali", False, True),
}


def build(pkg, name, w=W, h=H):
    """The case's Cornell Box in ``pkg`` (the JAX or the port's scenes)."""
    filt, env, split = CASES[name]
    sc = pkg.load_scene("Cornell Box", w, h)
    sc.settings = replace(sc.settings, samples_per_pixel=1,
                          max_bounce_count=3)
    sc.filter_name = filt
    if env:  # a bright hot spot: env NEE over replicated tables
        e = np.full((16, 32, 3), 0.05, np.float32)
        e[3, 7] = (40.0, 30.0, 10.0)
        sc.env_map = e
    if split:
        m = sc.add_diffuse_material((0.4, 0.5, 0.7), 1.2)
        sc.add_mesh(m, icosphere(subdivisions=2),
                    tvec.translate([0.0, 1.0, 2.0]) * tvec.scale(0.6))
    return sc


def halo_input(r, hl):
    rng = np.random.default_rng(100 * r + hl)
    return rng.standard_normal((RANKS * hl, 5, 6)).astype(np.float32)


def _render_counted(m, *args, **kwargs):
    """``render_frames`` on one rank with the walks' launches it made."""
    before = trace.launch_totals()
    res = tmesh.render_frames(m, *args, **kwargs)
    res["launches"] = {k: n - before[k]
                       for k, n in trace.launch_totals().items()}
    return res


def _rank_cases(m, scenes):
    """Every case on one rank of the world (started by ``spawn_ranks``)."""
    halos = {}
    for r, hl in HALOS:
        blk = torch.from_numpy(
            halo_input(r, hl)[m.rank * hl:(m.rank + 1) * hl].copy())
        halos[(r, hl)] = tmesh._exchange_halo(blk, r, m).numpy()
    renders = {name: _render_counted(m, sc, W, H, FRAMES,
                                     split=CASES[name][2] or None)
               for name, sc in scenes.items()}
    return halos, renders


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank gloo world's results, one entry per rank.  The scenes are
    built here without their asset files and sent to the ranks."""
    saved = tscenes.DATA_DIR
    tscenes.DATA_DIR = str(tmp_path_factory.mktemp("none"))
    try:
        scenes = {name: build(tscenes, name) for name in CASES}
    finally:
        tscenes.DATA_DIR = saved
    return tmesh.spawn_ranks(_rank_cases, ["cpu"] * RANKS, "gloo",
                             (scenes,))


@pytest.fixture
def no_assets(tmp_path, monkeypatch):
    empty = str(tmp_path / "none")
    monkeypatch.setattr(jscenes, "DATA_DIR", empty)
    monkeypatch.setattr(tscenes, "DATA_DIR", empty)


@pytest.mark.parametrize("r,hl", HALOS)
def test_exchange_halo_matches_jax(world, r, hl):
    """Every rank's (hl + 2r) block equals the JAX ppermute chain's."""
    glob = halo_input(r, hl)
    jm = Mesh(np.array(jax.devices()[:RANKS]), ("rows",))
    f = jax.jit(jax.shard_map(
        lambda b: jmesh._exchange_halo(b, r, RANKS), mesh=jm,
        in_specs=P("rows"), out_specs=P("rows"), check_vma=False))
    ref = np.asarray(f(jnp.asarray(glob))).reshape(RANKS, hl + 2 * r, 5, 6)
    for rank in range(RANKS):
        out = world[rank][0][(r, hl)]
        assert out.shape == ref[rank].shape
        assert out.tobytes() == ref[rank].tobytes(), f"rank {rank}"


def _single(name):
    sc = build(tscenes, name)
    ps = sc.pack(device="cpu", split=CASES[name][2] or None)
    acc = tfilm.new_accumulation_buffer(H, W, "cpu")
    for f_i in range(FRAMES):
        acc, st = render_frame(ps, sc.settings, sc.camera, acc, f_i, h=H,
                               w=W, n_lights=sc.n_lights,
                               filter_name=sc.filter_name,
                               has_medium=sc.has_medium, device="cpu")
    return acc, st


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_matches_single_device(world, name, no_assets):
    """The gathered buffer is the single-device frame's, bit for bit; the
    ray counts are exact and the summed visits and tests agree to 1e-6."""
    acc, st = _single(name)
    got = world[0][1][name]
    assert torch.equal(got["accum"], acc)
    assert float(got["stats"][0]) == float(st[0])
    np.testing.assert_allclose(got["stats"].numpy(), st.numpy(), rtol=1e-6)
    for rank in range(RANKS):
        part = world[rank][1][name]
        assert part["rows"] == (rank * H // RANKS, (rank + 1) * H // RANKS)
        walks = part["launches"]
        assert walks["closest"] + walks["split_closest"] == 0  # plain on CPU
        assert part["exchanges"] == FRAMES
        assert part["split_tables"] == CASES[name][2]


def test_sharded_mitchell_matches_jax(world, no_assets):
    """The sharded Mitchell frame against the JAX single-device frame,
    within the goldens' tolerance."""
    j = jscenes.load_scene("Cornell Box", W, H)
    j.settings = replace(j.settings, samples_per_pixel=1, max_bounce_count=3)
    j.filter_name = "Mitchell Netravali"
    ref, _, _ = jrender(j, W, H, frames=FRAMES, filter_name=j.filter_name)
    got = world[0][1]["mitchell"]
    assert_image_close(tfilm.resolve(got["accum"]).numpy(), np.asarray(ref))


@pytest.mark.parametrize("filt", ["Mitchell Netravali", "Lanczos 12", "Box"])
def test_splat_pass_prepadded_matches_jax(filt):
    rng = np.random.default_rng(11)
    tf, jf = tfilters.find_filter(filt), jfilters.find_filter(filt)
    h, w, r = 6, 20, int(tf.radius)
    s_ext = rng.uniform(0, 3, (h + 2 * r, w, 4)).astype(np.float32)
    jx, jy = rng.uniform(-0.5, 0.5, (2, h + 2 * r, w)).astype(np.float32)
    ref = jfilm.splat_pass_prepadded(jnp.asarray(s_ext), jnp.asarray(jx),
                                     jnp.asarray(jy), jf)
    out = tfilm.splat_pass_prepadded(torch.from_numpy(s_ext),
                                     torch.from_numpy(jx),
                                     torch.from_numpy(jy), tf)
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_splat_pass_is_zero_padded_prepadded():
    """``splat_pass`` is the zero-padded call of the prepadded splat."""
    rng = np.random.default_rng(12)
    f = tfilters.find_filter("Lanczos 3")
    col = torch.from_numpy(rng.uniform(0, 2, (3, 9, 13)).astype(np.float32))
    jx, jy = torch.from_numpy(
        rng.uniform(-0.5, 0.5, (2, 9, 13)).astype(np.float32))
    sample = torch.stack([col[0], col[1], col[2], torch.ones_like(col[0])],
                         dim=-1)
    pad = torch.nn.functional.pad
    ref = tfilm.splat_pass_prepadded(pad(sample, (0, 0, 0, 0, 3, 3)),
                                     pad(jx, (0, 0, 3, 3)),
                                     pad(jy, (0, 0, 3, 3)), f)
    out = tfilm.splat_pass(tvec.Vec3(col[0], col[1], col[2]), jx, jy, f)
    assert torch.equal(out, ref)


def test_cli_devices_2_equals_devices_1(tmp_path):
    """``--device cpu --devices 2`` (two gloo ranks) writes the PNG that
    ``--devices 1`` writes; ``--devices`` above the card count is refused."""
    env = dict(os.environ, BUAS_TPU_DATA=str(tmp_path / "none"))
    outs = []
    for n in (1, 2):
        out = str(tmp_path / f"d{n}.png")
        res = subprocess.run(
            [sys.executable, "-m", "buas_pathtracer_tpu_torch.cli",
             "--device", "cpu", "--devices", str(n), "--scene",
             "Cornell Box", "--size", "24x16", "--spp", "2", "--bounces",
             "2", "--out", out], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
        assert "Took 24x16 2spp image in" in res.stdout
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]
    res = subprocess.run(
        [sys.executable, "-m", "buas_pathtracer_tpu_torch.cli", "--devices",
         str(max(2, torch.cuda.device_count() + 1)), "--size", "24x16"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode == 2 and "one rank a card" in res.stderr


def test_make_mesh_needs_a_group():
    """No default group, no silent single-rank fallback."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="not initialised"):
        tmesh.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="NCCL takes one card a rank"):
        tmesh.spawn_ranks(tmesh.render_frames, ["cuda:0", "cuda:0"], "nccl")


@pytest.mark.gpu
def test_ranks_sharing_the_card_over_gloo():
    """Two gloo ranks on cuda:0 (the host copies around each collective):
    the split-table case's gathered buffer equals the single-device frame
    on the card, and each rank launched both split walks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sc = build(tscenes, "split")
    res = tmesh.spawn_ranks(_render_counted, ["cuda:0"] * 2, "gloo",
                            (sc, W, H, FRAMES, None, True))
    ps = sc.pack(device="cuda", split=True)
    acc = tfilm.new_accumulation_buffer(H, W, "cuda")
    for f_i in range(FRAMES):
        acc, _ = render_frame(ps, sc.settings, sc.camera, acc, f_i, h=H,
                              w=W, n_lights=sc.n_lights,
                              filter_name=sc.filter_name,
                              has_medium=sc.has_medium, device="cuda")
    assert torch.equal(res[0]["accum"], acc.cpu())
    for part in res:
        assert part["launches"]["split_closest"] > 0
        assert part["launches"]["split_occlusion"] > 0
