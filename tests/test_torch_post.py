"""Post-processing of the PyTorch port against the JAX package's
``_post_process_jnp`` (runtime/post.py:73), on the inputs of
tests/test_pallas_post.py: NaN (cyan), negative-weight (magenta) and
zero-weight pixels, and its three settings.

At most 1 LSB may differ, on at most 0.1% of the values: torch's and XLA's
CPU ``exp`` and ``pow`` are different implementations that round some
results differently in the last bit, and a value sitting on an integer
boundary before the u8 truncation then lands one step apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buas_pathtracer_tpu.models.scene import PostProcessSettings as JPost
from buas_pathtracer_tpu.runtime import post as jpost
from buas_pathtracer_tpu_torch.models.scene import PostProcessSettings as TPost
from buas_pathtracer_tpu_torch.ops import post_kernel
from buas_pathtracer_tpu_torch.runtime import post as tpost

SETTINGS = [
    dict(),
    dict(exposure=0.7, contrast=0.4, midpoint=0.4),
    dict(tonemapping=False, srgb_transform=False, dither=False),
]


def _accum(h=40, w=200):
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 4, (h, w, 4)).astype(np.float32)
    a[..., 3] = rng.uniform(0.5, 8, (h, w))
    a[3, 7] = np.nan          # cyan path
    a[9, 11, 3] = -1.0        # magenta path
    a[0, 0, 3] = 0.0          # zero-weight path
    return a


def test_dither_tile_equal():
    np.testing.assert_array_equal(tpost._dither_tile_np(64),
                                  jpost._dither_tile(64))


@pytest.mark.parametrize("kw", SETTINGS, ids=["default", "contrast",
                                              "linear"])
def test_post_plain_matches_jax(kw):
    a = _accum()
    ref = np.asarray(jpost._post_process_jnp(jnp.asarray(a), JPost(**kw), 0))
    out = tpost.post_process(torch.from_numpy(a), TPost(**kw),
                             device="cpu").numpy()
    assert out.dtype == np.uint8 and out.shape == ref.shape
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    np.testing.assert_array_equal(out[3, 7, :3], [0, 255, 255])
    assert out[9, 11, 0] == 255 and out[9, 11, 1] == 0
    np.testing.assert_array_equal(out[0, 0], [0, 0, 0, 255])
    assert (out[..., 3] == 255).all()


def test_post_wrapper_checks_inputs():
    tile = tpost.dither_tile("cpu")
    with pytest.raises(ValueError, match="accum"):
        post_kernel.post_rgba8(torch.zeros((4, 4, 3)), tile, TPost())
    with pytest.raises(ValueError, match="tile"):
        post_kernel.post_rgba8(torch.zeros((4, 4, 4)), tile[:8], TPost())


@pytest.mark.gpu
@pytest.mark.parametrize("kw", SETTINGS, ids=["default", "contrast",
                                              "linear"])
def test_post_kernel_matches_plain_on_card(kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = torch.from_numpy(_accum(1080, 1920)).cuda()
    tile = tpost.dither_tile(a.device)
    before = post_kernel.LAUNCHES["post_rgba8"]
    k = post_kernel.post_rgba8(a, tile, TPost(**kw))
    p = post_kernel.post_rgba8_plain(a, tile, TPost(**kw))
    assert post_kernel.LAUNCHES["post_rgba8"] == before + 1
    diff = (k.to(torch.int16) - p.to(torch.int16)).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 0).float().mean()) >= 0.9999


@pytest.mark.gpu
@pytest.mark.parametrize("kw", SETTINGS, ids=["default", "contrast",
                                              "linear"])
@pytest.mark.parametrize("h,w", [(7, 33), (3, 1921)], ids=["33x7", "1921x3"])
def test_post_kernel_odd_widths_on_card(kw, h, w):
    """Widths that are no multiple of the kernel's 4-pixel groups: groups
    straddle rows and the last one runs past H x W.  NaN, negative-weight
    and zero-weight pixels sit at group and row boundaries.  Each pixel of
    the kernel's output depends only on its accumulation value and its
    (y % 64, x % 64), so it must equal, bit for bit, the kernel's output at
    the same (y, x) of a 1080x1921 image holding the same values there; and
    it stays within 1 LSB of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    big = _accum(1080, 1921)
    flat = big[:h, :w].reshape(-1, 4).copy()
    n = h * w
    for i, kind in ((0, "zero"), (3, "nan"), (4, "neg"), (w - 1, "nan"),
                    (w, "zero"), (w + 3, "neg"), (n - 4, "zero"),
                    (n - 2, "neg"), (n - 1, "nan")):
        if kind == "nan":
            flat[i, 1] = np.nan
        else:
            flat[i, 3] = 0.0 if kind == "zero" else -0.5
    big[:h, :w] = flat.reshape(h, w, 4)
    small = torch.from_numpy(np.ascontiguousarray(big[:h, :w])).cuda()
    tile = tpost.dither_tile(small.device)
    before = post_kernel.LAUNCHES["post_rgba8"]
    k = post_kernel.post_rgba8(small, tile, TPost(**kw))
    k_big = post_kernel.post_rgba8(torch.from_numpy(big).cuda(), tile,
                                   TPost(**kw))
    p = post_kernel.post_rgba8_plain(small, tile, TPost(**kw))
    assert post_kernel.LAUNCHES["post_rgba8"] == before + 2
    assert torch.equal(k, k_big[:h, :w])
    diff = (k.to(torch.int16) - p.to(torch.int16)).abs()
    assert int(diff.max()) <= 1
    out = k.cpu().numpy().reshape(-1, 4)
    np.testing.assert_array_equal(out[[3, w - 1, n - 1], :3],
                                  [[0, 255, 255]] * 3)
    np.testing.assert_array_equal(out[[0, w, n - 4]], [[0, 0, 0, 255]] * 3)
    assert (out[[4, w + 3, n - 2], 1] == 0).all()
    assert (out[[4, w + 3, n - 2], 0] == 127).all()
    assert (out[:, 3] == 255).all()


@pytest.mark.gpu
def test_post_kernel_needs_float4_alignment():
    """A contiguous accumulation that starts off a 16-byte boundary cannot
    be read as float4 pixels: the wrapper raises instead of launching."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    accum = torch.zeros(4 * 4 * 4 + 1, device="cuda")[1:].view(4, 4, 4)
    tile = tpost.dither_tile(accum.device)
    assert accum.data_ptr() % 16 and accum.is_contiguous()
    before = post_kernel.LAUNCHES["post_rgba8"]
    with pytest.raises(ValueError, match="aligned"):
        post_kernel.post_rgba8(accum, tile, TPost())
    assert post_kernel.LAUNCHES["post_rgba8"] == before


# ---------------------------------------------------------------------------
# chip_smoke.py's SASS count of the kernel (its operations and issue
# bounds), on a canned cuobjdump listing
# ---------------------------------------------------------------------------

POST_SASS = """\
\t\tFunction : _ZN12_GLOBAL__N_117post_rgba8_kernelEPK6float4PKfP6uchar4ii10PostParams
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/                   ULDC.64 UR6, c[0x0][0x248] ;
        /*0030*/                   ISETP.NE.AND P0, PT, RZ, UR6, PT ;
        /*0040*/                   ISETP.NE.AND P1, PT, RZ, UR7, PT ;
        /*0050*/              @!P0 BRA 0x70 ;
        /*0060*/                   FMUL R4, R4, c[0x0][0x230] ;
        /*0070*/              @!P1 BRA 0x90 ;
        /*0080*/                   FFMA R4, R4, R5, 1 ;
        /*0090*/                   ULDC UR8, c[0x0][0x250] ;
        /*00a0*/                   ISETP.NE.AND P2, PT, RZ, UR8, PT ;
        /*00b0*/              @!P2 BRA 0xd0 ;
        /*00c0*/                   FADD R4, R4, R6 ;
        /*00d0*/                   ISETP.NE.AND P0, PT, RZ, c[0x0][0x254], PT ;
        /*00e0*/              @!P0 BRA 0x100 ;
        /*00f0*/                   FMNMX R4, RZ, R4, !PT ;
        /*0100*/                   ULDC UR6, c[0x0][0x258] ;
        /*0110*/                   ISETP.NE.AND P1, PT, RZ, UR6, PT ;
        /*0120*/              @!P1 BRA 0x140 ;
        /*0130*/                   FMUL R4, R4, 255 ;
        /*0140*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0150*/                   EXIT ;
        /*0160*/                   BRA 0x160;
"""
POST_OPS = {"exposure_on": 1, "tonemapping": 2, "srgb": 1, "contrast_on": 1,
            "dither": 1}


@pytest.mark.parametrize("on", [(), ("tonemapping", "srgb", "dither"),
                                tuple(POST_OPS)], ids=["none", "default",
                                                       "all"])
def test_k3_sass_count_follows_the_flags(on):
    """Each flag's block is on the path exactly when the flag is set, read
    through a 64-bit load, a 32-bit load or straight from the bank."""
    import chip_smoke as cs
    ins = cs.sass_functions(POST_SASS)["post_rgba8_kernel"]
    flags = {k: int(k in on) for k in cs.POST_FLAGS}
    count = cs.k3_sass_count(ins, flags)
    assert count == {"per_pixel": 17 + len(on),
                     "fp32_ops_per_pixel": sum(POST_OPS[k] for k in on)}


@pytest.mark.parametrize("edit", ["stale_offset", "unevaluated_guard"])
def test_k3_sass_count_fails_loudly(edit):
    """A flag not read at its offset, or a branch on a flag the walk cannot
    evaluate, stops the count instead of counting the wrong blocks."""
    import chip_smoke as cs
    text = POST_SASS
    if edit == "stale_offset":
        text = text.replace("c[0x0][0x258]", "c[0x0][0x25c]")
    else:
        text = text.replace("ISETP.NE.AND P1, PT, RZ, UR6, PT",
                            "LOP3.LUT P1, RZ, UR6, 0x1, RZ, 0xc0, !PT")
    ins = cs.sass_functions(text)["post_rgba8_kernel"]
    with pytest.raises(AssertionError, match="POST_FLAG_OFFSETS"):
        cs.k3_sass_count(ins, {k: 1 for k in cs.POST_FLAGS})


def test_k3_flag_offsets_match_csrc():
    """chip_smoke.py's POST_FLAG_OFFSETS follow csrc/post.cu: the kernel's
    five parameters before PostParams (three pointers, two ints), the
    struct's six floats and then its flags in POST_FLAGS' order, and the
    layout the source asserts."""
    import os
    import re

    import chip_smoke as cs
    src = open(os.path.join(os.path.dirname(post_kernel.__file__), "..",
                            "csrc", "post.cu")).read()
    body = re.search(r"struct PostParams \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = [(ty, name) for ty, names in
              re.findall(r"(float|int)\s+([^;]+);", body)
              for name in (x.strip() for x in names.split(","))]
    assert [ty for ty, _ in fields] == ["float"] * 6 + ["int"] * 5
    assert tuple(name for _, name in fields[6:]) == cs.POST_FLAGS
    sig = re.search(r"post_rgba8_kernel\((.*?)\)\s*\{", src, re.S).group(1)
    kinds = ["ptr" if "*" in a else a.split()[0] for a in sig.split(",")]
    assert kinds == ["ptr", "ptr", "ptr", "int", "int", "PostParams"]
    assert "sizeof(PostParams) == 44" in src
    assert "offsetof(PostParams, exposure_on) == 24" in src
    assert "offsetof(PostParams, dither) == 40" in src
    assert cs.POST_PARAMS_AT == cs.SM90_PARAM_BASE + 32
    assert [cs.POST_FLAG_OFFSETS[k] - cs.POST_PARAMS_AT
            for k in cs.POST_FLAGS] == [24, 28, 32, 36, 40]
