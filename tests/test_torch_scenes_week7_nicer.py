"""Week 7, Nicer (40,378 boxes of three material kinds) through the
PyTorch port and the JAX package: every packed field byte-equal, one pack
in each package."""

from test_torch_scenes import (  # noqa: F401  (no_assets: a fixture)
    assert_packs_equal, build_pair, no_assets)


def test_week7_nicer_pack_byte_equal(no_assets):  # noqa: F811
    j, t = build_pair("Week 7, Nicer")
    assert len(t.prims) == len(j.prims) == 40378
    assert len(t.materials) == len(j.materials)
    assert_packs_equal(j.pack(), t.pack(device="cpu", threaded=True))
