"""Week 7 (40,378 boxes on a plane) through the PyTorch port and the JAX
package: every packed field byte-equal, one pack in each package.  Week 7,
Nicer is in ``test_torch_scenes_week7_nicer.py``; each pack takes seconds,
so the two files go to different test workers."""

from test_torch_scenes import (  # noqa: F401  (no_assets: a fixture)
    assert_packs_equal, build_pair, no_assets)


def test_week7_pack_byte_equal(no_assets):  # noqa: F811
    j, t = build_pair("Week 7")
    assert len(t.prims) == len(j.prims) == 40378
    assert_packs_equal(j.pack(), t.pack(device="cpu", threaded=True))
