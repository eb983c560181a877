"""The ``stress`` configuration: handed to the program through its public
Scene API, it packs byte-equal to the program's own ``build_stress_scene``,
with the same camera, settings, post settings and filter; the pack takes
the split route by the residence limit alone (the unified rows exceed
``RESIDENT_TABLE_LIMIT_BYTES``, so the resident and leaf tables are built);
and the configuration states its source and that nothing is cut."""

import numpy as np

from benchmark.configs import stress
from benchmark.harness import port_scene
from buas_pathtracer_tpu_torch.models import scenes
from buas_pathtracer_tpu_torch.models.scene import _split_tables
from buas_pathtracer_tpu_torch.ops import packet
from test_bench_configs import H, W, _same


def test_stress_packs_byte_equal_and_takes_the_split_route():
    ours = port_scene.build(stress.describe(W, H))
    theirs = scenes.build_stress_scene(W, H)
    _same(ours, theirs)
    rows = ours._pack_arrays()["wide_rows"]
    assert rows.shape[0] * 64 * 4 == rows.nbytes
    assert rows.nbytes > packet.RESIDENT_TABLE_LIMIT_BYTES
    split = _split_tables(rows, None)
    assert set(split) == {"v4_res", "v4_leaf"}
    assert split["v4_res"].shape[1] == 64 and split["v4_leaf"].shape[1] == 128
    # two instances of one 327,680-triangle mesh
    assert sum(np.asarray(m.triangles).shape[0] for m in ours.meshes) in (
        327680, 655360)
    assert [p["type"] for p in stress.describe(W, H).prims] == [
        "mesh", "mesh", "box", "sphere"]


def test_stress_states_its_source_and_cuts():
    assert stress.SOURCE and len(stress.SOURCE) <= 200
    assert "bench.py:98-120" in stress.SOURCE
    assert stress.REDUCED == [] and stress.ASSUMED == {}
