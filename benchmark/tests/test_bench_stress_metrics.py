"""The split walk's readers (``harness/split_walk.py`` and the metrics
``split_walk_device_ms``, ``split_walk_roofline``, ``leaf_rows_per_ray``) on
canned records: the program's counts of the traced frames' split walks,
found again among the harness's records of the stretch's calls; a program
that keeps no counts gives None; and the roofline share stays at or below
100 even when every walk touched the whole leaf table."""

import pytest
import torch

from benchmark.harness import cells
from benchmark.harness import program_trace as pt
from benchmark.harness import split_walk, stats
from buas_pathtracer_tpu_torch.ops import packet
from buas_pathtracer_tpu_torch.utils import trace

SPLIT = ("(anonymous namespace)::split_traverse_closest_counted("
         "walk::Split, walk::Args)")
SHADOW = ("(anonymous namespace)::split_traverse_occlusion_counted("
          "walk::Split, walk::Args)")
GLUE = "void at::native::vectorized_elementwise_kernel<4, MulFunctor<float>>"
RES_BYTES = 7823616
LEAF_ROWS = 67887
RAYS = 2073600


def reader(name):
    return cells._load_py(f"{cells.BENCH_DIR}/metrics/{name}.py",
                          "split_" + name.replace(".", "_"))


class Fake:
    def __init__(self, recs):
        self.recs = recs

    def records(self):
        return list(self.recs)


def record(seq, walks, spans_on=True):
    """A frame record with counted split walks (key, live, fetches,
    distinct leaf rows), each in its own ``WalkCounts``, as the tracer
    keeps them."""
    r = trace.FrameRecord(seq)
    r.spans_on = spans_on
    for key, live, fetches, rows in walks:
        reads = torch.zeros(LEAF_ROWS, dtype=torch.int64)
        reads[:rows] = 1
        reads[0] += fetches - rows
        counts = packet.WalkCounts(LEAF_ROWS, "cpu")
        counts.mark(live, reads)
        r.walks.append((key, RAYS, counts))
    r.launches = {"split_closest": len(walks) // 2,
                  "split_occlusion": len(walks) // 2}
    return r


# per traced frame: a closest and a shadow walk
FRAME_A = [("split_closest", 2000000, 900000, 60000),
           ("split_occlusion", 500000, 100000, 30000)]
FRAME_B = [("split_closest", 1900000, 800000, 59000),
           ("split_occlusion", 450000, 90000, 29000)]
PAD = [("split_closest", 1950000, 850000, 59500),
       ("split_occlusion", 470000, 95000, 29500)]


def calls(frames):
    return [dict(kernel="split_traverse", rays=RAYS, live=w[1],
                 table_bytes=RES_BYTES) for f in frames for w in f]


def canned(monkeypatch, device_us=(500.0, 300.0, 480.0, 290.0),
           frames=(FRAME_A, FRAME_B), recs=None):
    """Two traced frames and their padding frame among untraced ones; the
    stretch holds the two frames' split kernels (us each) and some glue."""
    if recs is None:
        recs = [record(1, [], False), record(2, FRAME_A),
                record(3, FRAME_B), record(4, PAD), record(5, [], False)]
    monkeypatch.setattr(pt, "tracer", lambda: Fake(recs))
    names = [SPLIT, SHADOW] * len(frames)
    device = [(n, "kernel", 10.0 * i, us)
              for i, (n, us) in enumerate(zip(names, device_us))]
    device.insert(1, (GLUE, "kernel", 5.0, 50.0))
    return {"frames": len(recs),
            "trace": dict(frames=len(frames), span=(0.0, 1e4), device=device,
                          host=[], walks=calls(frames))}


def test_readers_on_canned_records(monkeypatch):
    rec = canned(monkeypatch)
    spans = []

    def span_ms(r, name, own=False):
        spans.append((name, own))
        return 0.8

    monkeypatch.setattr(pt, "span_ms", span_ms)
    assert reader("split_walk_device_ms").read(rec) == 0.8
    assert spans == [("pt.walk", False)]
    walks = FRAME_A + FRAME_B + PAD
    assert reader("leaf_rows_per_ray").read(rec) == pytest.approx(
        sum(w[2] for w in walks) / sum(w[1] for w in walks))
    least = sum(stats.least_seconds(
        live * 52 + (RAYS - live) * 24 + RES_BYTES + 16 + rows * 512)
        for _, live, _, rows in FRAME_A + FRAME_B)
    assert reader("split_walk_roofline").read(rec) == pytest.approx(
        100.0 * least / ((500 + 300 + 480 + 290) * 1e-6))
    # the stretch's walks are the program's walks of the same two frames
    got = split_walk.stretch_walks(rec)
    assert [w["leaf_rows"] for w in got] == [60000, 30000, 59000, 29000]
    assert [w["leaf_fetches"] for w in got] == [900000, 100000, 800000,
                                                90000]


def test_device_ms_reads_none_beside_a_unified_walk(monkeypatch):
    """A traced frame that also launched the unified walk: ``pt.walk``
    would hold it too, so the split walks' time is not read."""
    rec = canned(monkeypatch)
    monkeypatch.setattr(pt, "span_ms", lambda r, name, own=False: 0.8)
    pt.tracer().recs[2].launches["closest"] = 1
    assert reader("split_walk_device_ms").read(rec) is None


def test_a_retried_stretch_is_found_by_its_walks(monkeypatch):
    """A stretch the profiler lost and recorded again: the program's
    counts of the lost try come first, and the stretch is found after."""
    recs = [record(1, PAD), record(2, FRAME_B), record(3, PAD),
            record(4, FRAME_A), record(5, FRAME_B), record(6, PAD)]
    rec = canned(monkeypatch, recs=recs)
    got = split_walk.stretch_walks(rec)
    assert [w["live"] for w in got] == [2000000, 500000, 1900000, 450000]
    assert [w["leaf_rows"] for w in got] == [60000, 30000, 59000, 29000]


def test_no_counts_read_none(monkeypatch):
    """A program that keeps no walk counts (its records have no
    ``walk_counts``, or its traced frames hold none) reads None in all
    three; a run without a traced stretch, in the roofline."""
    names = ("split_walk_device_ms", "split_walk_roofline",
             "leaf_rows_per_ray")

    class Bare:
        spans_on = True
        launches = {}

    rec = canned(monkeypatch, recs=[Bare(), Bare(), Bare()])
    assert all(reader(n).read(rec) is None for n in names)
    rec = canned(monkeypatch, recs=[record(1, []), record(2, []),
                                    record(3, [])])
    assert all(reader(n).read(rec) is None for n in names)
    monkeypatch.setattr(pt, "tracer", lambda: None)
    assert all(reader(n).read(rec) is None for n in names)
    rec = canned(monkeypatch)
    assert reader("split_walk_roofline").read(dict(rec, trace=None)) is None
    # the stretch's calls are not among the program's counted walks
    rec["trace"]["walks"][0]["live"] += 1
    assert reader("split_walk_roofline").read(rec) is None


def test_roofline_stays_at_or_below_100_with_the_whole_leaf_table(
        monkeypatch):
    """Every walk touched every leaf row: the least bytes hold the whole
    leaf table once a walk, not its fetches (twice the rows and more), so
    a walk as fast as those bytes allow reads 100, and no faster one is
    possible."""
    whole = [("split_closest", 2000000, 2 * LEAF_ROWS + 5, LEAF_ROWS),
             ("split_occlusion", 500000, 3 * LEAF_ROWS, LEAF_ROWS)]
    recs = [record(1, whole), record(2, whole), record(3, PAD)]
    least_us = [1e6 * stats.least_seconds(split_walk.split_walk_bytes(
        RAYS, live, RES_BYTES, LEAF_ROWS)) for _, live, _, _ in whole] * 2
    rec = canned(monkeypatch, device_us=least_us, frames=(whole, whole),
                 recs=recs)
    share = reader("split_walk_roofline").read(rec)
    assert share == pytest.approx(100.0) and share <= 100.0 + 1e-9
    slower = canned(monkeypatch, device_us=[1.2 * u for u in least_us],
                    frames=(whole, whole), recs=recs)
    assert reader("split_walk_roofline").read(slower) < 100.0
    assert split_walk.split_walk_bytes(RAYS, 2000000, RES_BYTES, LEAF_ROWS) \
        == stats.walk_bytes(RAYS, 2000000, RES_BYTES) + LEAF_ROWS * 512
